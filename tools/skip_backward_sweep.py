#!/usr/bin/env python3
"""The skip_gather backward kernel of the PyTorch port at other walks and
chunk lengths along z than the wrapper's, on one CUDA card.

`corenet_tpu_torch/ops/skip_gather.py::backward_walk` gives each thread
of the backward kernel a quarter of a fine depth column; in the packed
decoder's voxel order a thread walks both z phases of its column. This
script times the kernel at the h7 training step's four skips (batch 4,
the serving camera's indices, dout in the step's layout as chip_smoke.py
makes it), calling the kernel's C entry point directly:

* fine voxel order, float32: every chunk length from 1 to the whole
  column, and every voxel its own column (the grid (1, 1, N));
* packed voxel order (8 phase grids of half the resolution, phase-outer),
  float32 and bfloat16: the walk of both z phases at every chunk length
  of the fine column, and the walk of one phase at a time (the walk
  before it) at every chunk length of the half column;
* at skip 5, a build of the kernel without its atomics
  (SKIP_GATHER_BWD_NO_ATOMICS: wrong sums, timed only), at the wrapper's
  walk in both orders and both types: what the walk costs without them.

Each result of the real build is held against the float64 scatter-add
within 1e-5 · Σ|dout| per cell (plus one bf16 ulp in bfloat16) before it
is timed.

Usage, from the root of the repository, on a machine with an NVIDIA
Hopper card and the CUDA toolkit:

  python3 tools/skip_backward_sweep.py

Prints the card's name and power limit, one line per skip and order, and,
last, one JSON object of the times (ms of device time per launch, CUDA
events around CUDA-graph replays).
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402


def no_atomics_library(kernels, op, directory):
  """skip_gather.cu built with SKIP_GATHER_BWD_NO_ATOMICS."""
  path = os.path.join(directory, "libskip_gather_no_atomics.so")
  command = kernels.nvcc_command("skip_gather", path)
  command.insert(1, "-DSKIP_GATHER_BWD_NO_ATOMICS")
  subprocess.run(command, check=True)
  lib = ctypes.CDLL(path)
  for name, (argtypes, restype) in op._SIGNATURES.items():
    getattr(lib, name).argtypes = list(argtypes)
    getattr(lib, name).restype = restype
  return lib


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print("skip_backward_sweep: no CUDA device", file=sys.stderr)
    return 1
  from corenet_tpu_torch import kernels
  from corenet_tpu_torch.models import skip
  from corenet_tpu_torch.ops import skip_gather as op
  from corenet_tpu_torch.train.step import compute_v2s

  dev = torch.device("cuda", 0)
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True).stdout
  print(smi.strip(), flush=True)
  lib = kernels.library("skip_gather", op._SIGNATURES)
  scratch = tempfile.TemporaryDirectory()
  bare = no_atomics_library(kernels, op, scratch.name)
  camera, v2x = smoke.camera_and_v2x(torch, smoke.OUTPUT_RES[0])
  v2s = compute_v2s(camera.to(dev), v2x.to(dev))
  sample = torch.full((smoke.BATCH, 3), 0.5, device=dev)
  gen = torch.Generator().manual_seed(smoke.SEED + 2)
  b = smoke.BATCH
  result = {"device": torch.cuda.get_device_name(0), "power": smi.strip(),
            "stages": []}

  def launcher(library, step, px, py, acc, out, h2, phases, slices, z_phases,
               chunk):
    """One launch of the C entry point on dout `step` [b, phases, n, c]."""
    c = step.shape[-1]

    def launch():
      stream = torch.cuda.current_stream(dev).cuda_stream
      err = library.skip_gather_bwd(
          step.data_ptr(), px.data_ptr(), py.data_ptr(), acc.data_ptr(),
          out.data_ptr(), b, phases, step.shape[2], h2, h2, c,
          *step.stride(), slices, z_phases, chunk, step.element_size(),
          stream)
      if err != 0:
        raise RuntimeError(f"skip_gather_bwd failed: CUDA error {err}")
    return launch

  def checked_ms(launch, out, ref64, bound, what):
    launch()
    torch.cuda.synchronize()
    excess = float(((out.double() - ref64).abs() - bound).max())
    if excess > 0:
      raise AssertionError(f"{what}: exceeds its bound by {excess}")
    return smoke.device_ms(torch, launch)

  for stage, (div, h2, c) in smoke.SKIPS.items():
    layer = smoke.OUTPUT_RES[0] // div
    grid = (layer,) * 3
    half = (layer // 2,) * 3
    n = layer ** 3
    m = n // 8
    matrix = v2s * torch.tensor([div, div, div, 1.0], device=dev)
    cx = smoke.TOWER_CHANNELS[stage]
    row = {"stage": stage, "dfmap": [b, h2, h2, c], "n": n}

    # Fine voxel order, float32.
    px, py = skip.voxel_pixel_indices(matrix, sample, grid, h2 - 2, h2 - 2)
    dout = torch.randn((b, n, c), generator=gen).to(dev)
    cat_grad = torch.zeros((b, cx + c) + grid, device=dev)
    cat_grad[:, cx:] = dout.reshape((b,) + grid + (c,)).permute(0, 4, 1, 2, 3)
    step = cat_grad[:, cx:].permute(0, 2, 3, 4, 1).reshape(b, 1, n, c)
    ref64 = op.skip_gather_backward_reference(dout.double(), px, py, h2, h2)
    bound = 1e-5 * op.skip_gather_backward_reference(
        dout.double().abs(), px, py, h2, h2) + 1e-30
    acc = torch.empty((b, h2, h2, c), device=dev)
    walk = op.backward_walk(1, grid)
    fine = {"wrapper_z_chunk": walk.z_chunk,
            "wrapper_ms": smoke.device_ms(
                torch, lambda: op.skip_gather_backward(
                    step[:, 0], px, py, h2, h2, grid_resolution=grid)),
            "ms": {}}
    settings = {f"z chunk {k}": (layer, k) for k in range(1, layer + 1)
                if layer % k == 0}
    settings["one column per voxel"] = (1, 1)
    for name, (slices, chunk) in settings.items():
      fine["ms"][name] = checked_ms(
          launcher(lib, step, px, py, acc, acc, h2, 1, slices, 1, chunk),
          acc, ref64, bound, f"stage {stage} fine order, {name}")
    if stage == 5:
      fine["no_atomics_ms"] = smoke.device_ms(torch, launcher(
          bare, step, px, py, acc, acc, h2, 1, layer, 1, walk.z_chunk))
    row["fine_float32"] = fine
    times = ", ".join(f"{k} {v:.4f}" for k, v in fine["ms"].items())
    print(f"stage {stage} [{b},{h2},{h2},{c}] N={n} fine order float32: "
          f"wrapper (z chunk {walk.z_chunk}) {fine['wrapper_ms']:.4f} ms; "
          f"{times}" + (f"; without atomics {fine['no_atomics_ms']:.4f}"
                        if "no_atomics_ms" in fine else ""), flush=True)

    # Packed voxel order: phase-outer [b, 8, m, c], the step's layout.
    px, py = skip.voxel_pixel_indices(matrix, sample, grid, h2 - 2, h2 - 2,
                                      packed=True)
    walk = op.backward_walk(8, half)
    for dtype in (torch.float32, torch.bfloat16):
      name = str(dtype).replace("torch.", "")
      dout = torch.randn((b, 8, m, c), generator=gen).to(dev, dtype)
      cat_grad = torch.zeros((b, 8, cx + c) + half, device=dev, dtype=dtype)
      cat_grad[:, :, cx:] = dout.view((b, 8) + half + (c,)).permute(
          0, 1, 5, 2, 3, 4)
      step = cat_grad[:, :, cx:].permute(0, 1, 3, 4, 5, 2).reshape(
          b, 8, m, c)
      ref64 = op.skip_gather_backward_reference(dout.double(), px, py, h2,
                                                h2)
      bound = 1e-5 * op.skip_gather_backward_reference(
          dout.double().abs(), px, py, h2, h2) + 1e-30
      if dtype == torch.bfloat16:
        bound = bound + smoke.bf16_ulp(torch, ref64)
      acc = torch.empty((b, h2, h2, c), device=dev)
      out = acc if dtype == torch.float32 else torch.empty_like(
          acc, dtype=dtype)
      packed = {"wrapper_z_chunk": walk.z_chunk,
                "wrapper_ms": smoke.device_ms(
                    torch, lambda: op.skip_gather_backward(
                        step, px, py, h2, h2, grid_resolution=half)),
                "ms": {}, "phase_by_phase_ms": {}}
      for z_phases, key in ((2, "ms"), (1, "phase_by_phase_ms")):
        depth = z_phases * half[0]
        for k in range(1, depth + 1):
          if depth % k == 0:
            packed[key][f"z chunk {k}"] = checked_ms(
                launcher(lib, step, px, py, acc, out, h2, 8, half[0],
                         z_phases, k), out, ref64, bound,
                f"stage {stage} packed order {name}, {z_phases} z phases "
                f"per thread, z chunk {k}")
      if stage == 5:
        packed["no_atomics_ms"] = smoke.device_ms(torch, launcher(
            bare, step, px, py, acc, out, h2, 8, half[0], 2, walk.z_chunk))
      row[f"packed_{name}"] = packed
      for key, what in (("ms", "both z phases per thread"),
                        ("phase_by_phase_ms", "one phase per thread")):
        times = ", ".join(f"{k} {v:.4f}" for k, v in packed[key].items())
        print(f"stage {stage} packed order {name} [{b},8,{m},{c}], {what}: "
              f"{times}", flush=True)
      print(f"stage {stage} packed order {name}: wrapper (z chunk "
            f"{walk.z_chunk}) {packed['wrapper_ms']:.4f} ms" +
            (f"; without atomics {packed['no_atomics_ms']:.4f}"
             if "no_atomics_ms" in packed else ""), flush=True)
    result["stages"].append(row)
  print(json.dumps(result))
  return 0


if __name__ == "__main__":
  sys.exit(main())
