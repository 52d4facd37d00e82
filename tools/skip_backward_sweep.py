#!/usr/bin/env python3
"""The skip_gather backward kernel of the PyTorch port at other chunk
lengths along z than the wrapper's, on one CUDA card.

`corenet_tpu_torch/ops/skip_gather.py::z_chunk` gives each thread of the
backward kernel a quarter of its depth column. This script times the
kernel at the h7 training step's four skips (batch 4, float32, the
serving camera's indices, dout in the step's layout as chip_smoke.py
makes it) with every chunk length from 1 to the whole column, and with
every voxel its own column (the grid (1, 1, N)), calling the kernel's C
entry point directly. Each result is held against the float64
scatter-add within 1e-5 · Σ|dout| per cell before it is timed.

Usage, from the root of the repository, on a machine with an NVIDIA
Hopper card and the CUDA toolkit:

  python3 tools/skip_backward_sweep.py

Prints one line per skip and, last, one JSON object of the times (ms of
device time per launch, CUDA events around CUDA-graph replays).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402


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
  lib = kernels.library("skip_gather", op._SIGNATURES)
  camera, v2x = smoke.camera_and_v2x(torch, smoke.OUTPUT_RES[0])
  v2s = compute_v2s(camera.to(dev), v2x.to(dev))
  sample = torch.full((smoke.BATCH, 3), 0.5, device=dev)
  gen = torch.Generator().manual_seed(smoke.SEED + 2)
  b = smoke.BATCH
  result = {"device": torch.cuda.get_device_name(0), "stages": []}
  for stage, (div, h2, c) in smoke.SKIPS.items():
    layer = smoke.OUTPUT_RES[0] // div
    grid = (layer,) * 3
    matrix = v2s * torch.tensor([div, div, div, 1.0], device=dev)
    px, py = skip.voxel_pixel_indices(matrix, sample, grid, h2 - 2, h2 - 2)
    n = px.shape[1]
    cx = smoke.TOWER_CHANNELS[stage]
    dout = torch.randn((b, n, c), generator=gen).to(dev)
    cat_grad = torch.zeros((b, cx + c) + grid, device=dev)
    cat_grad[:, cx:] = dout.reshape((b,) + grid + (c,)).permute(0, 4, 1, 2, 3)
    step = cat_grad[:, cx:].permute(0, 2, 3, 4, 1).reshape(b, n, c)
    ref64 = op.skip_gather_backward_reference(dout.double(), px, py, h2, h2)
    bound = 1e-5 * op.skip_gather_backward_reference(
        dout.double().abs(), px, py, h2, h2) + 1e-30
    acc = torch.empty((b, h2, h2, c), device=dev)

    def launch(depth, chunk):
      stream = torch.cuda.current_stream(dev).cuda_stream
      err = lib.skip_gather_bwd(step.data_ptr(), px.data_ptr(), py.data_ptr(),
                                acc.data_ptr(), acc.data_ptr(), b, 1, n, h2,
                                h2, c, step.stride(0), 0, *step.stride()[1:],
                                depth, chunk, 4, stream)
      if err != 0:
        raise RuntimeError(f"skip_gather_bwd failed: CUDA error {err}")

    settings = {f"z chunk {k}": (layer, k) for k in range(1, layer + 1)
                if layer % k == 0}
    settings["one column per voxel"] = (1, 1)
    row = {"stage": stage, "dfmap": [b, h2, h2, c], "n": n,
           "wrapper_z_chunk": op.z_chunk(layer),
           "wrapper_ms": smoke.device_ms(
               torch, lambda: op.skip_gather_backward(
                   step, px, py, h2, h2, grid_resolution=grid)),
           "ms": {}}
    for name, (depth, chunk) in settings.items():
      launch(depth, chunk)
      torch.cuda.synchronize()
      excess = float(((acc.double() - ref64).abs() - bound).max())
      if excess > 0:
        raise AssertionError(f"stage {stage}, {name}: exceeds its bound by "
                             f"{excess}")
      row["ms"][name] = smoke.device_ms(torch, lambda: launch(depth, chunk))
    result["stages"].append(row)
    times = ", ".join(f"{k} {v:.4f}" for k, v in row["ms"].items())
    print(f"stage {stage} [{b},{h2},{h2},{c}] N={n}: wrapper (z chunk "
          f"{row['wrapper_z_chunk']}) {row['wrapper_ms']:.4f} ms; {times}",
          flush=True)
  print(json.dumps(result))
  return 0


if __name__ == "__main__":
  sys.exit(main())
