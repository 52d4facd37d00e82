#!/usr/bin/env python3
"""Smoke run of corenet_tpu_torch, the PyTorch + CUDA port, on one card.

Usage, from the root of the repository, on a machine with an NVIDIA
Hopper card (sm_90a) and the CUDA toolkit:

  python3 chip_smoke.py

Phases; the run fails at the first that fails:
  1. build    compiles every CUDA kernel of the port (csrc/*.cu) into
              corenet_tpu_torch/_build/.
  2. kernels  calls each kernel's wrapper at the shapes its paths give
              it, holds the result against the plain PyTorch version, and
              times kernel, plain version and, where there is one, one
              PyTorch library call of the same function: device time from
              CUDA events around CUDA-graph replays. The skip gather at both
              serving paths' shapes (h7: batch 4 at 128³; y1: 64 offsets ×
              batch 4 as one batch of 256 at 32³) with the indices those
              paths compute (torch.equal); its backward at h7 training's
              (the h7 indices, batch 4), f32 and bf16, against the float64
              scatter-add within 1e-5 · Σ|dout| per cell (plus one bf16
              ulp); fgbg_sums at [4, 128³] with int32, uint8 and float32
              labels, within 1e-6 relative.
  3. serving  h7: 128³ output, 2 classes, batch 4, 256² images, random
              weights from a seed, through super_resolution_from_model.
              Checks the PMF (shape, finite, sums to 1), that each forward
              launched the skip kernel once per skip (4), and that the
              logits equal those of the same forward with the plain skips.
              Times 30 forwards one by one (closed loop, one batch in
              flight) and profiles one more (device busy time, the kernels
              with the most device time).
  4. y1       a y1-shaped model (32³ native → 128³ output: m = 4, 64
              decode passes folded into one batch, the encoder once): the
              same PMF, launch, plain-skip and timing checks, the batched
              passes against the 64 sequential ones, and the card's logits
              against the port's CPU logits on a small input.
  5. train    h7 training: 128³, 2 classes, batch 4, 256² images, the
              serving camera, a ground-truth grid of seeded ellipsoids made
              on the card, Adam (lr 4e-4, eps 1e-4), through
              create_train_state and make_train_step. Checks that each step
              launched the skip gather 4 times, its backward 4 times and
              fgbg_sums once, that loss and gradients are finite, that the
              loss falls over 10 steps on the batch, and that one step with
              the kernels matches the same step with the plain versions.
              Times 20 steps one by one and profiles one more. Then one
              step at 32³ on the card against the same step on the CPU.
  6. train-gt h7 training as the JAX package trains by default: ground
              truth voxelized in the step from the batch's triangles
              (blocked rasterizer: phase A, the CUDA block_scatter_or,
              the packed fill, the OR over labeled mesh slots) and phased
              by the CUDA phased_gt (s = 2) for the phase loss on
              phase-major logits; h7's voxelization settings (irm 8, no
              conservative rasterization, adaptive fill, a 24-pixel
              window). Each scene: slot 0 a cube shell at [0.3, 0.7]³
              moved by a seeded offset of at most 0.05, subdivided to
              12,288 triangles; slot 1 a seeded closed sphere (~1.5k
              triangles), label 0 in the last scene; padded to 16,384.
              Checks 1 + 1 + 4 + 4 + 1 launches per step (block_scatter_or,
              phased_gt, skip_gather, its backward, fgbg_sums), the step's
              phased GT against the plain scatter + fill + unpack +
              permute on the card and the card's packed GT against the
              CPU's (two scenes, bit for bit), finite loss and gradients,
              a falling loss, the kernel step against the plain step, and
              the phase loss against the plain loss on the same grid.
              Times K3 and K4 at the step's shapes, the GT's parts, 20
              steps, and profiles one more.

Float32 throughout: TF32 is switched off for convolutions and matmuls, so
the float32 path computes in float32 on the card as on the CPU.

Prints the card's name and power limit as nvidia-smi gives them, one JSON
line of kernel figures, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it prints no result and exits with status 1.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import re
import statistics
import subprocess
import sys
import time

SEED = 0
BATCH = 4
IMAGE_HW = 256
OUTPUT_RES = (128, 128, 128)
Y1_NATIVE = (32, 32, 32)
SERVE_RUNS = 30
TRAIN_RUNS = 20
LOSS_STEPS = 10
TRAIN_SMALL = (32, 32, 32)  # the card-against-CPU step
# h7's voxelization (configs/models/h7.json5; fill rounds 0 = adaptive,
# the window of corenet_tpu/eval/pipeline.py:40), for two label values.
H7_VOX = dict(sub_grid_sampling=False, image_resolution_multiplier=8,
              conservative_rasterization=False,
              projection_depth_multiplier=1, max_bbox_pixels=24,
              fill_rounds=None, num_label_values=2)
GT_TRIANGLES = 16384  # padded triangles per scene
GT_CPU_SCENES = [0, BATCH - 1]  # voxelized on the CPU too
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
# The decoder's skips: stage → (native resolution / layer resolution,
# padded map H2 = W2 at 256² images, channels).
SKIPS = {2: (16, 10, 96), 3: (8, 18, 48), 4: (4, 34, 24), 5: (2, 66, 12)}


def log(*args):
  print(*args, flush=True)


def camera_and_v2x(torch, res):
  """A perspective camera looking at the voxel box [0, 1]³ of view space
  from 1 unit in front of it (fov ≈ 53° at the front face), per scene a
  slightly different focal length, and the world → voxel scale."""
  near, far = 0.5, 3.0
  a = (far + near) / (far - near)
  b = -2 * far * near / (far - near)
  cams = []
  for i in range(BATCH):
    f = 1.8 + 0.1 * i
    cams.append([[f, 0, 0, -0.5 * f], [0, f, 0, -0.5 * f],
                 [0, 0, a, a + b], [0, 0, 1, 1.0]])
  camera = torch.tensor(cams, dtype=torch.float32)
  v2x = torch.diag(torch.tensor([float(res)] * 3 + [1.0])).expand(
      BATCH, 4, 4).contiguous()
  return camera, v2x


def seeded_model(torch, CoreNet, config, seed, phase_output=False):
  """A CPU CoreNet with the port's seeded init and random BatchRenorm
  running statistics (mean ~ N(0, 0.3), var ~ U(0.5, 2)), and a CPU copy
  of its state_dict."""
  model = CoreNet(config, phase_output=phase_output)
  model.reset_parameters(torch.Generator().manual_seed(seed))
  gen = torch.Generator().manual_seed(seed + 1)
  with torch.no_grad():
    for name, buf in model.named_buffers():
      if name.endswith(".mean"):
        buf.copy_(torch.randn(buf.shape, generator=gen) * 0.3)
      elif name.endswith(".var"):
        buf.copy_(torch.rand(buf.shape, generator=gen) * 1.5 + 0.5)
  return model, {k: v.clone() for k, v in model.state_dict().items()}


def device_ms(torch, fn, reps=20, trials=7):
  """Device time per call: `reps` calls captured in one CUDA graph, whose
  replays are timed with CUDA events (median over trials). The graph
  takes the host out of the measurement."""
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    fn()  # warm-up off the default stream, as graph capture requires
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(reps):
      fn()
  graph.replay()
  torch.cuda.synchronize()
  times = []
  for _ in range(trials):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end) / reps)
  del graph
  return statistics.median(times)


def device_profile(torch, forward):
  """One forward under torch.profiler: the device's busy time (the union
  of its kernels' intervals), the forward's wall time on the host clock,
  and the kernels with the most device time. None where the trace holds
  no device events."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
  with profile(activities=activities) as prof:
    torch.cuda.synchronize()
    start = time.perf_counter()
    forward()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3
  spans = sorted((e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
  if not spans:
    return None
  busy_us, end_us = 0.0, float("-inf")
  for lo, hi in spans:
    busy_us += max(0.0, hi - max(lo, end_us))
    end_us = max(end_us, hi)
  by_name = {}
  for e in prof.events():
    if e.device_type == DeviceType.CUDA:
      by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
  return {"wall_ms": wall_ms, "busy_ms": busy_us / 1e3,
          "device_events": len(spans),
          "top": [(n, t / 1e3) for n, t in top]}


def log_profile(label, profile, wall_ms, what="forward"):
  """The profiled forward's (or step's) device busy time against
  `wall_ms`, the median unprofiled one: the profiler slows the host, so
  the idle share is taken against the unprofiled time."""
  if profile is None:
    log(f"{label} device profile: not measured (the trace holds no device "
        "events)")
    return
  busy = profile["busy_ms"]
  log(f"{label} device profile, one {what}: device busy {busy:.3f} ms, "
      f"idle share {1 - busy / wall_ms:.3f} of the unprofiled "
      f"{wall_ms:.3f} ms (wall under the profiler {profile['wall_ms']:.3f} "
      f"ms), {profile['device_events']} device events; most device time:")
  for name, ms in profile["top"]:
    log(f"  {ms:9.3f} ms  {name[:120]}")


def check_pmf(torch, pmf, shape):
  if tuple(pmf.shape) != tuple(shape):
    raise AssertionError(f"PMF shape {tuple(pmf.shape)}, expected {shape}")
  if not bool(torch.isfinite(pmf).all()):
    raise AssertionError("PMF has non-finite values")
  err = float((pmf.sum(-1) - 1).abs().max())
  if err > 1e-5:
    raise AssertionError(f"PMF sums deviate from 1 by {err}")
  return err


def serve(torch, op, label, infer, args, shape):
  """The serving path's run: one forward whose skip-kernel launches are
  counted (zeroed just before, read just after) and whose PMF is checked,
  then SERVE_RUNS forwards timed one by one on the host clock, each ended
  by a synchronize, then one profiled forward. Returns the launches of the
  first forward and the median time per forward in ms."""
  torch.cuda.synchronize()
  op.launch_count = 0
  start = time.perf_counter()
  pmf = infer(*args)
  torch.cuda.synchronize()
  first_s = time.perf_counter() - start
  launches = op.launch_count
  if launches != 4:
    raise AssertionError(f"{label} forward launched skip_gather {launches} "
                         "times, expected 4 (one per skip)")
  sum_err = check_pmf(torch, pmf, shape)
  del pmf
  torch.cuda.reset_peak_memory_stats()
  op.launch_count = 0
  times = []
  for _ in range(SERVE_RUNS):
    start = time.perf_counter()
    infer(*args)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - start) * 1e3)
  if op.launch_count != 4 * SERVE_RUNS:
    raise AssertionError(f"{op.launch_count} launches in {SERVE_RUNS} "
                         "forwards")
  mem = torch.cuda.max_memory_allocated()
  ms = statistics.median(times)
  log_profile(label, device_profile(torch, lambda: infer(*args)), ms)
  log(f"{label} serve: PMF {list(shape)}, |sum - 1| <= {sum_err:.2e}, "
      f"skip_gather launches {launches} per forward; first forward "
      f"{first_s:.3f} s, then over {SERVE_RUNS} forwards median "
      f"{ms:.3f} ms (min {min(times):.3f}, max {max(times):.3f}) per batch "
      f"of {BATCH} = {BATCH * 1e3 / ms:.2f} scenes/s, peak memory "
      f"{mem / 2**30:.2f} GiB")
  return launches, ms


def check_plain_skips(torch, op, fgbg, label, model, infer, args):
  """The path's logits (the decoder's output, caught by a hook) with the
  kernel and with the plain skips: bit-identical, since the gather is a
  copy. cuDNN is held to deterministic algorithms for both so that no
  convolution sums in a run-dependent order."""
  logits = []
  hook = model.decoder.register_forward_hook(
      lambda module, inputs, out: logits.append(out))
  torch.backends.cudnn.deterministic = True
  try:
    infer(*args)
    with plain_versions(op, fgbg):
      infer(*args)
  finally:
    torch.backends.cudnn.deterministic = False
    hook.remove()
  if len(logits) != 2:
    raise AssertionError(f"{label}: {len(logits)} decoder calls, expected 2")
  kernel, plain = logits
  if not torch.equal(kernel, plain):
    diff = float((kernel - plain).abs().max())
    raise AssertionError(f"{label} logits with the kernel differ from the "
                         f"plain skips by {diff}")
  log(f"{label} logits {list(kernel.shape)} with the kernel equal those with "
      f"the plain skips (max |logit| {float(kernel.abs().max()):.4f})")


def bf16_ulp(torch, x):
  """The spacing of bfloat16 numbers at |x| (its smallest normal's at 0)."""
  mag = x.abs().to(torch.bfloat16).double().clamp(min=2.0 ** -126)
  return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def skip_backward_rows(torch, op, v2s, sample, res, gen):
  """skip_gather's backward at h7 training's shapes (batch 4, the four
  skips, the path's own indices), f32 and bf16: the kernel and the plain
  version against the float64 scatter-add, and their times. Also times
  the kernel with the voxels that land on the pad ring moved one pixel
  inwards, which shows what the ring's hot cells cost."""
  from corenet_tpu_torch.models import skip
  dev = v2s.device
  b = v2s.shape[0]
  bidx = torch.arange(b, device=dev)[:, None]
  rows = []
  for stage, (div, h2, c) in SKIPS.items():
    layer = res // div
    matrix = v2s * torch.tensor([div, div, div, 1.0], device=dev)
    px, py = skip.voxel_pixel_indices(matrix, sample, (layer,) * 3,
                                      h2 - 2, h2 - 2)
    n = px.shape[1]
    on_pad = (px == 0) | (px == h2 - 1) | (py == 0) | (py == h2 - 1)
    inner_px = px.clamp(1, h2 - 2).contiguous()
    inner_py = py.clamp(1, h2 - 2).contiguous()
    flat = (bidx * h2 * h2 + py.long() * h2 + px.long()).reshape(-1)
    per_pixel = torch.bincount(flat, minlength=b * h2 * h2)
    for dtype in (torch.float32, torch.bfloat16):
      dout = torch.randn((b, n, c), generator=gen).to(dev, dtype)
      got = op.skip_gather_backward(dout, px, py, h2, h2)
      plain = op.skip_gather_backward_reference(dout, px, py, h2, h2)
      ref64 = op.skip_gather_backward_reference(dout.double(), px, py, h2, h2)
      mass = op.skip_gather_backward_reference(dout.double().abs(), px, py,
                                               h2, h2)
      torch.cuda.synchronize()
      bound = 1e-5 * mass + 1e-30
      if dtype == torch.bfloat16:
        bound = bound + bf16_ulp(torch, ref64)
      for what, out in (("kernel", got), ("plain version", plain)):
        excess = float(((out.double() - ref64).abs() - bound).max())
        if excess > 0:
          raise AssertionError(f"skip_gather backward ({what}) exceeds its "
                               f"bound by {excess} at stage {stage} {dtype}")
      es = dout.element_size()
      nbytes = b * n * (c * es + 8) + b * h2 * h2 * c * es
      dout2d = dout.reshape(b * n, c)
      row = {
          "stage": stage, "dtype": str(dtype).replace("torch.", ""),
          "dfmap": [b, h2, h2, c], "n": n, "bytes": nbytes,
          "voxels_on_pad_share": float(on_pad.float().mean()),
          "max_voxels_per_pixel": int(per_pixel.max()),
          "max_abs_err_vs_plain": float((got.float() - plain.float())
                                        .abs().max()),
          "ms": device_ms(torch, lambda: op.skip_gather_backward(
              dout, px, py, h2, h2)),
          "ms_pad_moved_inwards": device_ms(
              torch, lambda: op.skip_gather_backward(
                  dout, inner_px, inner_py, h2, h2)),
          "plain_ms": device_ms(
              torch, lambda: op.skip_gather_backward_reference(
                  dout, px, py, h2, h2)),
          # One PyTorch call of the same function: index_add_ into a zeroed
          # f32 buffer (float32 only; bf16 would accumulate in bf16).
          "library_ms": device_ms(
              torch, lambda: torch.zeros(
                  (b * h2 * h2, c), device=dev).index_add_(0, flat, dout2d))
          if dtype == torch.float32 else None,
          "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
      }
      rows.append(row)
      lib = ("none" if row["library_ms"] is None
             else f"{row['library_ms']:.4f} ms")
      log(f"skip_gather backward stage {stage} {row['dtype']:8s} "
          f"[{b},{h2},{h2},{c}] N={n}: kernel {row['ms']:.4f} ms (pad "
          f"voxels moved inwards {row['ms_pad_moved_inwards']:.4f}), plain "
          f"{row['plain_ms']:.4f} ms, library {lib}, bound "
          f"{row['bound_ms']:.4f} ms ({nbytes} B); voxels on the pad "
          f"{row['voxels_on_pad_share']:.4f}, max voxels per pixel "
          f"{row['max_voxels_per_pixel']}")
  return rows


def fgbg_rows(torch, fgbg, dev, gen):
  """fgbg_sums at [4, 128³] with f32 diff and int32, uint8 and float32
  labels, against the plain version within 1e-6 relative."""
  n = OUTPUT_RES[0] * OUTPUT_RES[1] * OUTPUT_RES[2]
  diff = (torch.randn((BATCH, n), generator=gen) * 3).to(dev)
  labels = (torch.rand((BATCH, n), generator=gen) < 0.3).to(dev)
  rows = []
  for gt_dtype in (torch.int32, torch.uint8, torch.float32):
    gt = labels.to(gt_dtype)
    inter, union = fgbg.fgbg_sums(diff, gt)
    ref = fgbg.fgbg_sums_reference(diff, gt)
    again = fgbg.fgbg_sums(diff, gt)
    torch.cuda.synchronize()
    err = max(float(((got - want) / want).abs().max())
              for got, want in zip((inter, union), ref))
    if err > 1e-6:
      raise AssertionError(f"fgbg_sums differs from its plain version by "
                           f"{err} relative ({gt_dtype} labels)")
    if not (torch.equal(again[0], inter) and torch.equal(again[1], union)):
      raise AssertionError("fgbg_sums gave other sums on the same inputs")
    nbytes = diff.numel() * 4 + gt.numel() * gt.element_size() + BATCH * 8
    row = {
        "gt_dtype": str(gt_dtype).replace("torch.", ""),
        "diff": [BATCH, n], "bytes": nbytes, "max_rel_err": err,
        "max_abs_err": max(float((got - want).abs().max())
                           for got, want in zip((inter, union), ref)),
        "ms": device_ms(torch, lambda: fgbg.fgbg_sums(diff, gt)),
        "plain_ms": device_ms(
            torch, lambda: fgbg.fgbg_sums_reference(diff, gt)),
        "library_ms": None,  # no single PyTorch call computes both sums
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
    }
    rows.append(row)
    log(f"fgbg_sums [{BATCH},{n}] f32 diff, {row['gt_dtype']} labels: kernel "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library none, "
        f"bound {row['bound_ms']:.4f} ms ({nbytes} B); max relative error "
        f"{err:.2e}")
  return rows


# Each kernel's swappable forward (or backward) and its plain version.
PLAIN = {
    "skip_gather": (("skip_gather_forward", "skip_gather_reference"),
                    ("skip_gather_backward",
                     "skip_gather_backward_reference")),
    "fgbg_loss": (("fgbg_sums_forward", "fgbg_sums_reference"),),
    "block_scatter": (("block_scatter_or_forward",
                       "block_scatter_or_reference"),),
    "phased_gt": (("phased_gt_forward", "phased_gt_reference"),),
}


@contextlib.contextmanager
def plain_versions(*modules):
  """Swaps the kernels of the given ops modules for their plain
  versions."""
  saved = []
  for module in modules:
    for name, plain in PLAIN[module.__name__.rsplit(".", 1)[-1]]:
      saved.append((module, name, getattr(module, name)))
      setattr(module, name, getattr(module, plain))
  try:
    yield
  finally:
    for module, name, fn in saved:
      setattr(module, name, fn)


def launch_counts(*modules):
  """Every launch counter of the given ops modules."""
  return tuple(getattr(module, name) for module in modules
               for name in ("launch_count", "backward_launch_count")
               if hasattr(module, name))


def zero_counts(*modules):
  for module in modules:
    for name in ("launch_count", "backward_launch_count"):
      if hasattr(module, name):
        setattr(module, name, 0)


def ellipsoid_grid(torch, dev, res, batch, offsets, seed):
  """int32[B, D, H, W] ground truth made on the card: per scene one or two
  ellipsoids inside the voxel box, tested at the voxel centres + the
  grid offset."""
  gen = torch.Generator().manual_seed(seed)
  d, h, w = res
  z = torch.arange(d, device=dev, dtype=torch.float32).view(d, 1, 1)
  y = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1)
  x = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w)
  size = torch.tensor([w, h, d], dtype=torch.float32)
  grid = torch.zeros((batch,) + tuple(res), dtype=torch.int32, device=dev)
  for i in range(batch):
    for _ in range(1 + i % 2):
      centre = ((0.3 + 0.4 * torch.rand(3, generator=gen)) * size).tolist()
      radius = ((0.2 + 0.15 * torch.rand(3, generator=gen)) * size).tolist()
      o = offsets[i].tolist()
      inside = (((x + o[0] - centre[0]) / radius[0]) ** 2
                + ((y + o[1] - centre[1]) / radius[1]) ** 2
                + ((z + o[2] - centre[2]) / radius[2]) ** 2) <= 1.0
      grid[i] |= inside.int()
  return grid


def feeds_batch_renorm(name):
  """Conv biases whose output a BatchRenorm normalizes: its mean
  subtraction cancels them, so their true gradient is 0."""
  return name.endswith(".bias") and (
      (name.startswith("encoder.") and "conv" in name.split(".")[-2])
      or re.fullmatch(r"decoder\.stage_\d_c\.bias", name) is not None)


def compare_with_plain_step(torch, modules, state, step, batch, label):
  """One step with the kernels and the same step, from the same state,
  with the plain versions: loss within 1e-6 relative and every gradient
  that carries mass within 1e-4 relative L2. cuDNN is held to
  deterministic algorithms, so the forward is the same bit for bit and
  only the order of summation differs. The state is restored after."""
  model, optimizer = state.model, state.optimizer
  snap_model = {k: v.clone() for k, v in model.state_dict().items()}
  snap_opt = copy.deepcopy(optimizer.state_dict())
  results = []
  torch.backends.cudnn.deterministic = True
  try:
    for plain in (False, True):
      model.load_state_dict(snap_model)
      optimizer.load_state_dict(snap_opt)
      counts = launch_counts(*modules)
      with plain_versions(*modules) if plain else contextlib.nullcontext():
        _, metrics = step(state, batch)
      torch.cuda.synchronize()
      launched = launch_counts(*modules) != counts
      if launched == plain:
        raise AssertionError(f"the {'plain' if plain else 'kernel'} step "
                             f"{'launched' if plain else 'skipped'} kernels")
      results.append((float(metrics["loss"]),
                      {n: p.grad.detach().clone()
                       for n, p in model.named_parameters()}))
  finally:
    torch.backends.cudnn.deterministic = False
    model.load_state_dict(snap_model)
    optimizer.load_state_dict(snap_opt)
  (loss_k, grads_k), (loss_p, grads_p) = results
  loss_rel = abs(loss_k - loss_p) / abs(loss_p)
  if loss_rel > 1e-6:
    raise AssertionError(f"kernel step loss {loss_k} and plain step loss "
                         f"{loss_p} differ by {loss_rel} relative")
  worst, worst_name, checked = 0.0, None, 0
  for name, gp in grads_p.items():
    if feeds_batch_renorm(name):
      continue
    rel = float((grads_k[name] - gp).norm() / gp.norm())
    checked += 1
    if not math.isfinite(rel) or rel > worst:
      worst, worst_name = rel, name
  if not worst <= 1e-4:
    raise AssertionError(f"gradient {worst_name} of the kernel step differs "
                         f"from the plain step's by {worst} relative L2")
  log(f"{label}: the step with the kernels matches the step with the plain "
      f"versions: loss {loss_k:.7f} vs {loss_p:.7f} ({loss_rel:.2e} "
      f"relative), worst of {checked} gradients {worst:.2e} relative L2 "
      f"({worst_name})")
  return loss_rel, worst


def train_h7(torch, op, fgbg, CoreNet, config, image, camera, v2x, offsets,
             dev):
  """Phase 5: the h7 training step. Returns the launches of the first
  step (forward, backward, fgbg) and the median step time in ms."""
  from corenet_tpu_torch.train.state import create_train_state
  from corenet_tpu_torch.train.step import make_train_step
  model, _ = seeded_model(torch, CoreNet, config, SEED + 20)
  state = create_train_state(model, device=dev)
  step = make_train_step(state.model, state.optimizer, "FG_BG", OUTPUT_RES)
  grid = ellipsoid_grid(torch, dev, OUTPUT_RES, BATCH, offsets, SEED + 21)
  batch = {"image": image.to(dev), "camera": camera.to(dev),
           "v2x": v2x.to(dev), "grid": grid, "grid_offset": offsets.to(dev)}
  log(f"h7 train: grid int32 {list(grid.shape)} of seeded ellipsoids, "
      f"foreground share {float(grid.float().mean()):.4f}")

  torch.cuda.synchronize()
  op.launch_count = op.backward_launch_count = fgbg.launch_count = 0
  start = time.perf_counter()
  state, metrics = step(state, batch)
  torch.cuda.synchronize()
  first_s = time.perf_counter() - start
  launches = (op.launch_count, op.backward_launch_count, fgbg.launch_count)
  if launches != (4, 4, 1):
    raise AssertionError(f"h7 train step launched (skip_gather, its "
                         f"backward, fgbg_sums) {launches} times, expected "
                         "(4, 4, 1)")
  first_loss = float(metrics["loss"])
  bad = [n for n, p in state.model.named_parameters()
         if p.grad is None or not bool(torch.isfinite(p.grad).all())]
  if not math.isfinite(first_loss) or bad:
    raise AssertionError(f"h7 train: loss {first_loss}, non-finite or "
                         f"missing gradients {bad[:5]}")
  if state.global_step != BATCH:
    raise AssertionError(f"global_step {state.global_step} after one step")
  log(f"h7 train: first step {first_s:.3f} s, loss {first_loss:.6f}, "
      f"launches (skip_gather, backward, fgbg_sums) {launches}, loss and "
      "all gradients finite")

  compare_with_plain_step(torch, (op, fgbg), state, step, batch, "h7 train")

  losses = []
  for _ in range(LOSS_STEPS):
    state, metrics = step(state, batch)
    losses.append(float(metrics["loss"]))
  if not losses[-1] < first_loss:
    raise AssertionError(f"h7 train: loss did not fall over {LOSS_STEPS} "
                         f"steps: {first_loss} then {losses}")
  log(f"h7 train: loss {first_loss:.6f} at step 1, then " +
      ", ".join(f"{v:.6f}" for v in losses))

  torch.cuda.reset_peak_memory_stats()
  times = []
  for _ in range(TRAIN_RUNS):
    start = time.perf_counter()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - start) * 1e3)
  mem = torch.cuda.max_memory_allocated()
  ms = statistics.median(times)
  holder = [state]

  def one_step():
    holder[0], _ = step(holder[0], batch)

  log_profile("h7 train", device_profile(torch, one_step), ms, what="step")
  log(f"h7 train: over {TRAIN_RUNS} steps median {ms:.3f} ms (min "
      f"{min(times):.3f}, max {max(times):.3f}) per batch of {BATCH} = "
      f"{BATCH * 1e3 / ms:.2f} training scenes/s; first step {first_s:.3f} "
      f"s; peak memory {mem / 2**30:.2f} GiB")
  return launches, ms


def train_card_against_cpu(torch, CoreNet, CoreNetConfig, DecoderConfig,
                           image, camera, offsets, dev):
  """One step at 32³, batch 2, 64² images on the card against the same
  step on the CPU (the path tests/test_torch_train_step.py holds against
  JAX): loss within 1e-4 relative."""
  from corenet_tpu_torch.train.state import create_train_state
  from corenet_tpu_torch.train.step import make_train_step
  config = CoreNetConfig(DecoderConfig(TRAIN_SMALL, 2))
  _, weights = seeded_model(torch, CoreNet, config, SEED + 30)
  res = TRAIN_SMALL[0]
  batch = {"image": image[:2, :64, :64].contiguous(),
           "camera": camera[:2],
           "v2x": torch.diag(torch.tensor([float(res)] * 3 + [1.0])).expand(
               2, 4, 4).contiguous(),
           "grid": ellipsoid_grid(torch, "cpu", TRAIN_SMALL, 2, offsets[:2],
                                  SEED + 31),
           "grid_offset": offsets[:2]}
  result = {}
  for where in ("cpu", dev):
    model = CoreNet(config)
    model.load_state_dict(weights)
    state = create_train_state(model, device=where)
    step = make_train_step(state.model, state.optimizer, "FG_BG",
                           TRAIN_SMALL)
    _, metrics = step(state, {k: v.to(where) for k, v in batch.items()})
    result[str(where)] = float(metrics["loss"])
  cpu, card = result["cpu"], result[str(dev)]
  rel = abs(card - cpu) / abs(cpu)
  if rel > 1e-4:
    raise AssertionError(f"32³ train step: card loss {card}, CPU loss {cpu}")
  log(f"32³ train step: card loss {card:.7f} matches the CPU's {cpu:.7f} "
      f"({rel:.2e} relative; tolerance 1e-4)")


def cube_shell():
  """The 12-triangle closed cube at [0.3, 0.7]³ of bench.py's scenes
  (__graft_entry__._example_inputs), float32[12, 3, 3]."""
  import numpy as np
  m, x = 0.3, 0.7
  return np.array([
      [[m, m, m], [m, x, m], [m, m, x]], [[m, x, x], [m, x, m], [m, m, x]],
      [[x, m, m], [x, x, m], [x, m, x]], [[x, x, x], [x, x, m], [x, m, x]],
      [[m, m, m], [m, m, x], [x, m, m]], [[x, m, x], [m, m, x], [x, m, m]],
      [[m, x, m], [m, x, x], [x, x, m]], [[x, x, x], [m, x, x], [x, x, m]],
      [[m, m, m], [m, x, m], [x, m, m]], [[x, x, m], [m, x, m], [x, m, m]],
      [[m, m, x], [m, x, x], [x, m, x]], [[x, x, x], [m, x, x], [x, m, x]],
  ], np.float32)


def sphere_mesh(rng, centre, radius, n_lat=8, n_lon=12):
  """A closed latitude-longitude sphere with seeded per-vertex radii
  (±10 %), float32[T, 3, 3]."""
  import numpy as np
  theta = np.linspace(0, np.pi, n_lat + 1)[1:-1]
  phi = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
  ring = np.stack([np.outer(np.sin(theta), np.cos(phi)),
                   np.outer(np.sin(theta), np.sin(phi)),
                   np.repeat(np.cos(theta)[:, None], n_lon, 1)], axis=-1)
  verts = np.concatenate([[[0, 0, 1]], ring.reshape(-1, 3), [[0, 0, -1]]])
  verts = centre + verts * radius * rng.uniform(0.9, 1.1, (len(verts), 1))

  def idx(i, j):
    return 1 + i * n_lon + j % n_lon

  tris = []
  for j in range(n_lon):
    tris.append((0, idx(0, j), idx(0, j + 1)))
    tris.append((len(verts) - 1, idx(n_lat - 2, j + 1), idx(n_lat - 2, j)))
    for i in range(n_lat - 2):
      tris.append((idx(i, j), idx(i + 1, j), idx(i + 1, j + 1)))
      tris.append((idx(i, j), idx(i + 1, j + 1), idx(i, j + 1)))
  return verts[np.array(tris)].astype(np.float32)


def triangle_batch(torch, image, camera, seed):
  """The phase-6 batch on the host: per scene the subdivided cube shell
  (slot 0) moved by a seeded offset of at most 0.05 per axis, and a
  seeded sphere of radius 0.09 near a corner (slot 1, label 0 in the last
  scene), padded to GT_TRIANGLES; the serving images and cameras."""
  import numpy as np
  from corenet_tpu_torch.data.batching import (
      VOXELIZE_WINDOW_PIXELS, subdivide_triangles)
  rng = np.random.default_rng(seed)
  irm = H7_VOX["image_resolution_multiplier"]
  max_edge = (VOXELIZE_WINDOW_PIXELS - 4) / irm / OUTPUT_RES[0]
  triangles = np.zeros((BATCH, GT_TRIANGLES, 3, 3), np.float32)
  slot = np.zeros((BATCH, GT_TRIANGLES), np.int32)
  valid = np.zeros((BATCH, GT_TRIANGLES), bool)
  counts = []
  for i in range(BATCH):
    cube = subdivide_triangles(
        cube_shell() + rng.uniform(-0.05, 0.05, 3).astype(np.float32),
        max_edge)
    sphere = subdivide_triangles(sphere_mesh(
        rng, rng.uniform([0.13, 0.13, 0.84], [0.17, 0.17, 0.88]), 0.09),
                                 max_edge)
    n = len(cube) + len(sphere)
    if n > GT_TRIANGLES:
      raise AssertionError(f"scene {i}: {n} triangles > {GT_TRIANGLES}")
    triangles[i, :n] = np.concatenate([cube, sphere])
    slot[i, len(cube):n] = 1
    valid[i, :n] = True
    counts.append((len(cube), len(sphere)))
  labels = np.ones((BATCH, 2), np.int32)
  labels[BATCH - 1, 1] = 0
  batch = {"image": image, "camera": camera,
           "triangles": torch.from_numpy(triangles),
           "tri_mesh_slot": torch.from_numpy(slot),
           "tri_valid": torch.from_numpy(valid),
           "mesh_labels": torch.from_numpy(labels),
           "grid_offset": torch.from_numpy(
               rng.uniform(0.0, 1.0, (BATCH, 3)).astype(np.float32))}
  return batch, counts


GT_KEYS = ("triangles", "tri_mesh_slot", "tri_valid", "mesh_labels",
           "grid_offset")


def gt_kernel_rows(torch, scatter, phased, batch, packed_or, rounds):
  """K3 and K4 at the step's shapes against their plain versions, and the
  device time of the GT's parts: phase A, the scatter, the fill (its
  static loop with the rounds the adaptive fill ran), the slot OR with
  phased_gt."""
  from corenet_tpu_torch.train import gt
  from corenet_tpu_torch.voxel import packed as packed_mod
  from corenet_tpu_torch.voxel import raster_fast
  m = OUTPUT_RES[0]
  nw = m // 32
  meshes = batch["mesh_labels"].shape[1]
  v2v = gt._view2voxel_uniform(batch["grid_offset"], float(m), meshes)

  def phase_a():
    return raster_fast._phase_a(
        batch["triangles"], batch["tri_mesh_slot"], v2v, batch["tri_valid"],
        m=m, irm=H7_VOX["image_resolution_multiplier"],
        conservative=H7_VOX["conservative_rasterization"])

  origins, pw = phase_a()
  kw = dict(meshes=meshes, h=m, w=m, nw=nw)
  grids = scatter.block_scatter_or(origins, pw, **kw)
  plain = scatter.block_scatter_or_reference(origins, pw, **kw)
  torch.cuda.synchronize()
  if not torch.equal(grids, plain):
    raise AssertionError("block_scatter_or differs from its plain version "
                         "at the step's shapes")
  valid = int((origins >= 0).sum())
  atomics = int((pw != 0).sum())
  block_bytes = pw[0, 0].numel() * 4
  k3_bytes = valid * (block_bytes + 4) + grids.numel() * 4
  k3 = {"origins": list(origins.shape), "pw": list(pw.shape),
        "out": list(grids.shape), "valid_triangles": valid,
        "nonzero_words": atomics, "bytes": k3_bytes, "max_abs_err": 0.0,
        "ms": device_ms(torch, lambda: scatter.block_scatter_or(
            origins, pw, **kw)),
        "plain_ms": device_ms(torch, lambda: scatter.
                              block_scatter_or_reference(origins, pw, **kw),
                              reps=2, trials=3),
        "library_ms": None, "bound_ms": k3_bytes / HBM_BYTES_PER_S * 1e3}
  phases = phased.phased_gt(packed_or, 2)
  plain = phased.phased_gt_reference(packed_or, 2)
  torch.cuda.synchronize()
  if not torch.equal(phases, plain):
    raise AssertionError("phased_gt differs from its plain version at the "
                         "step's shapes")
  k4_bytes = packed_or.numel() * 4 + phases.numel()
  k4 = {"packed": list(packed_or.shape), "out": list(phases.shape),
        "bytes": k4_bytes, "max_abs_err": 0.0,
        "ms": device_ms(torch, lambda: phased.phased_gt(packed_or, 2)),
        "plain_ms": device_ms(
            torch, lambda: phased.phased_gt_reference(packed_or, 2)),
        "library_ms": None, "bound_ms": k4_bytes / HBM_BYTES_PER_S * 1e3}
  for name, row in (("block_scatter_or", k3), ("phased_gt", k4)):
    log(f"{name} at the step's shapes: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, library none, bound "
        f"{row['bound_ms']:.4f} ms ({row['bytes']} B)" +
        (f"; {valid} valid triangles, {atomics} nonzero words (atomics)"
         if name == "block_scatter_or" else ""))

  words = grids.reshape(grids.shape[:-1] + (m, nw))
  labels = batch["mesh_labels"]

  def slot_or_phased():
    masked = torch.where((labels > 0)[:, :, None, None, None], words, 0)
    return phased.phased_gt((masked[:, 0] | masked[:, 1]).contiguous(), 2)

  split = {"phase_a_ms": device_ms(torch, phase_a, reps=3, trials=5),
           "scatter_ms": k3["ms"],
           "fill_ms": device_ms(torch, lambda: packed_mod.fill_inside_packed(
               words, fill_rounds=rounds), reps=3, trials=5),
           "fill_rounds": rounds,
           "slot_or_phased_gt_ms": device_ms(torch, slot_or_phased)}
  split["sum_ms"] = (split["phase_a_ms"] + split["scatter_ms"] +
                     split["fill_ms"] + split["slot_or_phased_gt_ms"])
  log("GT device time per step (CUDA graphs): " + ", ".join(
      f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
      for k, v in split.items()))
  return k3, k4, split


def train_gt_h7(torch, mods, CoreNet, config, image, camera, dev):
  """Phase 6: h7 training on ground truth voxelized in the step, with the
  phase loss. Returns the launches of the first step (skip_gather, its
  backward, fgbg_sums, block_scatter_or, phased_gt), the K3 and K4 rows,
  the GT split and the median step time in ms."""
  from corenet_tpu_torch.train import gt
  from corenet_tpu_torch.train.state import create_train_state
  from corenet_tpu_torch.train.step import make_train_step
  from corenet_tpu_torch.voxel import packed as packed_mod
  op, fgbg, scatter, phased = mods
  host, counts = triangle_batch(torch, image, camera, SEED + 41)
  batch = {k: v.to(dev) for k, v in host.items()}
  log(f"h7 train-gt: (cube, sphere) triangles per scene {counts}, padded "
      f"to {GT_TRIANGLES}; slot 1 label 0 in scene {BATCH - 1}")
  model, _ = seeded_model(torch, CoreNet, config, SEED + 40,
                          phase_output=True)
  state = create_train_state(model, device=dev)
  step = make_train_step(state.model, state.optimizer, "FG_BG", OUTPUT_RES,
                         voxelization_kwargs=H7_VOX)

  # The first step, counted, with its phased labels caught on the way.
  caught = []
  kernel_phased = phased.phased_gt_forward

  def catch(packed, s):
    caught.append(kernel_phased(packed, s))
    return caught[-1]

  phased.phased_gt_forward = catch
  torch.cuda.synchronize()
  zero_counts(*mods)
  rounds0 = packed_mod.round_count
  start = time.perf_counter()
  try:
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
  finally:
    phased.phased_gt_forward = kernel_phased
  first_s = time.perf_counter() - start
  launches = launch_counts(*mods)
  rounds = packed_mod.round_count - rounds0
  if launches != (4, 4, 1, 1, 1):
    raise AssertionError(f"h7 train-gt step launched (skip_gather, its "
                         f"backward, fgbg_sums, block_scatter_or, phased_gt) "
                         f"{launches} times, expected (4, 4, 1, 1, 1)")
  first_loss = float(metrics["loss"])
  bad = [n for n, p in state.model.named_parameters()
         if p.grad is None or not bool(torch.isfinite(p.grad).all())]
  if not math.isfinite(first_loss) or bad:
    raise AssertionError(f"h7 train-gt: loss {first_loss}, non-finite or "
                         f"missing gradients {bad[:5]}")
  log(f"h7 train-gt: first step {first_s:.3f} s, loss {first_loss:.6f}, "
      f"launches (skip_gather, backward, fgbg_sums, block_scatter_or, "
      f"phased_gt) {launches}, {rounds} fill rounds, loss and all "
      "gradients finite")

  # The step's GT against the plain path on the card and the CPU's.
  args = [batch[k] for k in GT_KEYS]
  packed_or, v2x = gt.voxelize_batch_packed_fgbg(*args, resolution=OUTPUT_RES,
                                                 **H7_VOX)
  with plain_versions(scatter, phased):
    counted = launch_counts(scatter, phased)
    plain_or, _ = gt.voxelize_batch_packed_fgbg(*args,
                                                resolution=OUTPUT_RES,
                                                **H7_VOX)
    plain_phased = phased.phased_gt(plain_or, 2)
    if launch_counts(scatter, phased) != counted:
      raise AssertionError("the plain GT path launched a kernel")
  torch.cuda.synchronize()
  if not (torch.equal(caught[0], plain_phased)
          and torch.equal(packed_or, plain_or)):
    raise AssertionError("the step's phased GT differs from the plain "
                         "scatter + fill + unpack + permute")
  share = float(plain_phased.float().mean())
  start = time.perf_counter()
  cpu_or, _ = gt.voxelize_batch_packed_fgbg(
      *(host[k][GT_CPU_SCENES] for k in GT_KEYS), resolution=OUTPUT_RES,
      **H7_VOX)
  cpu_s = time.perf_counter() - start
  differ = int((cpu_or ^ packed_or[GT_CPU_SCENES].cpu()).ne(0).sum())
  if differ:
    raise AssertionError(f"{differ} packed words of scenes {GT_CPU_SCENES} "
                         "differ between the card and the CPU")
  log(f"h7 train-gt: the step's phased GT {list(caught[0].shape)} uint8 "
      f"(foreground {share:.4f}) equals the plain scatter + fill + unpack + "
      f"permute on the card; the card's packed GT of scenes {GT_CPU_SCENES} "
      f"equals the CPU's bit for bit ({cpu_s:.1f} s on the CPU)")

  compare_with_plain_step(torch, mods, state, step, batch, "h7 train-gt")
  phase_loss_rel = compare_with_plain_loss(torch, CoreNet, config, state,
                                           step, batch, packed_or, v2x)

  losses = []
  for _ in range(LOSS_STEPS):
    state, metrics = step(state, batch)
    losses.append(float(metrics["loss"]))
  if not losses[-1] < first_loss:
    raise AssertionError(f"h7 train-gt: loss did not fall over {LOSS_STEPS} "
                         f"steps: {first_loss} then {losses}")
  log(f"h7 train-gt: loss {first_loss:.6f} at step 1, then " +
      ", ".join(f"{v:.6f}" for v in losses))

  k3, k4, split = gt_kernel_rows(torch, scatter, phased, batch, packed_or,
                                 rounds)
  gt_wall = []
  for _ in range(5):
    torch.cuda.synchronize()
    start = time.perf_counter()
    words, _ = gt.voxelize_batch_packed_fgbg(*args, resolution=OUTPUT_RES,
                                             **H7_VOX)
    phased.phased_gt(words, 2)
    torch.cuda.synchronize()
    gt_wall.append((time.perf_counter() - start) * 1e3)
  del words

  torch.cuda.reset_peak_memory_stats()
  times = []
  for _ in range(TRAIN_RUNS):
    start = time.perf_counter()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - start) * 1e3)
  mem = torch.cuda.max_memory_allocated()
  ms = statistics.median(times)
  holder = [state]

  def one_step():
    holder[0], _ = step(holder[0], batch)

  log_profile("h7 train-gt", device_profile(torch, one_step), ms,
              what="step")
  gt_ms = statistics.median(gt_wall)
  log(f"h7 train-gt: GT (voxelize + OR + phased_gt) {gt_ms:.3f} ms on the "
      f"host clock (median of 5), {split['sum_ms']:.3f} ms of device time "
      f"= {split['sum_ms'] / ms:.4f} of the step; phase loss vs plain loss "
      f"{phase_loss_rel:.2e} relative")
  log(f"h7 train-gt: over {TRAIN_RUNS} steps median {ms:.3f} ms (min "
      f"{min(times):.3f}, max {max(times):.3f}) per batch of {BATCH} = "
      f"{BATCH * 1e3 / ms:.2f} training scenes/s; first step {first_s:.3f} "
      f"s; peak memory {mem / 2**30:.2f} GiB")
  split.update(gt_wall_ms=gt_ms, step_ms=ms)
  return launches, k3, k4, split


def compare_with_plain_loss(torch, CoreNet, config, state, step, batch,
                            packed_or, v2x):
  """The phase-loss step's loss on the triangle batch against a model
  without phase_output (same weights and statistics) on the grid of the
  same GT: within 1e-6 relative (only the order of the sums differs).
  The state is restored after."""
  from corenet_tpu_torch.train.state import create_optimizer
  from corenet_tpu_torch.train.step import make_train_step
  from corenet_tpu_torch.voxel.packed import unpack_grid
  model, optimizer = state.model, state.optimizer
  snap_model = {k: v.clone() for k, v in model.state_dict().items()}
  snap_opt = copy.deepcopy(optimizer.state_dict())
  plain_model = CoreNet(config).to(batch["image"].device)
  plain_model.load_state_dict(snap_model)
  plain_step = make_train_step(
      plain_model, create_optimizer(plain_model.parameters()), "FG_BG",
      OUTPUT_RES)
  grid_batch = {"image": batch["image"], "camera": batch["camera"],
                "v2x": v2x, "grid_offset": batch["grid_offset"],
                "grid": unpack_grid(packed_or, dtype=torch.uint8)}
  torch.backends.cudnn.deterministic = True
  try:
    _, phase_metrics = step(state, batch)
    _, plain_metrics = plain_step(state, grid_batch)
  finally:
    torch.backends.cudnn.deterministic = False
    model.load_state_dict(snap_model)
    optimizer.load_state_dict(snap_opt)
  phase_loss = float(phase_metrics["loss"])
  plain_loss = float(plain_metrics["loss"])
  rel = abs(phase_loss - plain_loss) / abs(plain_loss)
  if rel > 1e-6:
    raise AssertionError(f"phase loss {phase_loss} and plain loss "
                         f"{plain_loss} differ by {rel} relative")
  log(f"h7 train-gt: the phase loss {phase_loss:.7f} equals the plain loss "
      f"{plain_loss:.7f} on the same GT ({rel:.2e} relative; tolerance "
      "1e-6)")
  return rel


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; the port's smoke run needs one",
          file=sys.stderr)
    return 1
  from corenet_tpu_torch import kernels
  from corenet_tpu_torch.eval.super_resolution import (
      SuperResolutionInference, super_resolution_from_model)
  from corenet_tpu_torch.models import skip
  from corenet_tpu_torch.models.corenet import (
      CoreNet, CoreNetConfig, DecoderConfig)
  from corenet_tpu_torch.ops import block_scatter as scatter
  from corenet_tpu_torch.ops import fgbg_loss as fgbg
  from corenet_tpu_torch.ops import phased_gt as phased
  from corenet_tpu_torch.ops import skip_gather as op
  from corenet_tpu_torch.train.step import compute_v2s

  dev = torch.device("cuda", 0)
  kind = torch.cuda.get_device_name(0)
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, timeout=60, check=True
  ).stdout.strip().splitlines()[0]
  log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  log("float32 path: TF32 off for cuDNN convolutions and CUDA matmuls")

  # 1. Build.
  start = time.perf_counter()
  kernels.build_all()
  names = ", ".join(kernels.SOURCES)
  log(f"build: {len(kernels.SOURCES)} kernel sources ({names}) in "
      f"{time.perf_counter() - start:.1f} s")

  camera, v2x = camera_and_v2x(torch, OUTPUT_RES[0])
  offsets = torch.full((BATCH, 3), 0.5)
  image = torch.randint(0, 256, (BATCH, IMAGE_HW, IMAGE_HW, 3),
                        dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(SEED))
  args = (image, camera, v2x, offsets, OUTPUT_RES)

  # 2. Kernels, at the shapes each serving path gives them and with the
  # indices it computes for this camera: h7 decodes batch 4 at 128³; y1
  # scales v2x by 1/m and decodes its m³ = 64 offsets × batch 4, offset
  # major, as one batch of 256 at 32³.
  m = OUTPUT_RES[0] // Y1_NATIVE[0]
  y1_offsets = SuperResolutionInference(
      None, Y1_NATIVE, dev).get_native_offsets(OUTPUT_RES, offsets.to(dev))
  k = y1_offsets.shape[0]
  y1_v2s = compute_v2s(camera.to(dev), v2x.to(dev) * torch.tensor(
      [1 / m, 1 / m, 1 / m, 1.0], device=dev))
  paths = {"h7": (compute_v2s(camera.to(dev), v2x.to(dev)), offsets.to(dev),
                  OUTPUT_RES[0]),
           "y1": (y1_v2s.repeat(k, 1, 1), y1_offsets.reshape(k * BATCH, 3),
                  Y1_NATIVE[0])}
  gen = torch.Generator().manual_seed(SEED + 2)
  shapes = []
  max_err = 0.0
  for path, (v2s, sample, res) in paths.items():
    b = v2s.shape[0]
    bidx = torch.arange(b, device=dev)[:, None]
    for stage, (div, h2, c) in SKIPS.items():
      layer = res // div
      matrix = v2s * torch.tensor([div, div, div, 1.0], device=dev)
      px, py = skip.voxel_pixel_indices(matrix, sample, (layer,) * 3,
                                        h2 - 2, h2 - 2)
      n = px.shape[1]
      # The gather must read each distinct pixel its indices name once.
      rows = int(torch.unique(bidx * h2 * h2 + py * h2 + px).numel())
      for dtype in (torch.float32, torch.bfloat16):
        fmap = torch.randn((b, h2, h2, c), generator=gen).to(dev, dtype)
        out = op.skip_gather(fmap, px, py)
        ref = op.skip_gather_reference(fmap, px, py)
        lib = fmap[bidx, py, px]
        torch.cuda.synchronize()
        if not (torch.equal(out, ref) and torch.equal(lib, ref)):
          raise AssertionError(f"skip_gather differs from its plain version "
                               f"on the {path} path, stage {stage} {dtype}")
        max_err = max(max_err, float((out.float() - ref.float()).abs().max()))
        es = fmap.element_size()
        nbytes = b * n * (c * es + 8) + rows * c * es
        row = {
            "path": path, "stage": stage,
            "dtype": str(dtype).replace("torch.", ""),
            "fmap": [b, h2, h2, c], "n": n, "rows_read": rows,
            "bytes": nbytes,
            "ms": device_ms(torch, lambda: op.skip_gather(fmap, px, py)),
            "plain_ms": device_ms(
                torch, lambda: op.skip_gather_reference(fmap, px, py)),
            "library_ms": device_ms(torch, lambda: fmap[bidx, py, px]),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        }
        shapes.append(row)
        log(f"skip_gather {path} stage {stage} {row['dtype']:8s} "
            f"[{b},{h2},{h2},{c}] N={n}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({nbytes} B)")
  # h7 training runs the serving camera at batch 4: the h7 indices.
  bwd_rows = skip_backward_rows(torch, op, *paths["h7"], gen)
  loss_rows = fgbg_rows(torch, fgbg, dev, gen)
  del fmap, out, ref, lib, paths
  per_forward = {
      path: {key: sum(row[key] for row in shapes
                      if row["path"] == path and row["dtype"] == "float32")
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
      for path in ("h7", "y1")}
  for path, sums in per_forward.items():
    log(f"skip_gather per {path} forward (float32, 4 launches): " +
        ", ".join(f"{key} {value:.4f}" for key, value in sums.items()))

  # 3. Serving, h7.
  h7, h7_state = seeded_model(
      torch, CoreNet, CoreNetConfig(DecoderConfig(OUTPUT_RES, 2)), SEED)
  infer = super_resolution_from_model(h7, h7_state, OUTPUT_RES, device="cuda")
  main_launches, h7_ms = serve(torch, op, "h7", infer, args,
                               (BATCH,) + OUTPUT_RES + (2,))
  check_plain_skips(torch, op, fgbg, "h7", h7, infer, args)
  del h7, infer
  torch.cuda.empty_cache()

  # 4. y1: 32³ native → 128³, 64 passes folded into one decode.
  y1_config = CoreNetConfig(DecoderConfig(Y1_NATIVE, 2))
  y1, y1_state = seeded_model(torch, CoreNet, y1_config, SEED + 10)
  infer = super_resolution_from_model(y1, y1_state, Y1_NATIVE, device="cuda")
  _, y1_ms = serve(torch, op, "y1", infer, args,
                     (BATCH,) + OUTPUT_RES + (2,))
  check_plain_skips(torch, op, fgbg, "y1", y1, infer, args)
  pmf = infer(*args)

  sequential = super_resolution_from_model(y1, y1_state, Y1_NATIVE,
                                           batch_offsets=False,
                                           device="cuda")
  op.launch_count = 0
  start = time.perf_counter()
  pmf_seq = sequential(*args)
  torch.cuda.synchronize()
  seq_s = time.perf_counter() - start
  if op.launch_count != 4 * 64:
    raise AssertionError(f"y1 sequential passes launched skip_gather "
                         f"{op.launch_count} times, expected 256")
  seq_diff = float((pmf - pmf_seq).abs().max())
  # Convolution algorithms depend on the batch shape; both are float32.
  if seq_diff > 1e-4:
    raise AssertionError(f"y1 batched and sequential PMFs differ by "
                         f"{seq_diff}")
  log(f"y1: 64 sequential passes {seq_s * 1e3:.2f} ms (256 skip_gather "
      f"launches), max PMF difference from the batched passes "
      f"{seq_diff:.2e}")
  del pmf, pmf_seq, infer, sequential

  # The card's logits against the port's CPU logits on a small input: the
  # CPU path is the one tests/test_torch_model.py holds against JAX.
  small_image = image[:2, :64, :64].contiguous()
  small_v2s = y1_v2s[:2].cpu()
  small_off = offsets[:2]
  cpu_model = CoreNet(y1_config)
  cpu_model.load_state_dict(y1_state)
  with torch.inference_mode():
    ref = cpu_model.eval()(small_image, small_v2s, small_off)
    got = y1(small_image.to(dev), small_v2s.to(dev), small_off.to(dev)).cpu()
  scale = float(ref.abs().max())
  cpu_diff = float((got - ref).abs().max())
  if not torch.allclose(got, ref, rtol=2e-3, atol=2e-3 * scale):
    raise AssertionError(f"card and CPU logits differ by {cpu_diff} "
                         f"(max |logit| {scale})")
  log(f"y1 logits on the card match the CPU within {cpu_diff:.2e} "
      f"(max |logit| {scale:.4f}; tolerance 2e-3 relative)")
  del y1, y1_state, cpu_model, ref, got
  torch.cuda.empty_cache()

  # 5. Training, h7, then a small step on the card against the CPU.
  train_launches, train_ms = train_h7(
      torch, op, fgbg, CoreNet, CoreNetConfig(DecoderConfig(OUTPUT_RES, 2)),
      image, camera, v2x, offsets, dev)
  torch.cuda.empty_cache()
  train_card_against_cpu(torch, CoreNet, CoreNetConfig, DecoderConfig,
                         image, camera, offsets, dev)
  torch.cuda.empty_cache()

  # 6. Training on ground truth voxelized in the step, phase loss, h7.
  gt_launches, k3_row, k4_row, gt_split = train_gt_h7(
      torch, (op, fgbg, scatter, phased), CoreNet,
      CoreNetConfig(DecoderConfig(OUTPUT_RES, 2)), image, camera, dev)

  h7_sums = per_forward["h7"]
  entry = {
      "name": "skip_gather",
      "route": "cuda",
      "source": "corenet_tpu_torch/csrc/skip_gather.cu",
      "replaces": "corenet_tpu/ops/skip_gather.py:128",
      "launches": main_launches,
      "max_abs_err": max_err,
      # Per h7 forward in float32: the sum over its four skips.
      "ms": h7_sums["ms"],
      "plain_ms": h7_sums["plain_ms"],
      "bound_ms": h7_sums["bound_ms"],
      "bound_by": "bytes",
      "library_ms": h7_sums["library_ms"],
      "library_call": "fmap[batch_index, py, px]",
      "timing": "device time per call, CUDA events around CUDA-graph "
                "replays of 20 calls, median of 7",
      "per_forward_float32": per_forward,
      "shapes": shapes,
  }
  bwd_f32 = [row for row in bwd_rows if row["dtype"] == "float32"]
  bwd_entry = {
      "name": "skip_gather_bwd",
      "route": "cuda",
      "source": "corenet_tpu_torch/csrc/skip_gather.cu",
      "replaces": "corenet_tpu/ops/skip_gather.py:139",
      "launches": train_launches[1],
      "max_abs_err": max(row["max_abs_err_vs_plain"] for row in bwd_rows),
      # Per h7 training step in float32: the sum over its four skips.
      **{key: sum(row[key] for row in bwd_f32)
         for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
      "bound_by": "bytes",
      "library_call": "torch.zeros(...).index_add_(0, flat_index, dout)",
      "timing": entry["timing"],
      "ms_pad_moved_inwards": sum(row["ms_pad_moved_inwards"]
                                  for row in bwd_f32),
      "shapes": bwd_rows,
  }
  int32_row = loss_rows[0]
  fgbg_entry = {
      "name": "fgbg_sums",
      "route": "cuda",
      "source": "corenet_tpu_torch/csrc/fgbg_sums.cu",
      "replaces": "corenet_tpu/ops/fgbg_loss.py:62",
      "launches": train_launches[2],
      "max_abs_err": max(row["max_abs_err"] for row in loss_rows),
      # The h7 training step's call: f32 diff, int32 labels.
      **{key: int32_row[key]
         for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
      "bound_by": "bytes",
      "library_call": None,
      "timing": entry["timing"],
      "shapes": loss_rows,
  }
  gt_entries = [
      {"name": name, "route": "cuda",
       "source": f"corenet_tpu_torch/csrc/{source}.cu",
       "replaces": replaces, "launches": launches,
       **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms")},
       "bound_by": "bytes", "library_ms": None, "library_call": None,
       "timing": entry["timing"], "shapes": [row]}
      for name, source, replaces, launches, row in (
          ("block_scatter_or", "block_scatter",
           "corenet_tpu/ops/block_scatter.py:219", gt_launches[3], k3_row),
          ("phased_gt", "phased_gt", "corenet_tpu/ops/phased_gt.py:128",
           gt_launches[4], k4_row))]
  gt_entries[0]["gt_split"] = gt_split
  log(f"h7 scenes/s {BATCH * 1e3 / h7_ms:.3f}; y1 scenes/s "
      f"{BATCH * 1e3 / y1_ms:.3f} (median of {SERVE_RUNS} forwards); h7 "
      f"training scenes/s {BATCH * 1e3 / train_ms:.3f} on host GT, "
      f"{BATCH * 1e3 / gt_split['step_ms']:.3f} on GT voxelized in the step "
      f"(medians of {TRAIN_RUNS} steps)")
  log(smi)
  log(json.dumps({"kernels": [entry, bwd_entry, fgbg_entry] + gt_entries}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": kind,
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
