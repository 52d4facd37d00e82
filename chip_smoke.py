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
              (the h7 indices, batch 4), f32 and bf16, with dout in the
              step's layout (the channel slice of the decoder's
              concatenated gradient, as autograd hands it over) and
              contiguous, against the float64 scatter-add within
              1e-5 · Σ|dout| per cell (plus one bf16 ulp), with the run
              lengths along z and the kernel's flushes counted from the
              indices and the copy to contiguous timed; fgbg_sums at
              [4, 128³] with int32, uint8 and float32 labels, within 1e-6
              relative.
  3. serving  h7: 128³ output, 2 classes, batch 4, 256² images, random
              weights from a seed, through super_resolution_from_model
              (its default: the packed decoder, since slice 6).
              Checks the PMF (shape, finite, sums to 1), that each forward
              launched the skip kernel once per skip (4), and that the
              PMF equals that of the same forward with the plain skips.
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
              loss falls over 10 steps on the batch (the lowest at least
              5 % below the first: loss_steps), and that one step with
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
  7. eval     h7's full_eval through EvalPipeline.run_eval: a seeded
              dataset written to a temporary directory (a manifest of two
              classes, mesh NPZs of the cube shell and seeded spheres, 10
              scene NPZs with 256² images stored as uint8 arrays, one or
              two meshes per scene), the configuration built from a dict
              (128³, irm 8, no conservative rasterization, batch 4, 6
              worker processes, prefetch 2), the seeded h7 model through
              super_resolution_from_model: 3 batches, the last with 2
              valid scenes. Checks that the confusion matrix sums to
              10 · 128³, that each batch launched block_scatter_or once and
              skip_gather 4 times, the first batch's GT against the CPU's
              (two scenes, bit for bit), the confusion matrix with the
              kernels against the one with the plain versions, IoU exactly
              1 for present classes and NaN for absent ones when the
              inference function returns the one-hot GT, that the CSV
              parses back to the table, argmax on exact ties, and one more
              run as SEMANTIC (3 channels). Times the batches (host clock,
              each ended by the confusion matrix's copy to the host), their
              split into loader wait, GT, inference and metrics, and
              profiles one batch.
  8. train-y1 y1 training: 32³, FG_BG, sub-grid sampling at irm 31 (the
              general rasterizer, the dense fill, the sub-grid centres), a
              24-pixel window on triangles subdivided at 20 / 31 / 32,
              batch 4, random grid offsets, the phase loss on the labeled
              grid. Checks 4 + 4 + 1 launches (skip_gather, its backward,
              fgbg_sums), the labeled grid against the CPU's (two scenes,
              bit for bit), finite loss and gradients, a falling loss, the
              kernel step against the plain step. Times the GT's parts
              (CUDA events around eager calls), 20 steps, and profiles one
              more. Then parity_voxelize_batch at 128³ on the phase-6
              batch: card against CPU, its difference from raster + fill,
              its time.
  9. serve-cli serving from a checkpoint file, as a user serves: the
              seeded h7 model of phase 7 written through the port's
              CheckpointManager (a `.cpt` whose metadata holds a
              full_config with phase 7's eval, asking for 4 qualitative
              results, and the classes) and read back into a fresh CoreNet
              on the card (logits equal, torch.equal; the file's MB and the
              write and read seconds); `python -m corenet_tpu_torch.cli.eval`
              (its main) on phase 7's seeded dataset: the CSV parses, the
              mean IoU equals EvalPipeline.run_eval's on the same weights
              (deterministic cuDNN), K1 4 and K3 1 launches per batch,
              exactly 4 img_*.png tiles that decode to (1280, 1280, 3), the
              per-class IoU scalars in the summary JSONL; the time per tile
              (host clock: extraction on the host, rendering on the card,
              PNG) and a held eval batch with and without its 4 tiles; the
              renderers on the card against the CPU (the subdivided cube
              shell, a 128³ GT grid: L1 < 1.0, the share of differing
              pixels); the demo CLI on one scene (a (1280, 1280, 3) PNG).
  10. train-bf16 training with the models in bf16 (compute_dtype, the JAX
              pipeline's default; float32 parameters, statistics and
              gradients) through make_train_step: h7 on GT voxelized in
              the step with the phase loss (phase 6's batch), h7 on host
              GT (phase 5's), y1 on the general GT (phase 8's). Each: the
              first step's launches (K1 4 + 4 in bf16, K2 1, and K3 and K4
              1 each on the blocked branch), finite float32 gradients,
              the kernel step against the plain step (loss 1e-6 relative,
              the gradients by compare_with_plain_step's bf16 rule), a
              falling loss, 20 timed steps, peak memory, a profile with
              the share of cuDNN's dgrad and wgrad engines. One h7 row in float32 with TF32 on
              (for that row only). tests/test_learning.py's two-scene
              overfit at 32³ in bf16: the loss below a tenth of the first
              within 400 steps, foreground IoU > 0.8 per scene.
  11. train-cli `corenet_tpu_torch.cli.train.main` on phase 7's seeded
              dataset with configs/models/h7.json5's train configuration
              in bf16 (the packed decoder, decoder_execution "auto"; the
              recurrent eval fine), a fresh encoder and short intervals: 3
              steps, then
              a second call that resumes from the newest `.cpt` for one
              more. Checks the checkpoints' names and steps, the loss
              summaries, the recurrent eval (its CSV and scalars, the
              model back in train mode), and the launches of every step
              and of the eval's batches; logs the seconds per step and
              the eval's.
  12. packed  packed (space-to-depth) decoder execution, the JAX package's
              default, against the fine decoder. Serving, float32: h7 and
              y1 (as phases 3–4), the packed eval-mode logits within
              1e-5 · max|logit| of the fine ones, then for each
              execution 30 timed forwards, peak memory, a profile (idle
              share, convolution shares).
              Training on GT voxelized in the step with the phase loss
              (phase 6's batch), bf16 and float32, each execution: the
              first step's launches (K1 4 + 4, K2 1, K3 1, K4 1; K4 at
              s = 4 and one backward in packed voxel order for the packed
              decoder, whose factor-64 logits the loss takes); packed, the
              kernel step against the plain step (phase 5's and 10's
              rules), the phase loss against the plain loss on the
              unpacked logits (1e-6) and a falling loss; 20 timed steps and
              a profile. K1's backward in packed voxel order at skip 5
              (the packed step's gradient layout, no copy) and K4 at s = 4
              against their plain versions, timed. The train CLI with
              --decoder_execution=packed (4 steps, launches, K4 at s = 4)
              and the eval CLI with --packed_inference against
              --nopacked_inference (mean IoU within 1e-3).

The float32 phases compute in float32: TF32 is switched off for
convolutions and matmuls (phase 10 switches it on for its one TF32 row),
so the float32 path computes in float32 on the card as on the CPU.

Prints the card's name and power limit as nvidia-smi gives them, one JSON
line of kernel figures, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it prints no result and exits with status 1.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
BATCH = 4
IMAGE_HW = 256
OUTPUT_RES = (128, 128, 128)
Y1_NATIVE = (32, 32, 32)
SERVE_RUNS = 30
TRAIN_RUNS = 20
LOSS_STEPS = 10
LOSS_FALL = 0.05  # the lowest of those steps, relative to the first loss
TRAIN_SMALL = (32, 32, 32)  # the card-against-CPU step
# h7's voxelization (configs/models/h7.json5; fill rounds 0 = adaptive,
# the window of corenet_tpu/eval/pipeline.py:40), for two label values.
H7_VOX = dict(sub_grid_sampling=False, image_resolution_multiplier=8,
              conservative_rasterization=False,
              projection_depth_multiplier=1, max_bbox_pixels=24,
              fill_rounds=None, num_label_values=2)
# y1's training voxelization (configs/models/y1.json5), as TrainPipeline
# passes it to the step.
Y1_VOX = dict(sub_grid_sampling=True, image_resolution_multiplier=31,
              conservative_rasterization=False,
              projection_depth_multiplier=1, max_bbox_pixels=24,
              fill_rounds=None, num_label_values=2)
EVAL_SCENES = 10
EVAL_TIMING_PASSES = 4  # the timed eval reads the dataset this many times
# (class id, human-readable name) of the eval dataset's manifest.
EVAL_CLASSES = (("02958343", "cube"), ("03001627", "sphere"))
GT_TRIANGLES = 16384  # padded triangles per scene
GT_CPU_SCENES = [0, BATCH - 1]  # voxelized on the CPU too
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
# The decoder's skips: stage → (native resolution / layer resolution,
# padded map H2 = W2 at 256² images, channels).
SKIPS = {2: (16, 10, 96), 3: (8, 18, 48), 4: (4, 34, 24), 5: (2, 66, 12)}
# The tower's channels that the decoder concatenates before each skip's.
TOWER_CHANNELS = {2: 128, 3: 64, 4: 32, 5: 16}


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


def seeded_model(torch, CoreNet, config, seed, phase_output=False,
                 compute_dtype=None, **execution):
  """A CPU CoreNet with the port's seeded init and random BatchRenorm
  running statistics (mean ~ N(0, 0.3), var ~ U(0.5, 2)), and a CPU copy
  of its state_dict. `execution` (packed_decoder, pack_from_stage) goes
  to CoreNet: it changes no weight."""
  model = CoreNet(config, phase_output=phase_output,
                  compute_dtype=compute_dtype, **execution)
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
          "top": [(n, t / 1e3) for n, t in top],
          "conv_shares": conv_shares(by_name)}


def conv_shares(by_name):
  """The shares of the kernels' summed device time that cuDNN's dgrad and
  wgrad engines (names with `dgrad` / `wgrad`) and the other convolution
  kernels (`conv`, `fprop`, `implicit`, `xmma`) take."""
  total = sum(by_name.values()) or 1.0
  shares = {"dgrad": 0.0, "wgrad": 0.0, "other_conv": 0.0}
  for name, us in by_name.items():
    low = name.lower()
    if "dgrad" in low:
      shares["dgrad"] += us / total
    elif "wgrad" in low:
      shares["wgrad"] += us / total
    elif any(k in low for k in ("conv", "fprop", "implicit", "xmma")):
      shares["other_conv"] += us / total
  return shares


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
  first forward and the figures: median (min, max) ms per forward,
  scenes/s, peak memory, busy time, idle share, convolution shares."""
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
  profile = device_profile(torch, lambda: infer(*args))
  log_profile(label, profile, ms)
  row = {"median_ms": ms, "min_ms": min(times), "max_ms": max(times),
         "scenes_per_s": BATCH * 1e3 / ms, "peak_gib": mem / 2 ** 30,
         "busy_ms": profile["busy_ms"] if profile else None,
         "idle_share": 1 - profile["busy_ms"] / ms if profile else None,
         "conv_shares": profile["conv_shares"] if profile else None}
  log(f"{label} serve: PMF {list(shape)}, |sum - 1| <= {sum_err:.2e}, "
      f"skip_gather launches {launches} per forward; first forward "
      f"{first_s:.3f} s, then over {SERVE_RUNS} forwards median "
      f"{ms:.3f} ms (min {min(times):.3f}, max {max(times):.3f}) per batch "
      f"of {BATCH} = {BATCH * 1e3 / ms:.2f} scenes/s, peak memory "
      f"{mem / 2**30:.2f} GiB; share of the kernels' device time: " +
      (", ".join(f"{k} {v:.3f}" for k, v in row["conv_shares"].items())
       if profile else "not measured"))
  return launches, row


def check_plain_skips(torch, op, fgbg, label, infer, args):
  """The path's PMF with the kernel and with the plain skips:
  bit-identical, since the gather is a copy. cuDNN is held to
  deterministic algorithms for both so that no convolution sums in a
  run-dependent order."""
  torch.backends.cudnn.deterministic = True
  try:
    kernel = infer(*args)
    with plain_versions(op, fgbg):
      plain = infer(*args)
  finally:
    torch.backends.cudnn.deterministic = False
  if not torch.equal(kernel, plain):
    diff = float((kernel - plain).abs().max())
    raise AssertionError(f"{label} PMF with the kernel differs from the "
                         f"plain skips' by {diff}")
  log(f"{label} PMF {list(kernel.shape)} with the kernel equals the one with "
      f"the plain skips (max {float(kernel.max()):.4f})")


def bf16_ulp(torch, x):
  """The spacing of bfloat16 numbers at |x| (its smallest normal's at 0)."""
  mag = x.abs().to(torch.bfloat16).double().clamp(min=2.0 ** -126)
  return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def column_runs(torch, op, px, py, h2, grid, c):
  """From the indices: the mean run of equal pixels along z in a depth
  column, the backward kernel's chunk along z, and its flushes (vector
  atomics): one per run, a run also ending where a chunk ends, for each
  group of channels."""
  b = px.shape[0]
  depth, cols = op.columns(px.shape[1], grid)
  pixel = (py * h2 + px).reshape(b, depth, cols)
  starts = torch.ones_like(pixel, dtype=torch.bool)
  starts[:, 1:] = pixel[:, 1:] != pixel[:, :-1]
  groups = c // op.channel_vector(c)
  chunk = op.z_chunk(depth)
  mean_run = pixel.numel() / int(starts.sum())
  starts[:, ::chunk] = True
  return mean_run, chunk, int(starts.sum()) * groups


def skip_backward_rows(torch, op, v2s, sample, res, gen):
  """skip_gather's backward at h7 training's shapes (batch 4, the four
  skips, the path's own indices), f32 and bf16, in two layouts of dout:
  the step's (the skip's channel slice of the [B, C_tot, D, H, W]
  gradient of the decoder's concatenation, as autograd hands it over) and
  contiguous. The kernel in both and the plain version against the
  float64 scatter-add; their times, the time of the copy to contiguous
  that the first version needed and of zeroing the accumulator; the run
  lengths and flushes from the indices."""
  from corenet_tpu_torch.models import skip
  dev = v2s.device
  b = v2s.shape[0]
  bidx = torch.arange(b, device=dev)[:, None]
  rows = []
  for stage, (div, h2, c) in SKIPS.items():
    layer = res // div
    grid = (layer,) * 3
    matrix = v2s * torch.tensor([div, div, div, 1.0], device=dev)
    px, py = skip.voxel_pixel_indices(matrix, sample, grid, h2 - 2, h2 - 2)
    n = px.shape[1]
    on_pad = (px == 0) | (px == h2 - 1) | (py == 0) | (py == h2 - 1)
    flat = (bidx * h2 * h2 + py.long() * h2 + px.long()).reshape(-1)
    per_pixel = torch.bincount(flat, minlength=b * h2 * h2)
    mean_run, chunk, flushes = column_runs(torch, op, px, py, h2, grid, c)
    cx = TOWER_CHANNELS[stage]
    for dtype in (torch.float32, torch.bfloat16):
      dout = torch.randn((b, n, c), generator=gen).to(dev, dtype)
      cat_grad = torch.zeros((b, cx + c) + grid, device=dev, dtype=dtype)
      cat_grad[:, cx:] = dout.reshape((b,) + grid + (c,)).permute(
          0, 4, 1, 2, 3)
      step = cat_grad[:, cx:].permute(0, 2, 3, 4, 1).reshape(b, n, c)
      if step.stride() != ((cx + c) * n, 1, n):
        raise AssertionError(f"the step's layout has strides {step.stride()}")
      got = op.skip_gather_backward(step, px, py, h2, h2,
                                    grid_resolution=grid)
      got_contiguous = op.skip_gather_backward(dout, px, py, h2, h2,
                                               grid_resolution=grid)
      plain = op.skip_gather_backward_reference(dout, px, py, h2, h2)
      ref64 = op.skip_gather_backward_reference(dout.double(), px, py, h2, h2)
      mass = op.skip_gather_backward_reference(dout.double().abs(), px, py,
                                               h2, h2)
      torch.cuda.synchronize()
      bound = 1e-5 * mass + 1e-30
      if dtype == torch.bfloat16:
        bound = bound + bf16_ulp(torch, ref64)
      for what, out in (("kernel, step's layout", got),
                        ("kernel, contiguous", got_contiguous),
                        ("plain version", plain)):
        excess = float(((out.double() - ref64).abs() - bound).max())
        if excess > 0:
          raise AssertionError(f"skip_gather backward ({what}) exceeds its "
                               f"bound by {excess} at stage {stage} {dtype}")
      es = dout.element_size()
      nbytes = b * n * (c * es + 8) + b * h2 * h2 * c * es
      dout2d = dout.reshape(b * n, c)

      def kernel(d=step):
        return op.skip_gather_backward(d, px, py, h2, h2,
                                       grid_resolution=grid)

      row = {
          "stage": stage, "dtype": str(dtype).replace("torch.", ""),
          "dfmap": [b, h2, h2, c], "n": n, "grid": list(grid),
          "dout_strides": list(step.stride()), "bytes": nbytes,
          "voxels_on_pad_share": float(on_pad.float().mean()),
          "max_voxels_per_pixel": int(per_pixel.max()),
          "mean_run_along_z": mean_run, "z_chunk": chunk,
          "flushes": flushes,
          "atomics_first_version": b * n * c // op.channel_vector(c),
          "max_abs_err_vs_plain": max(
              float((out.float() - plain.float()).abs().max())
              for out in (got, got_contiguous)),
          "ms": device_ms(torch, kernel),
          "ms_contiguous": device_ms(torch, lambda: kernel(d=dout)),
          "copy_ms": device_ms(torch, step.contiguous),
          # The zeroed f32 accumulator every launch starts from: with the
          # launch itself, the floor of the small skips.
          "zero_ms": device_ms(torch, lambda: torch.zeros(
              (b, h2, h2, c), device=dev)),
          "plain_ms": device_ms(
              torch, lambda: op.skip_gather_backward_reference(
                  dout, px, py, h2, h2)),
          # One PyTorch call of the same function: index_add_ into a zeroed
          # buffer of dout's dtype (in bf16 it also accumulates in bf16).
          "library_ms": device_ms(
              torch, lambda: torch.zeros(
                  (b * h2 * h2, c), device=dev, dtype=dtype).index_add_(
                      0, flat, dout2d)),
          "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
      }
      rows.append(row)
      lib = ("none" if row["library_ms"] is None
             else f"{row['library_ms']:.4f} ms")
      log(f"skip_gather backward stage {stage} {row['dtype']:8s} "
          f"[{b},{h2},{h2},{c}] N={n}: kernel {row['ms']:.4f} ms in the "
          f"step's layout (contiguous {row['ms_contiguous']:.4f}), copy to "
          f"contiguous "
          f"{row['copy_ms']:.4f} ms, zeroing the accumulator "
          f"{row['zero_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
          f"{lib}, bound {row['bound_ms']:.4f} ms ({nbytes} B); mean run "
          f"along z {mean_run:.3f}, z chunk {chunk}, flushes {flushes} "
          f"(first version {row['atomics_first_version']} atomics); voxels "
          f"on the pad {row['voxels_on_pad_share']:.4f}, max voxels per "
          f"pixel {row['max_voxels_per_pixel']}")
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
      fn = getattr(module, plain)
      if name == "skip_gather_backward":
        # index_add_ takes the voxels in any order: it needs no grid.
        fn = lambda *args, grid_resolution, plain_fn=fn: plain_fn(*args)
      setattr(module, name, fn)
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


def compare_with_plain_step(torch, modules, state, step, batch, label,
                            bf16=False):
  """One step with the kernels and the same step, from the same state,
  with the plain versions: loss within 1e-6 relative. cuDNN is held to
  deterministic algorithms, so the forward is the same bit for bit and
  only the order of summation differs. In float32 every gradient that
  carries mass lies within 1e-4 relative L2. In bf16 (`bf16`) the loss's
  sums (the kernel's float64 partials, the plain version's float32) part
  in the last float32 bits, and the backward's bf16 roundings turn that
  into ulp flips that BatchRenorm's backward carries on: all gradients
  together lie within BF16_GRADS_TOL relative L2, and each points the
  same way (cosine ≥ BF16_COSINE). The state is restored after. Returns
  (loss's relative difference, worst gradient's, all gradients')."""
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
  cosine, cosine_name = 1.0, None
  diff_sq = norm_sq = 0.0
  for name, gp in grads_p.items():
    if feeds_batch_renorm(name):
      continue
    gk = grads_k[name]
    rel = float((gk - gp).norm() / gp.norm())
    cos = float((gk * gp).sum() / (gk.norm() * gp.norm()))
    diff_sq += float((gk - gp).norm()) ** 2
    norm_sq += float(gp.norm()) ** 2
    checked += 1
    if not math.isfinite(rel) or rel > worst:
      worst, worst_name = rel, name
    if not math.isfinite(cos) or cos < cosine:
      cosine, cosine_name = cos, name
  together = math.sqrt(diff_sq / norm_sq)
  if bf16:
    if not (together <= BF16_GRADS_TOL and cosine >= BF16_COSINE):
      raise AssertionError(
          f"{label}: the kernel step's gradients differ from the plain "
          f"step's by {together} relative L2 together (tolerance "
          f"{BF16_GRADS_TOL}), lowest cosine {cosine} ({cosine_name}; at "
          f"least {BF16_COSINE})")
  elif not worst <= 1e-4:
    raise AssertionError(f"gradient {worst_name} of the kernel step differs "
                         f"from the plain step's by {worst} relative L2")
  log(f"{label}: the step with the kernels matches the step with the plain "
      f"versions: loss {loss_k:.7f} vs {loss_p:.7f} ({loss_rel:.2e} "
      f"relative), all {checked} gradients together {together:.2e} "
      f"relative L2, worst {worst:.2e} ({worst_name}), lowest cosine "
      f"{cosine:.6f} ({cosine_name})")
  return loss_rel, worst, together


def loss_steps(state, step, batch, first_loss, label):
  """LOSS_STEPS more steps on the same batch; the loss must fall: the
  lowest of them lies at least LOSS_FALL below the first step's. The last
  step alone is no fair witness. The trajectories part after a few steps
  from run to run (cuDNN picks its algorithms per process and the
  backward's atomics sum in any order), and single steps of Adam on
  BatchRenorm in training mode jump back up: one run in four on an H100
  ended a step above its first loss after reaching 0.78 from 0.93.
  Returns the state."""
  losses = []
  for _ in range(LOSS_STEPS):
    state, metrics = step(state, batch)
    losses.append(float(metrics["loss"]))
  if not min(losses) < first_loss * (1.0 - LOSS_FALL):
    raise AssertionError(f"{label}: loss did not fall by {LOSS_FALL:.0%} "
                         f"over {LOSS_STEPS} steps: {first_loss} then "
                         f"{losses}")
  log(f"{label}: loss {first_loss:.6f} at step 1, then " +
      ", ".join(f"{v:.6f}" for v in losses) +
      f"; lowest {min(losses):.6f} = {1.0 - min(losses) / first_loss:.1%} "
      f"below the first (at least {LOSS_FALL:.0%} asked)")
  return state


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

  state = loss_steps(state, step, batch, first_loss, "h7 train")
  _, timed = timed_training(torch, "h7 train", step, state, batch)
  return launches, timed["median_ms"]


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


def triangle_batch(torch, image, camera, seed, irm=8, res=OUTPUT_RES[0]):
  """A training batch of triangles on the host (phase 6's; phase 8's with
  y1's irm and resolution): per scene the subdivided cube shell (slot 0)
  moved by a seeded offset of at most 0.05 per axis, and a seeded sphere
  of radius 0.09 near a corner (slot 1, label 0 in the last scene),
  padded to GT_TRIANGLES; the serving images and cameras."""
  import numpy as np
  from corenet_tpu_torch.data.batching import (
      VOXELIZE_WINDOW_PIXELS, subdivide_triangles)
  rng = np.random.default_rng(seed)
  max_edge = (VOXELIZE_WINDOW_PIXELS - 4) / irm / res
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

  state = loss_steps(state, step, batch, first_loss, "h7 train-gt")

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

  _, timed = timed_training(torch, "h7 train-gt", step, state, batch)
  ms = timed["median_ms"]
  gt_ms = statistics.median(gt_wall)
  log(f"h7 train-gt: GT (voxelize + OR + phased_gt) {gt_ms:.3f} ms on the "
      f"host clock (median of 5), {split['sum_ms']:.3f} ms of device time "
      f"= {split['sum_ms'] / ms:.4f} of the step; phase loss vs plain loss "
      f"{phase_loss_rel:.2e} relative")
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


def event_ms(torch, fn, reps=3):
  """Device-timeline time per call: CUDA events around `reps` eager calls
  after one warm-up. Unlike device_ms it takes no CUDA graph, so it also
  times code that copies from the host; launch gaps count."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / reps


def write_eval_dataset(root, seed):
  """A seeded dataset in the on-disk format of corenet_tpu_torch/data:
  mesh NPZs (the cube shell, a small sphere near a corner and a big one
  at the centre), EVAL_SCENES scene NPZs (the cube alone or with a sphere, each moved by
  at most 0.05 per axis; 256² images stored as uint8 arrays inside 0-d
  object arrays, so that no image codec is needed; the serving cameras)
  and the manifest. Returns (manifest path, meshes dir)."""
  import numpy as np
  rng = np.random.default_rng(seed)
  (cube_id, _), (sphere_id, _) = EVAL_CLASSES
  meshes = {
      (cube_id, "shell"): cube_shell(),
      (sphere_id, "small"): sphere_mesh(rng, np.array([0.15, 0.15, 0.86]),
                                        0.09),
      (sphere_id, "big"): sphere_mesh(rng, np.array([0.5, 0.5, 0.5]), 0.22),
  }
  meshes_dir = os.path.join(root, "meshes")
  for (label, name), vertices in meshes.items():
    os.makedirs(os.path.join(meshes_dir, label), exist_ok=True)
    np.savez(os.path.join(meshes_dir, label, name + ".npz"),
             vertices=vertices)
  # The cube comes first in every scene: FG_BG labels a scene by its first
  # mesh, so the sphere class is absent there (NaN) and present as SEMANTIC.
  layouts = ([(cube_id, "shell"), (sphere_id, "small")],
             [(cube_id, "shell"), (sphere_id, "big")], [(cube_id, "shell")])
  near, far = 0.5, 3.0
  a = (far + near) / (far - near)
  b = -2 * far * near / (far - near)

  def boxed(image):
    box = np.empty((), dtype=object)
    box[()] = image
    return box

  files = []
  for i in range(EVAL_SCENES):
    layout = layouts[i % len(layouts)]
    o2w = np.tile(np.eye(4, dtype=np.float32), (len(layout), 1, 1))
    o2w[:, :3, 3] = rng.uniform(-0.05, 0.05, (len(layout), 3))
    f = 1.8 + 0.1 * (i % BATCH)
    image = rng.integers(0, 256, (IMAGE_HW, IMAGE_HW, 3), dtype=np.uint8)
    files.append(f"scene_{i:03d}.npz")
    np.savez(
        os.path.join(root, files[-1]),
        mesh_labels=np.array([label for label, _ in layout]),
        mesh_filenames=np.array([name for _, name in layout]),
        view_transform=np.eye(4, dtype=np.float32),
        mesh_object_to_world_transforms=o2w,
        camera_transform=np.array(
            [[f, 0, 0, -0.5 * f], [0, f, 0, -0.5 * f], [0, 0, a, a + b],
             [0, 0, 1, 1.0]], np.float32),
        mesh_visible_fractions=np.ones(len(layout), np.float32),
        opengl_image=boxed(image), pbrt_image=boxed(image))
  manifest = os.path.join(root, "dataset.json")
  with open(manifest, "w") as out:
    json.dump({"classes": [{"id": cid, "human_readable": name}
                           for cid, name in EVAL_CLASSES],
               "files": files}, out)
  return manifest, meshes_dir


def h7_eval_config(manifest, meshes_dir, task_type, passes=1):
  """h7's full_eval (configs/models/h7.json5:201-236) as plain data, on
  the seeded dataset, listed `passes` times."""
  return {
      "name": "full_eval",
      "data": {
          "datasets": [{"dataset_path": manifest, "meshes_dir": meshes_dir,
                        "high_realism": True, "shuffle": "ONCE",
                        "data_fraction": 1.0}] * passes,
          "shuffle": "ONCE",
          "data_loader": {"num_data_workers": 6, "batch_size": BATCH,
                          "prefetch_factor": 2, "worker_processes": True},
          "voxelization_config": {
              "task_type": task_type,
              "resolution": dict(zip(("depth", "height", "width"),
                                     OUTPUT_RES)),
              "sub_grid_sampling": False,
              "conservative_rasterization": False,
              "voxelization_image_resolution_multiplier": 8,
              "voxelization_projection_depth_multiplier": 1,
              "voxelization_fill_rounds": 0}},
      "num_qualitative_results": 500,
      "num_qualitative_results_in_tensor_board": 0}


class EvalProbe:
  """Watches one EvalPipeline.run_eval from outside: keeps the run's
  QuantitativeResults, the time each batch ended (add_batch ends with the
  confusion matrix's copy to the host, which waits for the device) and,
  with `split`, the host-clock time of each batch's GT, inference and
  metrics, each between two synchronizes, the GT's inputs and grids."""

  def __init__(self, torch, pipeline, results_mod, split=False):
    self.torch, self.pipeline, self.results_mod = torch, pipeline, results_mod
    self.split = split
    self.spans = []   # (part, start, end) on the host clock
    self.gt_args, self.grids = [], []
    self.results = None

  def _timed(self, part, fn):
    def wrapper(*args, **kwargs):
      if self.split:
        self.torch.cuda.synchronize()
      start = time.perf_counter()
      out = fn(*args, **kwargs)
      if self.split:
        self.torch.cuda.synchronize()
      self.spans.append((part, start, time.perf_counter()))
      return out
    return wrapper

  def run(self, global_step=0):
    """run_eval under the probe → (mean IoU, seconds)."""
    pipeline, results_cls = self.pipeline, self.results_mod.QuantitativeResults
    saved = (pipeline._cached_gt_fn, pipeline.inference_fn,
             results_cls.add_batch)
    gt_fn = self._timed("gt", saved[0])

    def keeping_gt(*args):
      grid, v2x = gt_fn(*args)
      self.gt_args.append(args)
      self.grids.append(grid)
      return grid, v2x

    add_batch = self._timed("metrics", saved[2])

    def keeping_results(results, *args, **kwargs):
      self.results = results
      return add_batch(results, *args, **kwargs)

    pipeline._cached_gt_fn = keeping_gt
    pipeline.inference_fn = self._timed("inference", saved[1])
    results_cls.add_batch = keeping_results
    self.start = time.perf_counter()
    try:
      mean_iou = pipeline.run_eval(global_step)
    finally:
      (pipeline._cached_gt_fn, pipeline.inference_fn,
       results_cls.add_batch) = saved
    return mean_iou, time.perf_counter() - self.start

  def batch_ms(self):
    """Per batch: the time from the previous batch's end (the run's start
    for the first, which waits for the worker processes to start) to this
    batch's end."""
    ends = [end for part, _, end in self.spans if part == "metrics"]
    return [(b - a) * 1e3 for a, b in zip([self.start] + ends[:-1], ends)]

  def split_ms(self):
    """Per batch: loader wait (from the previous batch's end to the GT's
    start: the queue's wait and the copies to the device), GT, inference,
    metrics."""
    by_part = {part: [(s, e) for p, s, e in self.spans if p == part]
               for part in ("gt", "inference", "metrics")}
    rows, previous = [], self.start
    for gt, inference, metrics in zip(*by_part.values()):
      rows.append({"loader_wait": (gt[0] - previous) * 1e3,
                   "gt": (gt[1] - gt[0]) * 1e3,
                   "inference": (inference[1] - inference[0]) * 1e3,
                   "metrics": (metrics[1] - metrics[0]) * 1e3})
      previous = metrics[1]
    return rows


def eval_h7(torch, mods, CoreNet, CoreNetConfig, DecoderConfig, dev):
  """Phase 7: h7's full_eval through EvalPipeline.run_eval on a seeded
  dataset. Returns the launches per run (skip_gather, block_scatter_or)
  and the timings."""
  import numpy as np
  from corenet_tpu_torch.config import config as cfg
  from corenet_tpu_torch.eval import pipeline as pipeline_mod
  from corenet_tpu_torch.eval import results as results_mod
  from corenet_tpu_torch.eval.super_resolution import (
      super_resolution_from_model)
  op, fgbg, scatter, phased = mods
  voxels = OUTPUT_RES[0] * OUTPUT_RES[1] * OUTPUT_RES[2]
  with tempfile.TemporaryDirectory() as root:
    manifest, meshes_dir = write_eval_dataset(root, SEED + 50)
    out_dir = os.path.join(root, "out")

    def pipeline_for(task_type, infer, passes=1):
      config = cfg.config_from_dict(
          cfg.EvalConfig, h7_eval_config(manifest, meshes_dir, task_type,
                                         passes))
      return pipeline_mod.EvalPipeline(config, out_dir, infer,
                                       write_qualitative=False, device=dev)

    h7, h7_state = seeded_model(
        torch, CoreNet, CoreNetConfig(DecoderConfig(OUTPUT_RES, 2)), SEED)
    infer = super_resolution_from_model(h7, h7_state, OUTPUT_RES, device=dev)
    pipeline = pipeline_for("FG_BG", infer)
    classes = list(pipeline.classes)
    batches = -(-EVAL_SCENES // BATCH)

    # The counted run: the 10 scenes once, kernels, no extra synchronizes.
    probe = EvalProbe(torch, pipeline, results_mod)
    torch.cuda.synchronize()
    zero_counts(*mods)
    mean_iou, run_s = probe.run()
    launches = launch_counts(*mods)
    if launches != (4 * batches, 0, 0, batches, 0):
      raise AssertionError(f"h7 eval launched (skip_gather, its backward, "
                           f"fgbg_sums, block_scatter_or, phased_gt) "
                           f"{launches} times in {batches} batches, expected "
                           f"4 and 1 per batch")
    confusion = probe.results.confusion.copy()
    if confusion.sum() != EVAL_SCENES * voxels:
      raise AssertionError(f"the confusion matrix sums to {confusion.sum()}, "
                           f"not {EVAL_SCENES} · {voxels} (padding counted?)")
    csv_path = os.path.join(out_dir, "full_eval", "0", "voxel_metrics.csv")
    with open(csv_path, newline="") as text:
      rows = list(csv.reader(text))
    table = probe.results.voxel_metrics
    if rows[0] != [""] + list(table.columns) or len(rows) != 4:
      raise AssertionError(f"voxel_metrics.csv header {rows[0]}")
    for row, (name, values) in zip(rows[1:], zip(results_mod.METRIC_NAMES,
                                                 table.values)):
      parsed = np.array([float(v) if v else math.nan for v in row[1:]])
      if row[0] != name or not np.array_equal(parsed, values,
                                              equal_nan=True):
        raise AssertionError(f"voxel_metrics.csv row {row} is not {values}")
    log(f"h7 eval: classes {classes}, {EVAL_SCENES} scenes in {batches} "
        f"batches of {BATCH} (the last with {EVAL_SCENES % BATCH or BATCH} "
        f"valid), mean IoU {mean_iou:.6f}, confusion matrix "
        f"{confusion.tolist()} sums to {EVAL_SCENES} · {OUTPUT_RES[0]}³; launches "
        f"(skip_gather, block_scatter_or) ({launches[0]}, {launches[3]}) = "
        f"(4, 1) per batch; voxel_metrics.csv parses back to the table; "
        f"run {run_s:.3f} s")

    # The timed run: the dataset listed EVAL_TIMING_PASSES times, so that
    # most batches run while the loader works, as in a long eval.
    timed = pipeline_for("FG_BG", infer, passes=EVAL_TIMING_PASSES)
    probe = EvalProbe(torch, timed, results_mod)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, run_s = probe.run()
    mem = torch.cuda.max_memory_allocated()
    batch_ms = probe.batch_ms()
    ms = statistics.median(batch_ms)
    if probe.results.confusion.sum() != EVAL_TIMING_PASSES * confusion.sum():
      raise AssertionError(f"the timed run counted "
                           f"{probe.results.confusion.sum()} voxels")
    log(f"h7 eval, {EVAL_TIMING_PASSES * EVAL_SCENES} scenes: run "
        f"{run_s:.3f} s; batch times on the host clock, each ended by the "
        f"confusion matrix's copy to the host: " +
        ", ".join(f"{v:.3f}" for v in batch_ms) +
        f" ms (the first waits for the worker processes to start); median "
        f"{ms:.3f} ms per batch of {BATCH} = {BATCH * 1e3 / ms:.2f} eval "
        f"scenes/s; peak memory {mem / 2**30:.2f} GiB")

    # The same run with a synchronize around each part, for the split,
    # and with the first batch's GT kept.
    split_probe = EvalProbe(torch, timed, results_mod, split=True)
    split_probe.run()
    split = split_probe.split_ms()
    parts = {k: statistics.median(row[k] for row in split) for k in split[0]}
    log("h7 eval: batch split on the host clock (a synchronize around each "
        "part), per batch: " + "; ".join(
            ", ".join(f"{k} {v:.3f}" for k, v in row.items())
            for row in split) + " ms; medians " +
        ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    differ = int(np.abs(split_probe.results.confusion
                        - probe.results.confusion).sum() // 2)
    log(f"h7 eval: the confusion matrices of the two timed runs differ by "
        f"{differ} voxels of {probe.results.confusion.sum()} (cuDNN picks "
        "its algorithms per run)")
    del timed

    # The first batch's GT on the card against the CPU's.
    start = time.perf_counter()
    cpu_grid, _ = pipeline._cached_gt_fn(
        *(a[GT_CPU_SCENES].cpu() for a in split_probe.gt_args[0]))
    cpu_s = time.perf_counter() - start
    card_grid = split_probe.grids[0][GT_CPU_SCENES].cpu()
    differ = int((cpu_grid != card_grid).sum())
    if differ or card_grid.dtype != torch.uint8:
      raise AssertionError(f"{differ} voxels of the first eval batch's GT "
                           f"({card_grid.dtype}) differ between the card and "
                           "the CPU")
    log(f"h7 eval: the first batch's GT {list(split_probe.grids[0].shape)} "
        f"uint8 (foreground {float(card_grid.float().mean()):.4f}) of scenes "
        f"{GT_CPU_SCENES} equals the CPU's bit for bit ({cpu_s:.1f} s on the "
        "CPU)")

    # Kernels against plain versions: the same confusion matrix, with
    # cuDNN held to deterministic algorithms for both.
    matrices = []
    torch.backends.cudnn.deterministic = True
    try:
      for plain in (False, True):
        run = EvalProbe(torch, pipeline, results_mod)
        counts = launch_counts(*mods)
        with plain_versions(op, scatter) if plain else (
            contextlib.nullcontext()):
          run.run()
        if (launch_counts(*mods) != counts) == plain:
          raise AssertionError(f"the {'plain' if plain else 'kernel'} eval "
                               f"{'launched' if plain else 'skipped'} kernels")
        matrices.append(run.results.confusion.copy())
    finally:
      torch.backends.cudnn.deterministic = False
    if not np.array_equal(*matrices):
      raise AssertionError(f"confusion matrix with the kernels "
                           f"{matrices[0].tolist()} and with the plain "
                           f"versions {matrices[1].tolist()}")
    log("h7 eval: the confusion matrix with the kernels equals the one with "
        f"the plain versions: {matrices[0].tolist()}")

    # An inference function that returns the one-hot of the GT: IoU 1 for
    # every class the dataset holds, NaN for the others.
    holder = []

    def one_hot_of_gt(image, camera, v2x, offsets, resolution):
      return torch.nn.functional.one_hot(holder[-1].long(), 2).float()

    oracle = pipeline_for("FG_BG", one_hot_of_gt)
    gt_fn = oracle._cached_gt_fn

    def keeping(*args):
      out = gt_fn(*args)
      holder.append(out[0])
      return out

    oracle._cached_gt_fn = keeping
    run = EvalProbe(torch, oracle, results_mod)
    oracle_iou, _ = run.run()
    present = run.results.confusion.sum(axis=1) > 0
    iou = run.results.voxel_metrics.row("iou")[:-1]
    if not (present.tolist() == [True, True, False]
            and (iou[present] == 1.0).all()
            and np.isnan(iou[~present]).all() and oracle_iou == 1.0):
      raise AssertionError(f"one-hot GT as the prediction: IoU {iou}, "
                           f"present {present}, mean {oracle_iou}")
    log(f"h7 eval: with the one-hot GT as the prediction, IoU {iou.tolist()} "
        f"over {classes} (1.0 where present, NaN where absent), mean IoU "
        f"{oracle_iou}")

    # argmax on exact ties takes the first maximum, as jnp.argmax does.
    ties = torch.tensor([[0.5, 0.5, 0.0], [0.2, 0.4, 0.4], [1 / 3] * 3,
                         [0.0, 0.5, 0.5]], device=dev).reshape(1, 1, 2, 2, 3)
    pred, _ = results_mod.extract_labels(
        ties, torch.zeros((1, 1, 2, 2), dtype=torch.uint8, device=dev),
        torch.ones(1, dtype=torch.int32, device=dev), "SEMANTIC")
    if pred.flatten().tolist() != [0, 1, 0, 1]:
      raise AssertionError(f"argmax on ties gave {pred.flatten().tolist()}")

    # One batch again, for the device profile.
    batches_of = iter(pipeline_mod.DataLoader(
        pipeline.dataset_manager.create_dataset(local_seed=0),
        batch_size=BATCH, num_workers=2, worker_processes=False,
        max_edge_view=(pipeline_mod.VOXELIZE_WINDOW_PIXELS - 4) / 8
        / OUTPUT_RES[0]))
    held = [next(batches_of)]
    batches_of.close()

    def one_batch():
      pipeline._run_batches(held, pipeline._cached_gt_fn, "FG_BG",
                            OUTPUT_RES, results_mod.QuantitativeResults(
                                classes, "FG_BG"))

    walls = []
    for _ in range(5):
      torch.cuda.synchronize()
      start = time.perf_counter()
      one_batch()
      walls.append((time.perf_counter() - start) * 1e3)
    held_ms = statistics.median(walls)
    log(f"h7 eval: one held batch (copies to the device, GT, inference, "
        f"metrics; no loader) median of 5 {held_ms:.3f} ms")
    log_profile("h7 eval", device_profile(torch, one_batch), held_ms,
                what="held batch")
    del h7, infer, pipeline, oracle
    torch.cuda.empty_cache()

    # Once more as SEMANTIC: one channel per class.
    sem, sem_state = seeded_model(
        torch, CoreNet, CoreNetConfig(DecoderConfig(OUTPUT_RES,
                                                    len(classes))), SEED + 51)
    semantic = pipeline_for("SEMANTIC", super_resolution_from_model(
        sem, sem_state, OUTPUT_RES, device=dev))
    run = EvalProbe(torch, semantic, results_mod)
    zero_counts(*mods)
    sem_iou, sem_s = run.run()
    sem_launches = launch_counts(*mods)
    sem_confusion = run.results.confusion
    if (sem_launches != launches or sem_confusion.sum() != EVAL_SCENES * voxels
        or (sem_confusion.sum(axis=1) > 0).sum() != len(classes)):
      raise AssertionError(f"SEMANTIC eval: launches {sem_launches}, "
                           f"confusion {sem_confusion.tolist()}")
    sem_ms = statistics.median(run.batch_ms())
    log(f"h7 eval as SEMANTIC ({len(classes)} channels): mean IoU "
        f"{sem_iou:.6f}, confusion matrix {sem_confusion.tolist()}, every "
        f"class present in the GT; run {sem_s:.3f} s, median batch "
        f"{sem_ms:.3f} ms = {BATCH * 1e3 / sem_ms:.2f} eval scenes/s")
  return launches, {"batch_ms": batch_ms, "median_batch_ms": ms,
                    "split_ms": parts, "held_batch_ms": held_ms,
                    "semantic_median_batch_ms": sem_ms}


def train_y1(torch, mods, CoreNet, config, image, camera, dev):
  """Phase 8: y1 training on ground truth from the general rasterizer
  (sub-grid sampling, irm 31), with the phase loss on the labeled grid.
  Returns the launches of the first step and the timings."""
  from corenet_tpu_torch.train import gt
  from corenet_tpu_torch.train.state import create_train_state
  from corenet_tpu_torch.train.step import make_train_step
  from corenet_tpu_torch.voxel import fill as fill_mod
  from corenet_tpu_torch.voxel import voxelize
  op, fgbg = mods[:2]
  res = Y1_NATIVE
  host, counts = triangle_batch(
      torch, image, camera, SEED + 61,
      irm=Y1_VOX["image_resolution_multiplier"], res=res[0])
  batch = {k: v.to(dev) for k, v in host.items()}
  log(f"y1 train: (cube, sphere) triangles per scene {counts}, padded to "
      f"{GT_TRIANGLES}; slot 1 label 0 in scene {BATCH - 1}; random grid "
      "offsets")
  model, _ = seeded_model(torch, CoreNet, config, SEED + 60,
                          phase_output=True)
  state = create_train_state(model, device=dev)
  step = make_train_step(state.model, state.optimizer, "FG_BG", res,
                         voxelization_kwargs=Y1_VOX)

  torch.cuda.synchronize()
  zero_counts(*mods)
  rounds0 = fill_mod.round_count
  start = time.perf_counter()
  state, metrics = step(state, batch)
  torch.cuda.synchronize()
  first_s = time.perf_counter() - start
  launches = launch_counts(*mods)
  rounds = fill_mod.round_count - rounds0
  if launches != (4, 4, 1, 0, 0):
    raise AssertionError(f"y1 train step launched (skip_gather, its "
                         f"backward, fgbg_sums, block_scatter_or, phased_gt) "
                         f"{launches} times, expected (4, 4, 1, 0, 0)")
  first_loss = float(metrics["loss"])
  bad = [n for n, p in state.model.named_parameters()
         if p.grad is None or not bool(torch.isfinite(p.grad).all())]
  if not math.isfinite(first_loss) or bad:
    raise AssertionError(f"y1 train: loss {first_loss}, non-finite or "
                         f"missing gradients {bad[:5]}")
  log(f"y1 train: first step {first_s:.3f} s, loss {first_loss:.6f}, "
      f"launches (skip_gather, backward, fgbg_sums) {launches[:3]}, "
      f"{rounds} dense fill rounds, loss and all gradients finite")

  # The step's labeled grid on the card against the CPU's.
  args = [batch[k] for k in GT_KEYS]
  grid, _ = gt.voxelize_batch(*args, resolution=res, **Y1_VOX)
  start = time.perf_counter()
  cpu_grid, _ = gt.voxelize_batch(*(host[k][GT_CPU_SCENES] for k in GT_KEYS),
                                  resolution=res, **Y1_VOX)
  cpu_s = time.perf_counter() - start
  differ = int((cpu_grid != grid[GT_CPU_SCENES].cpu()).sum())
  if differ or grid.dtype != torch.int32:
    raise AssertionError(f"{differ} voxels of scenes {GT_CPU_SCENES} "
                         f"({grid.dtype}) differ between the card's and the "
                         "CPU's general rasterizer (tolerance 0)")
  log(f"y1 train: the labeled grid {list(grid.shape)} int32 (foreground "
      f"{float(grid.float().mean()):.4f}) of scenes {GT_CPU_SCENES} equals "
      f"the CPU's bit for bit ({cpu_s:.1f} s on the CPU)")

  compare_with_plain_step(torch, (op, fgbg), state, step, batch, "y1 train")

  state = loss_steps(state, step, batch, first_loss, "y1 train")

  # The GT's parts, as train/gt.py::_general_batch runs them.
  b, slots = batch["mesh_labels"].shape
  d, h, w = res
  v2v = gt._view2voxel_uniform(batch["grid_offset"], float(max(res)),
                               slots).reshape(b * slots, 4, 4)
  scene = torch.arange(b, dtype=torch.int32, device=dev)[:, None]
  mesh_index = (scene * slots + batch["tri_mesh_slot"]).reshape(-1)

  def raster():
    return voxelize.voxelize_triangles(
        batch["triangles"].reshape(-1, 3, 3), mesh_index, v2v,
        batch["tri_valid"].reshape(-1), num_meshes=b * slots, resolution=res,
        **{k: Y1_VOX[k] for k in (
            "sub_grid_sampling", "image_resolution_multiplier",
            "conservative_rasterization", "projection_depth_multiplier",
            "max_bbox_pixels")})

  shell = raster()
  filled = fill_mod.fill_inside_voxels(shell, fill_rounds=rounds)
  labels = batch["mesh_labels"].float()[:, :, None, None, None]

  def centres_compose():
    centres = voxelize.get_sub_grid_centers(filled)
    return (centres.reshape(b, slots, d, h, w) * labels).amax(dim=1).int()

  if not torch.equal(centres_compose(), grid):
    raise AssertionError("the GT's parts do not give the step's grid")
  window = Y1_VOX["max_bbox_pixels"]
  chunk = (1 << 22) // window ** 2
  split = {
      "raster_ms": event_ms(torch, raster),
      "raster_chunks": -(-b * GT_TRIANGLES // chunk),
      "fill_ms": event_ms(torch, lambda: fill_mod.fill_inside_voxels(
          shell, fill_rounds=rounds)),
      "fill_rounds": rounds,
      "centres_compose_ms": event_ms(torch, centres_compose)}
  split["sum_ms"] = (split["raster_ms"] + split["fill_ms"]
                     + split["centres_compose_ms"])
  del shell, filled

  _, timed = timed_training(torch, "y1 train", step, state, batch)
  ms = timed["median_ms"]
  log(f"y1 train: GT device time by part (CUDA events around 3 eager calls, "
      f"launch gaps included; sub-grid {list(2 * r + 1 for r in res)} × "
      f"{b * slots} meshes): " + ", ".join(
          f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
          for k, v in split.items()) +
      f"; {split['sum_ms'] / ms:.4f} of the step")
  split["step_ms"] = ms
  return launches, split


def parity_row(torch, image, camera, dev):
  """parity_voxelize_batch at 128³ on the phase-6 batch: the card against
  the CPU, the voxels where it differs from raster + fill (the grazed
  shell), and its time."""
  from corenet_tpu_torch.train import gt
  from corenet_tpu_torch.voxel.parity import parity_voxelize_batch
  host, _ = triangle_batch(torch, image, camera, SEED + 41,
                           res=OUTPUT_RES[0])
  args = [host[k].to(dev) for k in GT_KEYS]
  slots = host["mesh_labels"].shape[1]

  def parity(inputs=args):
    return parity_voxelize_batch(*inputs, num_mesh_slots=slots,
                                 resolution=OUTPUT_RES)[0]

  grid = parity()
  start = time.perf_counter()
  cpu_grid = parity([host[k][GT_CPU_SCENES[:1]] for k in GT_KEYS])
  cpu_s = time.perf_counter() - start
  differ = int((cpu_grid != grid[GT_CPU_SCENES[:1]].cpu()).sum())
  if differ:
    raise AssertionError(f"{differ} voxels of scene {GT_CPU_SCENES[0]} differ "
                         "between the card's and the CPU's parity grid "
                         "(tolerance 0)")
  raster, _ = gt.voxelize_batch(*args, resolution=OUTPUT_RES, **H7_VOX)
  inside = int((grid > 0).sum())
  only_raster = int(((raster > 0) & (grid == 0)).sum())
  only_parity = int(((raster == 0) & (grid > 0)).sum())
  # The grazed shell is a surface's worth of voxels; a leak would differ
  # by a volume's worth.
  if not (0 < inside and only_parity <= 0.01 * inside
          and only_raster <= 0.5 * inside):
    raise AssertionError(f"parity grid: {inside} inside, {only_raster} only "
                         f"in raster + fill, {only_parity} only in parity")
  ms = event_ms(torch, parity)
  log(f"parity GT at 128³ on the phase-6 batch: scene {GT_CPU_SCENES[0]} on "
      f"the card equals the CPU's bit for bit ({cpu_s:.1f} s on the CPU); "
      f"{inside} voxels inside, {only_raster} only in raster + fill (the "
      f"grazed shell), {only_parity} only in parity; {ms:.3f} ms per batch "
      f"of {BATCH} (CUDA events around 3 eager calls)")
  return {"ms": ms, "inside": inside, "only_raster": only_raster,
          "only_parity": only_parity}


CLI_TILES = 4  # phase 9's num_qualitative_results
TILE_SHAPE = (5 * IMAGE_HW, 5 * IMAGE_HW, 3)  # 5 cameras × 5 columns of 256²


@contextlib.contextmanager
def timed_calls(module, names, spans):
  """Wraps module.<name> for each name so that every call appends
  (name, host seconds) to `spans`."""
  saved = {name: getattr(module, name) for name in names}

  def timing(name, fn):
    def wrapper(*args, **kwargs):
      start = time.perf_counter()
      try:
        return fn(*args, **kwargs)
      finally:
        spans.append((name, time.perf_counter() - start))
    return wrapper

  for name, fn in saved.items():
    setattr(module, name, timing(name, fn))
  try:
    yield
  finally:
    for name, fn in saved.items():
      setattr(module, name, fn)


def serve_cli(torch, mods, CoreNet, config, image, camera, v2x, dev):
  """Phase 9: serving from a `.cpt` file through the eval and demo CLIs,
  with qualitative results. Returns the eval CLI's launches and the
  timings."""
  import numpy as np
  from corenet_tpu_torch.cli import demo as demo_cli
  from corenet_tpu_torch.cli import eval as eval_cli
  from corenet_tpu_torch.config import config as cfg
  from corenet_tpu_torch.data.batching import subdivide_triangles
  from corenet_tpu_torch.eval import pipeline as pipeline_mod
  from corenet_tpu_torch.eval import qualitative as qualitative_mod
  from corenet_tpu_torch.eval import results as results_mod
  from corenet_tpu_torch.eval.super_resolution import (
      super_resolution_from_model)
  from corenet_tpu_torch.train.checkpoint import (
      CheckpointManager, CheckpointReader)
  from corenet_tpu_torch.train.state import create_train_state
  from corenet_tpu_torch.train.step import compute_v2s
  from corenet_tpu_torch.utils.png import decode_png
  from corenet_tpu_torch.viz import camera as camera_mod
  from corenet_tpu_torch.viz import renderer
  from corenet_tpu_torch.viz.colors import DEFAULT_COLOR_PALETTE
  batches = -(-EVAL_SCENES // BATCH)
  out = {}
  with tempfile.TemporaryDirectory() as root:
    manifest, meshes_dir = write_eval_dataset(root, SEED + 50)
    eval_dict = h7_eval_config(manifest, meshes_dir, "FG_BG")
    eval_dict.update(num_qualitative_results=CLI_TILES,
                     num_qualitative_results_in_tensor_board=1)
    eval_config = cfg.config_from_dict(cfg.EvalConfig, eval_dict)
    h7, h7_state = seeded_model(torch, CoreNet, config, SEED)
    reference = pipeline_mod.EvalPipeline(
        eval_config, os.path.join(root, "ref"),
        super_resolution_from_model(h7, h7_state, OUTPUT_RES, device=dev),
        write_qualitative=False, device=dev)
    classes = list(reference.classes)

    # 1. The checkpoint, written and read back into a fresh model.
    full_config = {
        "string_templates": [], "output_path": os.path.join(root, "train"),
        "train": {"data": eval_dict["data"],
                  "resnet50_imagenet_checkpoint": ""},
        "eval": [{"start_step": 0, "interval": 10 ** 9,
                  "persistent_checkpoint": False, "config": eval_dict}]}
    state = create_train_state(h7, device=dev)
    cpt_dir = os.path.join(root, "cpt")
    start = time.perf_counter()
    path = CheckpointManager(cpt_dir).save_state(
        state, {"full_config": full_config, "classes": classes})
    write_s = time.perf_counter() - start
    fresh = create_train_state(CoreNet(config), device=dev)
    start = time.perf_counter()
    restored, meta, _ = CheckpointReader(cpt_dir).read_last_checkpoint(fresh)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - start
    size_mb = os.path.getsize(path) / 2 ** 20
    v2s = compute_v2s(camera.to(dev), v2x.to(dev))
    offsets = torch.full((BATCH, 3), 0.5, device=dev)
    torch.backends.cudnn.deterministic = True
    try:
      with torch.inference_mode():
        logits = [m.eval()(image.to(dev), v2s, offsets)
                  for m in (state.model, restored.model)]
    finally:
      torch.backends.cudnn.deterministic = False
    if not torch.equal(*logits) or meta["classes"] != classes:
      raise AssertionError(
          f"logits of the read-back .cpt differ from the original's by "
          f"{float((logits[0] - logits[1]).abs().max())}")
    log(f"serve-cli: {os.path.basename(path)} {size_mb:.1f} MB (h7 weights, "
        f"statistics and Adam moments) written in {write_s:.3f} s, read into "
        f"a fresh CoreNet on the card in {read_s:.3f} s; its logits "
        f"{list(logits[0].shape)} equal the original's (torch.equal)")
    out.update(cpt_mb=size_mb, cpt_write_s=write_s, cpt_read_s=read_s)
    del state, fresh, restored, logits
    torch.cuda.empty_cache()

    # 2. The eval CLI against run_eval on the same weights.
    cli_out = os.path.join(root, "cli")
    spans = []
    torch.backends.cudnn.deterministic = True
    try:
      ref_iou = reference.run_eval(0)
      with timed_calls(qualitative_mod.QualitativeResults, ["add_scene"],
                       spans), \
          timed_calls(qualitative_mod, ["visualize_scene_output"], spans), \
          timed_calls(renderer, ["render_mesh", "render_voxel_grid"], spans):
        torch.cuda.synchronize()
        zero_counts(*mods)
        start = time.perf_counter()
        cli_iou = eval_cli.main([f"--checkpoint_path={path}",
                                 f"--output_path={cli_out}"])["full_eval"]
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - start
        launches = launch_counts(*mods)
    finally:
      torch.backends.cudnn.deterministic = False
    if launches != (4 * batches, 0, 0, batches, 0):
      raise AssertionError(f"the eval CLI launched (skip_gather, its "
                           f"backward, fgbg_sums, block_scatter_or, "
                           f"phased_gt) {launches} times in {batches} "
                           f"batches, expected 4 and 1 per batch")
    if cli_iou != ref_iou:
      raise AssertionError(f"the eval CLI's mean IoU {cli_iou} is not "
                           f"run_eval's {ref_iou}")
    result_dir = os.path.join(cli_out, "full_eval", "0")
    with open(os.path.join(result_dir, "voxel_metrics.csv"),
              newline="") as text:
      rows = list(csv.reader(text))
    values = [float(v) if v else math.nan for row in rows[1:]
              for v in row[1:]]
    if (rows[0][:2] != ["", "__void__"] or len(rows) != 4
        or len(values) != 3 * len(rows[0][1:])):
      raise AssertionError(f"the CLI's voxel_metrics.csv: {rows}")
    tiles = sorted(name for name in os.listdir(result_dir)
                   if name.startswith("img_") and name.endswith(".png"))
    shapes = [decode_png(open(os.path.join(result_dir, name), "rb").read()
                         ).shape for name in tiles]
    if len(tiles) != CLI_TILES or set(shapes) != {TILE_SHAPE}:
      raise AssertionError(f"the CLI wrote tiles {tiles} of {shapes}")
    summary = os.path.join(cli_out, "tb", "full_eval", "scalars.jsonl")
    with open(summary) as text:
      tags = {json.loads(line)["tag"] for line in text}
    if not {f"IoU/{name}" for name in classes} <= tags:
      raise AssertionError(f"the summary JSONL holds {sorted(tags)}")
    per_tile = [seconds for name, seconds in spans if name == "add_scene"]
    visual = [seconds for name, seconds in spans
              if name == "visualize_scene_output"]
    render = sum(seconds for name, seconds in spans
                 if name.startswith("render_")) / len(per_tile)
    tile_ms = statistics.median(per_tile) * 1e3
    split = {"render_ms": render * 1e3,
             "extract_ms": (statistics.mean(visual) - render) * 1e3,
             "png_ms": (statistics.mean(per_tile) - statistics.mean(visual))
                       * 1e3}
    log(f"serve-cli eval CLI: mean IoU {cli_iou:.6f} = run_eval's on the "
        f"same weights (deterministic cuDNN); launches (skip_gather, "
        f"block_scatter_or) ({launches[0]}, {launches[3]}) in {batches} "
        f"batches = (4, 1) per batch; voxel_metrics.csv parses; {len(tiles)} "
        f"tiles {shapes[0]}; per-class IoU in {os.path.basename(summary)}; "
        f"run {cli_s:.3f} s. Per tile (host clock, median of {len(per_tile)}):"
        f" {tile_ms:.3f} ms = extraction on the host "
        f"{split['extract_ms']:.3f} + rendering on the card "
        f"{split['render_ms']:.3f} ({len(spans) - 2 * len(per_tile)} "
        f"renders) + PNG {split['png_ms']:.3f} (means)")
    out.update(cli_s=cli_s, tile_ms=tile_ms, tile_split_ms=split,
               tiles_ms=[v * 1e3 for v in per_tile])

    # A held batch with and without its qualitative results.
    loader = pipeline_mod.DataLoader(
        reference.dataset_manager.create_dataset(local_seed=0),
        batch_size=BATCH, num_workers=2, worker_processes=False,
        max_edge_view=(pipeline_mod.VOXELIZE_WINDOW_PIXELS - 4) / 8
        / OUTPUT_RES[0])
    batches_of = iter(loader)
    held = [next(batches_of)]
    batches_of.close()

    def one_batch(tiles):
      qualitative = qualitative_mod.QualitativeResults(
          os.path.join(root, "held"), tiles, 0, device=dev) if tiles else None
      reference._run_batches(held, reference._cached_gt_fn, "FG_BG",
                             OUTPUT_RES, results_mod.QuantitativeResults(
                                 classes, "FG_BG"), qualitative)
      torch.cuda.synchronize()

    held_ms = {}
    for tiles in (0, BATCH, BATCH, 0):
      start = time.perf_counter()
      one_batch(tiles)
      held_ms.setdefault(tiles, []).append(
          (time.perf_counter() - start) * 1e3)
    held_ms = {k: min(v) for k, v in held_ms.items()}
    log(f"serve-cli: one held eval batch of {BATCH} (host clock, the faster "
        f"of two): {held_ms[0]:.3f} ms without qualitative results, "
        f"{held_ms[BATCH]:.3f} ms with {BATCH} tiles")
    out.update(held_batch_ms=held_ms[0], held_batch_tiles_ms=held_ms[BATCH])

    # 3. The renderers on the card against the CPU.
    shell = subdivide_triangles(
        cube_shell(), (pipeline_mod.VOXELIZE_WINDOW_PIXELS - 4) / 8
        / OUTPUT_RES[0])
    colors = np.tile(DEFAULT_COLOR_PALETTE[1], (len(shell), 1))
    cam = camera_mod.default_camera([0, 0, 0], [1, 1, 1])
    inputs = {k: torch.from_numpy(v).to(dev)
              for k, v in held[0][0].step_inputs("FG_BG").items()}
    grid = reference._cached_gt_fn(
        *(inputs[k] for k in pipeline_mod.GT_KEYS))[0][0].cpu().numpy()
    rows = {}
    for name, draw in (
        ("cube shell", lambda d: renderer.render_mesh(
            shell, colors, cam, (IMAGE_HW, IMAGE_HW), device=d)),
        ("128³ GT grid", lambda d: renderer.render_voxel_grid(
            grid, image_size=(IMAGE_HW, IMAGE_HW), device=d))):
      images, seconds = [], []
      for d in (dev, dev, "cpu"):
        start = time.perf_counter()
        images.append(draw(d))
        seconds.append(time.perf_counter() - start)
      l1 = float(np.abs(images[1].astype(np.int32) - images[2]).mean())
      share = float((images[1] != images[2]).any(-1).mean())
      if not l1 < 1.0 or (images[1] == 255).all():
        raise AssertionError(f"{name}: card and CPU renders differ by L1 "
                             f"{l1}")
      rows[name] = {"l1": l1, "differing_pixels": share,
                    "card_ms": seconds[1] * 1e3, "cpu_ms": seconds[2] * 1e3}
      log(f"serve-cli renderer, {name} at {IMAGE_HW}²: card and CPU within "
          f"L1 {l1:.4f} (< 1.0), {share:.4%} of the pixels differ; card "
          f"{seconds[1] * 1e3:.3f} ms (first call {seconds[0] * 1e3:.3f}), "
          f"CPU {seconds[2] * 1e3:.3f} ms (host clock)")
    log(f"serve-cli renderer: the cube shell has {len(shell)} triangles; the "
        f"grid's foreground {float((grid > 0).mean()):.4f}")
    out["renderer"] = rows

    # 4. The demo CLI on one scene.
    png_path = os.path.join(root, "reconstruction.png")
    zero_counts(*mods)
    start = time.perf_counter()
    demo_cli.main([f"--scene={os.path.join(root, 'scene_000.npz')}",
                   f"--meshes_dir={meshes_dir}", f"--checkpoint={path}",
                   f"--output={png_path}",
                   f"--resolution={OUTPUT_RES[0]}"])
    demo_s = time.perf_counter() - start
    demo_launches = launch_counts(*mods)
    with open(png_path, "rb") as data:
      shape = decode_png(data.read()).shape
    if shape != TILE_SHAPE:
      raise AssertionError(f"the demo wrote a tile of {shape}")
    log(f"serve-cli demo CLI: reconstruction.png {shape} in {demo_s:.3f} s; "
        f"launches (skip_gather, block_scatter_or) ({demo_launches[0]}, "
        f"{demo_launches[3]})")
    out.update(demo_s=demo_s, demo_launches=demo_launches)
  return launches, out


# Phase 10's bf16 kernel step against its plain step
# (compare_with_plain_step): all gradients together within this relative
# L2, each one's cosine at least this. An H100's run measured 2.2e-2 for
# the encoder's gradients together and 0.995 for the lowest cosine (a
# BatchRenorm bias, whose gradient is a sum with cancellation).
BF16_GRADS_TOL = 5e-2
BF16_COSINE = 0.95
OVERFIT_RES = (32, 32, 32)
OVERFIT_STEPS = 400


def timed_training(torch, label, step, state, batch, what="step"):
  """TRAIN_RUNS steps one by one on the host clock (each ended by a
  synchronize), the peak memory, and one profiled step. Returns the
  state and the figures."""
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

  profile = device_profile(torch, one_step)
  log_profile(label, profile, ms, what=what)
  shares = profile["conv_shares"] if profile else None
  out = {"median_ms": ms, "min_ms": min(times), "max_ms": max(times),
         "peak_gib": mem / 2 ** 30,
         "busy_ms": profile["busy_ms"] if profile else None,
         "idle_share": 1 - profile["busy_ms"] / ms if profile else None,
         "conv_shares": shares}
  log(f"{label}: over {TRAIN_RUNS} steps median {ms:.3f} ms (min "
      f"{min(times):.3f}, max {max(times):.3f}) per batch of "
      f"{batch['image'].shape[0]} = "
      f"{batch['image'].shape[0] * 1e3 / ms:.2f} training scenes/s; peak "
      f"memory {mem / 2**30:.2f} GiB; share of the kernels' device time: "
      + (", ".join(f"{k} {v:.3f}" for k, v in shares.items())
         if shares else "not measured"))
  return holder[0], out


def bf16_training(torch, mods, label, state, step, batch, expected):
  """One bf16 training path: the first step's launches (counted from 0)
  against `expected`, finite loss and gradients, the kernel step against
  the plain step, a falling loss, the timed steps and a profile."""
  torch.cuda.synchronize()
  zero_counts(*mods)
  start = time.perf_counter()
  state, metrics = step(state, batch)
  torch.cuda.synchronize()
  first_s = time.perf_counter() - start
  launches = launch_counts(*mods)
  if launches != expected:
    raise AssertionError(f"{label} step launched (skip_gather, its backward, "
                         f"fgbg_sums, block_scatter_or, phased_gt) "
                         f"{launches} times, expected {expected}")
  first_loss = float(metrics["loss"])
  bad = [n for n, p in state.model.named_parameters()
         if p.grad is None or p.grad.dtype != torch.float32
         or not bool(torch.isfinite(p.grad).all())]
  if not math.isfinite(first_loss) or bad:
    raise AssertionError(f"{label}: loss {first_loss}, non-finite, missing "
                         f"or non-float32 gradients {bad[:5]}")
  log(f"{label}: first step {first_s:.3f} s, loss {first_loss:.6f}, "
      f"launches {launches}, loss and all gradients finite (float32)")
  loss_rel, grad_worst, grad_rel = compare_with_plain_step(
      torch, mods, state, step, batch, label, bf16=True)
  state = loss_steps(state, step, batch, first_loss, label)
  state, out = timed_training(torch, label, step, state, batch)
  out.update(launches=launches, first_s=first_s, first_loss=first_loss,
             plain_loss_rel=loss_rel, plain_grads_rel=grad_rel,
             plain_worst_grad_rel=grad_worst)
  return state, out


def overfit_bf16(torch, CoreNet, CoreNetConfig, DecoderConfig, dev):
  """tests/test_learning.py's two-scene overfit at 32³ in bf16 with the
  phase loss: two cubes subdivided for irm 8 and a 24-pixel window, 64²
  images, Adam lr 1e-3; the loss must fall below a tenth of the first
  (checked every 50 steps, at most OVERFIT_STEPS), then each scene's
  foreground IoU with batch statistics (a fine-logit twin in train mode,
  no update kept) above 0.8 against the GT."""
  import numpy as np
  from corenet_tpu_torch.data.batching import subdivide_triangles
  from corenet_tpu_torch.train import gt
  from corenet_tpu_torch.train.state import create_train_state
  from corenet_tpu_torch.train.step import compute_v2s, make_train_step
  res = OVERFIT_RES
  max_edge = (24 - 4) / 8 / res[0]

  def cube(lo, hi):
    c = cube_shell()
    return lo + (c - 0.3) / 0.4 * (hi - lo)

  subs = [subdivide_triangles(cube(0.28, 0.62).astype(np.float32), max_edge),
          subdivide_triangles(cube(0.42, 0.78).astype(np.float32), max_edge)]
  t = max(len(s) for s in subs)
  tris = np.zeros((2, t, 3, 3), np.float32)
  valid = np.zeros((2, t), bool)
  for i, s in enumerate(subs):
    tris[i, :len(s)] = s
    valid[i, :len(s)] = True
  rng = np.random.RandomState(3)
  batch = {"image": torch.from_numpy((rng.rand(2, 64, 64, 3) * 255).astype(
               np.uint8)),
           "camera": torch.eye(4).expand(2, 4, 4).contiguous(),
           "triangles": torch.from_numpy(tris),
           "tri_mesh_slot": torch.zeros((2, t), dtype=torch.int32),
           "tri_valid": torch.from_numpy(valid),
           "mesh_labels": torch.ones((2, 1), dtype=torch.int32),
           "grid_offset": torch.full((2, 3), 0.5)}
  batch = {k: v.to(dev) for k, v in batch.items()}
  config = CoreNetConfig(DecoderConfig(res, 2))
  model, _ = seeded_model(torch, CoreNet, config, SEED + 90,
                          phase_output=True, compute_dtype=torch.bfloat16)
  state = create_train_state(model, learning_rate=1e-3, device=dev)
  vox = dict(image_resolution_multiplier=8, max_bbox_pixels=24,
             conservative_rasterization=False)
  step = make_train_step(state.model, state.optimizer, "FG_BG", res,
                         voxelization_kwargs=vox)
  start = time.perf_counter()
  first = loss = None
  steps = 0
  for steps in range(1, OVERFIT_STEPS + 1):
    state, metrics = step(state, batch)
    if steps == 1:
      first = float(metrics["loss"])
    elif steps % 50 == 0:
      loss = float(metrics["loss"])
      if loss < first / 10:
        break
  seconds = time.perf_counter() - start
  if not (math.isfinite(first) and first > 0.5 and loss is not None
          and loss < first / 10):
    raise AssertionError(f"bf16 overfit: loss {first} then {loss} after "
                         f"{steps} steps, not below a tenth")
  grid, v2x = gt.voxelize_batch(*(batch[k] for k in GT_KEYS), resolution=res,
                                **vox)
  twin = CoreNet(config, compute_dtype=torch.bfloat16).to(dev)
  twin.load_state_dict(state.model.state_dict())
  with torch.no_grad():
    logits = twin.train()(batch["image"], compute_v2s(batch["camera"], v2x),
                          batch["grid_offset"])
  pred, truth = logits.argmax(-1) == 1, grid == 1
  ious = [float((pred[i] & truth[i]).sum() / (pred[i] | truth[i]).sum())
          for i in range(2)]
  if not min(ious) > 0.8:
    raise AssertionError(f"bf16 overfit: foreground IoU {ious}")
  log(f"bf16 overfit at 32³ (two scenes, phase loss): loss {first:.5f} → "
      f"{loss:.5f} in {steps} steps ({seconds:.1f} s, "
      f"{seconds / steps * 1e3:.1f} ms per step); foreground IoU per scene "
      f"{ious[0]:.4f}, {ious[1]:.4f} (> 0.8 asked)")
  return {"first_loss": first, "loss": loss, "steps": steps,
          "seconds": seconds, "ious": ious}


def train_bf16(torch, mods, CoreNet, CoreNetConfig, DecoderConfig, image,
               camera, v2x, offsets, dev):
  """Phase 10: training in bf16 (the JAX pipeline's default compute
  dtype) through make_train_step: h7 on GT voxelized in the step with the
  phase loss, h7 on host GT, y1 on the general GT; one h7 row in float32
  with TF32 on; the two-scene overfit. Returns the figures."""
  from corenet_tpu_torch.train.state import create_train_state
  from corenet_tpu_torch.train.step import make_train_step
  bf16 = torch.bfloat16
  h7 = CoreNetConfig(DecoderConfig(OUTPUT_RES, 2))
  out = {}

  # h7 on GT voxelized in the step, the phase loss: the JAX pipeline's
  # default for h7, minus packing.
  host, _ = triangle_batch(torch, image, camera, SEED + 41)
  tri_batch = {k: v.to(dev) for k, v in host.items()}
  model, _ = seeded_model(torch, CoreNet, h7, SEED + 40, phase_output=True,
                          compute_dtype=bf16)
  state = create_train_state(model, device=dev)
  step = make_train_step(state.model, state.optimizer, "FG_BG", OUTPUT_RES,
                         voxelization_kwargs=H7_VOX)
  _, out["h7_gt"] = bf16_training(torch, mods, "h7 train-bf16 (GT in step)",
                                  state, step, tri_batch, (4, 4, 1, 1, 1))
  del model, state, step
  torch.cuda.empty_cache()

  # h7 on host GT (the batch's grid).
  model, _ = seeded_model(torch, CoreNet, h7, SEED + 20, compute_dtype=bf16)
  state = create_train_state(model, device=dev)
  step = make_train_step(state.model, state.optimizer, "FG_BG", OUTPUT_RES)
  grid_batch = {"image": image.to(dev), "camera": camera.to(dev),
                "v2x": v2x.to(dev),
                "grid": ellipsoid_grid(torch, dev, OUTPUT_RES, BATCH,
                                       offsets, SEED + 21),
                "grid_offset": offsets.to(dev)}
  _, out["h7_host"] = bf16_training(torch, mods, "h7 train-bf16 (host GT)",
                                    state, step, grid_batch, (4, 4, 1, 0, 0))
  del model, state, step
  torch.cuda.empty_cache()

  # y1 on the general GT, as TrainPipeline builds y1's model.
  host, _ = triangle_batch(torch, image, camera, SEED + 61,
                           irm=Y1_VOX["image_resolution_multiplier"],
                           res=Y1_NATIVE[0])
  y1_batch = {k: v.to(dev) for k, v in host.items()}
  model, _ = seeded_model(torch, CoreNet, CoreNetConfig(DecoderConfig(
      Y1_NATIVE, 2)), SEED + 60, phase_output=True, compute_dtype=bf16)
  state = create_train_state(model, device=dev)
  step = make_train_step(state.model, state.optimizer, "FG_BG", Y1_NATIVE,
                         voxelization_kwargs=Y1_VOX)
  _, out["y1"] = bf16_training(torch, mods, "y1 train-bf16 (general GT)",
                               state, step, y1_batch, (4, 4, 1, 0, 0))
  del model, state, step
  torch.cuda.empty_cache()

  # One h7 row in float32 with TF32 on, for this row only.
  model, _ = seeded_model(torch, CoreNet, h7, SEED + 40, phase_output=True)
  state = create_train_state(model, device=dev)
  step = make_train_step(state.model, state.optimizer, "FG_BG", OUTPUT_RES,
                         voxelization_kwargs=H7_VOX)
  torch.backends.cudnn.allow_tf32 = True
  torch.backends.cuda.matmul.allow_tf32 = True
  try:
    state, _ = step(state, tri_batch)
    torch.cuda.synchronize()
    _, out["h7_gt_tf32"] = timed_training(
        torch, "h7 train float32 with TF32 (GT in step)", step, state,
        tri_batch)
  finally:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
  del model, state, step
  torch.cuda.empty_cache()

  out["overfit"] = overfit_bf16(torch, CoreNet, CoreNetConfig, DecoderConfig,
                                dev)
  torch.cuda.empty_cache()
  return out


def h7_train_config(manifest, meshes_dir, root):
  """configs/models/h7.json5 (its `//` comment dropped, since json5 is not
  assumed) with the seeded dataset in place of ShapeNet's, a fresh
  encoder, and intervals that a run of a few steps crosses: temp
  checkpoints every 8 examples, persistent ones every 12, the loss every
  4, one recurrent eval (full_eval on the seeded scenes, no tiles) at
  step 8."""
  with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "configs", "models", "h7.json5")) as f:
    text = "\n".join(line for line in f.read().splitlines()
                     if not line.lstrip().startswith("//"))
  full = json.loads(text)
  train = full["train"]
  eval_dict = h7_eval_config(manifest, meshes_dir, "FG_BG")
  eval_dict["num_qualitative_results"] = 0
  train["data"]["datasets"] = [dict(train["data"]["datasets"][0],
                                    dataset_path=manifest,
                                    meshes_dir=meshes_dir)]
  train.update(resnet50_imagenet_checkpoint="", checkpoint_interval=8,
               persistent_checkpoint_interval=12, tensorboard_log_interval=4,
               fill_audit_interval=8)
  full["eval"] = [{"start_step": 8, "interval": 10 ** 6,
                   "persistent_checkpoint": False, "config": eval_dict}]
  full["output_path"] = os.path.join(root, "h7")
  full["string_templates"] = []
  return full


def train_cli(torch, mods, dev):
  """Phase 11: `corenet_tpu_torch.cli.train.main` on phase 7's seeded
  dataset with h7's train configuration in bf16: 3 steps (12 examples),
  then a second call resumes from the newest `.cpt` for one more. Checks
  the checkpoints' names and steps, the summaries, the eval's CSV, the
  model in train mode after the eval, and the launches of every step and
  eval batch. Returns the figures."""
  from corenet_tpu_torch.cli import train as train_cli_mod
  from corenet_tpu_torch.train import pipeline as pipeline_mod
  figures = {"step_s": [], "step_launches": [], "eval_s": []}
  real_make_step = pipeline_mod.make_train_step
  real_run_single = pipeline_mod.RecurrentEvals.run_single

  def counted_step(*args, **kwargs):
    step = real_make_step(*args, **kwargs)

    def wrapped(state, batch):
      torch.cuda.synchronize()
      counts = launch_counts(*mods)
      start = time.perf_counter()
      result = step(state, batch)
      torch.cuda.synchronize()
      figures["step_s"].append(time.perf_counter() - start)
      figures["step_launches"].append(tuple(
          a - b for a, b in zip(launch_counts(*mods), counts)))
      return result

    return wrapped

  def timed_eval(self, pipeline, eval_config, step):
    counts = launch_counts(*mods)
    start = time.perf_counter()
    miou = real_run_single(self, pipeline, eval_config, step)
    figures["eval_s"].append(time.perf_counter() - start)
    figures["eval_launches"] = tuple(
        a - b for a, b in zip(launch_counts(*mods), counts))
    figures["training_after_eval"] = pipeline.model.training
    figures["eval_miou"] = miou
    return miou

  with tempfile.TemporaryDirectory() as root:
    manifest, meshes_dir = write_eval_dataset(root, SEED + 50)
    full = h7_train_config(manifest, meshes_dir, root)
    path = os.path.join(root, "h7_train.json")
    with open(path, "w") as f:
      json.dump(full, f)
    out = full["output_path"]
    pipeline_mod.make_train_step = counted_step
    pipeline_mod.RecurrentEvals.run_single = timed_eval
    try:
      start = time.perf_counter()
      first = train_cli_mod.main([f"--config_path={path}", "--max_steps=12",
                                  "--compute_dtype=bfloat16"])
      torch.cuda.synchronize()
      first_s = time.perf_counter() - start
      start = time.perf_counter()
      second = train_cli_mod.main([f"--config_path={path}", "--max_steps=16"])
      torch.cuda.synchronize()
      second_s = time.perf_counter() - start
    finally:
      pipeline_mod.make_train_step = real_make_step
      pipeline_mod.RecurrentEvals.run_single = real_run_single

    def listing(tier):
      return sorted(os.listdir(os.path.join(out, "cpt", tier)))

    if (first.state.global_step, second.state.global_step) != (12, 16):
      raise AssertionError(f"the CLI stopped at {first.state.global_step} "
                           f"and {second.state.global_step}, not 12 and 16")
    if (listing("temp") != [f"state_{s:09d}.cpt" for s in (0, 8, 16)]
        or listing("persistent") != [f"state_{s:09d}.cpt" for s in (12, 16)]):
      raise AssertionError(f"checkpoints temp {listing('temp')}, persistent "
                           f"{listing('persistent')}")
    if not (first.model.compute_dtype == second.model.compute_dtype
            == torch.bfloat16 and first.model.phase_output):
      raise AssertionError("the CLI did not train the bf16 phase-loss model")

    def scalars(name):
      with open(os.path.join(out, "tb", name, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]

    losses = [(r["step"], r["value"]) for r in scalars("train")
              if r["tag"] == "loss"]
    eval_scalars = scalars("full_eval")
    if ([s for s, _ in losses] != [4, 8, 12, 16]
        or not all(math.isfinite(v) for _, v in losses)):
      raise AssertionError(f"train losses {losses}")
    if {r["step"] for r in eval_scalars} != {8}:
      raise AssertionError(f"eval scalars at {eval_scalars}")
    csv_path = os.path.join(out, "evals", "full_eval", "8",
                            "voxel_metrics.csv")
    with open(csv_path) as f:
      rows = list(csv.reader(f))
    if [r[0] for r in rows[1:]] != ["iou", "precision", "recall"]:
      raise AssertionError(f"voxel_metrics.csv rows {rows}")
    if not figures.get("training_after_eval"):
      raise AssertionError("the recurrent eval left the model in eval mode")
    if (len(figures["step_launches"]) != 4
        or set(figures["step_launches"]) != {(4, 4, 1, 1, 1)}):
      raise AssertionError(f"launches per step {figures['step_launches']}")
    batches = -(-EVAL_SCENES // BATCH)
    if figures["eval_launches"] != (4 * batches, 0, 0, batches, 0):
      raise AssertionError(f"eval launches {figures['eval_launches']}")
  figures.update(first_call_s=first_s, second_call_s=second_s,
                 losses=losses)
  log(f"train-cli: h7 in bf16 through cli.train.main, 12 examples then a "
      f"resume from state_000000012.cpt to 16: checkpoints temp (0, 8, 16) "
      f"and persistent (12, 16); losses {losses}; launches per step "
      f"{figures['step_launches'][0]} in all 4 steps; seconds per step "
      + ", ".join(f"{s:.3f}" for s in figures["step_s"]) +
      f"; the recurrent eval at step 8: mean IoU {figures['eval_miou']:.6f}, "
      f"{figures['eval_s'][0]:.2f} s, launches {figures['eval_launches']} "
      f"over {batches} batches, the model back in train mode; calls "
      f"{first_s:.1f} s and {second_s:.1f} s")
  return figures


# Phase 12: packed (space-to-depth) execution against the fine decoder.
# Packed logits lie within this share of max|logit| of the fine ones, both
# in float32 (TF32 off): they agree to about 3e-6 on the H100. The JAX
# package's envelope, 2e-3 (corenet_tpu/eval/super_resolution.py:118-122),
# covers the TPU's bf16 matrix units.
PACKED_LOGIT_TOL = 1e-5
# The eval CLI's mean IoU, packed against fine on the same weights: the
# envelope moves only voxels at the decision boundary.
PACKED_IOU_TOL = 1e-3
# The decoder's executions that phase 12 compares: CoreNet's
# packed_decoder and super_resolution's packed_execution.
EXECUTIONS = {"fine": False, "packed pfs 5": True}


def packed_logit_check(torch, CoreNet, config, state, label, image, v2s,
                       offsets, dev):
  """Eval-mode logits of the packed execution against the fine one's, on
  the card with deterministic cuDNN: within PACKED_LOGIT_TOL·max|logit|.
  Returns the share."""
  logits = {}
  torch.backends.cudnn.deterministic = True
  try:
    for name, packed in EXECUTIONS.items():
      model = CoreNet(config, packed_decoder=packed, device=dev)
      model.load_state_dict(state)
      with torch.inference_mode():
        logits[name] = model.eval()(image, v2s, offsets)
      del model
  finally:
    torch.backends.cudnn.deterministic = False
  ref = logits["fine"]
  scale = float(ref.abs().max())
  share = float((logits["packed pfs 5"] - ref).abs().max()) / scale
  if not share <= PACKED_LOGIT_TOL:
    raise AssertionError(f"{label}: packed logits differ from the fine ones "
                         f"by {share} of max|logit| {scale} (tolerance "
                         f"{PACKED_LOGIT_TOL})")
  log(f"{label}: logits {list(ref.shape)}, packed against fine: "
      f"{share:.2e} of max|logit| {scale:.3f} (tolerance "
      f"{PACKED_LOGIT_TOL})")
  return share


def packed_serving(torch, op, CoreNet, CoreNetConfig, DecoderConfig, image,
                   camera, v2x, offsets, dev):
  """h7 (128³, batch 4) and y1 (32³ → 128³, 64 passes in one batch)
  serving, float32, in each of EXECUTIONS: logits against the fine ones,
  then the timed forwards. Returns {path: {execution: figures}}."""
  from corenet_tpu_torch.eval.super_resolution import (
      SuperResolutionInference, super_resolution_from_model)
  from corenet_tpu_torch.train.step import compute_v2s
  args = (image, camera, v2x, offsets, OUTPUT_RES)
  out = {}
  for path, native, seed in (("h7", OUTPUT_RES, SEED), ("y1", Y1_NATIVE,
                                                        SEED + 10)):
    config = CoreNetConfig(DecoderConfig(native, 2))
    _, state = seeded_model(torch, CoreNet, config, seed)
    m = OUTPUT_RES[0] // native[0]
    v2s = compute_v2s(camera.to(dev), v2x.to(dev) * torch.tensor(
        [1 / m, 1 / m, 1 / m, 1.0], device=dev))
    sample = SuperResolutionInference(None, native, dev).get_native_offsets(
        OUTPUT_RES, offsets.to(dev))[0]
    rows = {"logit_share": packed_logit_check(
        torch, CoreNet, config, state, f"packed {path}", image.to(dev), v2s,
        sample, dev)}
    for name, packed in EXECUTIONS.items():
      infer = super_resolution_from_model(
          CoreNet(config), state, native, packed_execution=packed,
          device="cuda")
      _, rows[name] = serve(torch, op, f"{path} {name}", infer, args,
                            (BATCH,) + OUTPUT_RES + (2,))
      del infer
      torch.cuda.empty_cache()
    out[path] = rows
  return out


def depth_to_space_64(logits, nc):
  """Factor-64 logits [B, D/4, H/4, W/4, 64·C], channel order (rm0, rm1,
  rm2, pz, py, px, c), → fine [B, D, H, W, C]."""
  b, dq, hq, wq, _ = logits.shape
  x = logits.reshape(b, dq, hq, wq, 2, 2, 2, 2, 2, 2, nc)
  x = x.permute(0, 1, 4, 7, 2, 5, 8, 3, 6, 9, 10)
  return x.reshape(b, 4 * dq, 4 * hq, 4 * wq, nc)


@contextlib.contextmanager
def caught_calls(module, name, record):
  """Wraps module.name to append each call's arguments to `record`."""
  real = getattr(module, name)

  def wrapped(*args, **kwargs):
    record.append((args, kwargs))
    return real(*args, **kwargs)

  setattr(module, name, wrapped)
  try:
    yield
  finally:
    setattr(module, name, real)


def packed_training(torch, mods, CoreNet, config, batch, label, dtype,
                    **execution):
  """h7 training on GT voxelized in the step with the phase loss, in
  `dtype`. The first step's launches (and, for a packed decoder, K4's
  phase factor and the backward's packed-order launches), then, packed,
  the kernel step against the plain step, the phase loss against the plain
  loss on the unpacked logits and a falling loss; then TRAIN_RUNS timed
  steps with a profile. Returns the figures."""
  from corenet_tpu_torch.models.losses import iou_fgbg
  from corenet_tpu_torch.train import gt
  from corenet_tpu_torch.train.state import create_train_state
  from corenet_tpu_torch.train.step import compute_v2s, make_train_step
  from corenet_tpu_torch.voxel.packed import unpack_grid
  op, fgbg, scatter, phased = mods
  bf16 = dtype == torch.bfloat16
  packed = execution.get("packed_decoder", False)
  model, _ = seeded_model(torch, CoreNet, config, SEED + 40,
                          phase_output=True,
                          compute_dtype=dtype if bf16 else None, **execution)
  state = create_train_state(model, device=batch["image"].device)
  step = make_train_step(state.model, state.optimizer, "FG_BG", OUTPUT_RES,
                         voxelization_kwargs=H7_VOX)
  phasings, backwards = [], []
  torch.cuda.synchronize()
  zero_counts(*mods)
  start = time.perf_counter()
  with caught_calls(phased, "phased_gt_forward", phasings), \
      caught_calls(op, "skip_gather_backward", backwards):
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
  first_s = time.perf_counter() - start
  launches = launch_counts(*mods)
  s_factors = [args[1] for args, _ in phasings]
  packed_order = sum(1 for args, _ in backwards if args[0].dim() == 4)
  expected_s = [4] if packed else [2]
  if (launches != (4, 4, 1, 1, 1) or s_factors != expected_s
      or packed_order != (1 if packed else 0)):
    raise AssertionError(
        f"{label} step launched (skip_gather, its backward, fgbg_sums, "
        f"block_scatter_or, phased_gt) {launches} times, phased_gt at s = "
        f"{s_factors}, {packed_order} backwards in packed order; expected "
        f"(4, 4, 1, 1, 1), s = {expected_s}, {1 if packed else 0}")
  first_loss = float(metrics["loss"])
  bad = [n for n, p in state.model.named_parameters()
         if p.grad is None or p.grad.dtype != torch.float32
         or not bool(torch.isfinite(p.grad).all())]
  if not math.isfinite(first_loss) or bad:
    raise AssertionError(f"{label}: loss {first_loss}, non-finite, missing "
                         f"or non-float32 gradients {bad[:5]}")
  log(f"{label}: first step {first_s:.3f} s, loss {first_loss:.6f}, "
      f"launches {launches}, phased_gt at s = {s_factors}, {packed_order} "
      "backward(s) in packed order; loss and gradients finite (float32)")
  out = {"launches": launches, "phased_gt_s": s_factors,
         "packed_order_backwards": packed_order, "first_s": first_s,
         "first_loss": first_loss}
  if packed:
    loss_rel, grad_worst, grad_rel = compare_with_plain_step(
        torch, mods, state, step, batch, label, bf16=bf16)
    out.update(plain_loss_rel=loss_rel, plain_grads_rel=grad_rel,
               plain_worst_grad_rel=grad_worst)
    # The phase loss on the factor-64 logits against the plain loss on the
    # same logits unpacked, eval mode (no statistics move).
    packed_or, v2x = gt.voxelize_batch_packed_fgbg(
        *(batch[k] for k in GT_KEYS), resolution=OUTPUT_RES, **H7_VOX)
    v2s = compute_v2s(batch["camera"], v2x)
    with torch.inference_mode():
      logits = state.model.eval()(batch["image"], v2s, batch["grid_offset"])
      b, dq, hq = logits.shape[:3]
      phase_loss = float(iou_fgbg(phased.phased_gt(packed_or, 4),
                                  logits.reshape(b, dq, hq, -1, 2)))
      plain_loss = float(iou_fgbg(unpack_grid(packed_or, dtype=torch.uint8),
                                  depth_to_space_64(logits, 2)))
    state.model.train()
    rel = abs(phase_loss - plain_loss) / abs(plain_loss)
    if rel > 1e-6:
      raise AssertionError(f"{label}: the phase loss {phase_loss} on "
                           f"factor-64 logits and the plain loss "
                           f"{plain_loss} on the unpacked ones differ by "
                           f"{rel} relative")
    log(f"{label}: the phase loss on factor-64 logits {list(logits.shape)} "
        f"{phase_loss:.7f} equals the plain loss on the unpacked logits "
        f"{plain_loss:.7f} ({rel:.2e} relative; tolerance 1e-6)")
    out["phase_loss_rel"] = rel
    del logits
    state = loss_steps(state, step, batch, first_loss, label)
  _, timed = timed_training(torch, label, step, state, batch)
  out.update(timed)
  return out


def packed_backward_row(torch, op, v2s, sample, gen, fine_rows):
  """K1's backward in packed voxel order at h7's skip 5 (batch 4, 64³
  fine, 12 channels), f32 and bf16, dout in the packed step's layout (the
  skip's slice of the per-phase concatenation's gradient): kernel against
  the float64 scatter-add, its time beside the fine order's (`fine_rows`,
  phase 2), the plain version's, index_add_'s, the bound, the run lengths
  along z, and the time of the copy to contiguous it does not need."""
  from corenet_tpu_torch.models import skip
  dev = v2s.device
  b = v2s.shape[0]
  div, h2, c = SKIPS[5]
  fine = (OUTPUT_RES[0] // div,) * 3
  half = tuple(v // 2 for v in fine)
  m = half[0] * half[1] * half[2]
  matrix = v2s * torch.tensor([div, div, div, 1.0], device=dev)
  px, py = skip.voxel_pixel_indices(matrix, sample, fine, h2 - 2, h2 - 2,
                                    packed=True)
  fine_px, fine_py = skip.voxel_pixel_indices(matrix, sample, fine, h2 - 2,
                                              h2 - 2)
  mean_run, chunk, flushes = column_runs(
      torch, op, px.view(b * 8, m), py.view(b * 8, m), h2, half, c)
  fine_run, _, _ = column_runs(torch, op, fine_px, fine_py, h2, fine, c)
  bidx = torch.arange(b, device=dev)[:, None]
  flat = (bidx * h2 * h2 + py.long() * h2 + px.long()).reshape(-1)
  cx = TOWER_CHANNELS[5]
  rows = []
  for dtype in (torch.float32, torch.bfloat16):
    dout = torch.randn((b, 8, m, c), generator=gen).to(dev, dtype)
    cat_grad = torch.zeros((b, 8, cx + c) + half, device=dev, dtype=dtype)
    cat_grad[:, :, cx:] = dout.view((b, 8) + half + (c,)).permute(
        0, 1, 5, 2, 3, 4)
    step = cat_grad[:, :, cx:].permute(0, 1, 3, 4, 5, 2).reshape(b, 8, m, c)
    if step.stride() != (8 * (cx + c) * m, (cx + c) * m, 1, m):
      raise AssertionError(f"the packed step's layout has strides "
                           f"{step.stride()}")
    got = op.skip_gather_backward(step, px, py, h2, h2, grid_resolution=half)
    plain = op.skip_gather_backward_reference(dout, px, py, h2, h2)
    ref64 = op.skip_gather_backward_reference(dout.double(), px, py, h2, h2)
    mass = op.skip_gather_backward_reference(dout.double().abs(), px, py, h2,
                                             h2)
    torch.cuda.synchronize()
    bound = 1e-5 * mass + 1e-30
    if dtype == torch.bfloat16:
      bound = bound + bf16_ulp(torch, ref64)
    for what, out in (("kernel", got), ("plain version", plain)):
      excess = float(((out.double() - ref64).abs() - bound).max())
      if excess > 0:
        raise AssertionError(f"skip_gather backward in packed order "
                             f"({what}) exceeds its bound by {excess} "
                             f"({dtype})")
    es = dout.element_size()
    nbytes = b * 8 * m * (c * es + 8) + b * h2 * h2 * c * es
    dout2d = dout.reshape(-1, c)
    name = str(dtype).replace("torch.", "")
    row = {
        "stage": 5, "dtype": name, "dfmap": [b, h2, h2, c],
        "dout": [b, 8, m, c], "dout_strides": list(step.stride()),
        "grid_per_phase": list(half), "bytes": nbytes,
        "mean_run_along_z": mean_run, "fine_mean_run_along_z": fine_run,
        "z_chunk": chunk, "flushes": flushes,
        "max_abs_err": float((got.float() - plain.float()).abs().max()),
        "ms": device_ms(torch, lambda: op.skip_gather_backward(
            step, px, py, h2, h2, grid_resolution=half)),
        "fine_order_ms": next(r["ms"] for r in fine_rows
                              if r["stage"] == 5 and r["dtype"] == name),
        "copy_ms": device_ms(torch, lambda: step.contiguous()),
        "plain_ms": device_ms(torch, lambda: op.
                              skip_gather_backward_reference(
                                  dout, px, py, h2, h2)),
        "library_ms": device_ms(torch, lambda: torch.zeros(
            (b * h2 * h2, c), device=dev, dtype=dtype).index_add_(
                0, flat, dout2d)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
    }
    rows.append(row)
    log(f"skip_gather backward in packed order, stage 5 {name} "
        f"[{b},8,{m},{c}] strides {tuple(step.stride())}: kernel "
        f"{row['ms']:.4f} ms (fine order {row['fine_order_ms']:.4f}), plain "
        f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}, bound "
        f"{row['bound_ms']:.4f} ms ({nbytes} B); copy to contiguous not "
        f"made ({row['copy_ms']:.4f} ms); mean run along z {mean_run:.3f} "
        f"(fine order {fine_run:.3f}), z chunk {chunk}, flushes {flushes}")
  return rows


def phased_gt_s4_row(torch, phased, batch):
  """K4 at s = 4 at h7 training's shapes (the phase-6 triangle batch's
  packed GT): kernel against plain bit for bit, times, bytes bound."""
  from corenet_tpu_torch.train import gt
  packed_or, _ = gt.voxelize_batch_packed_fgbg(
      *(batch[k] for k in GT_KEYS), resolution=OUTPUT_RES, **H7_VOX)
  got = phased.phased_gt(packed_or, 4)
  plain = phased.phased_gt_reference(packed_or, 4)
  torch.cuda.synchronize()
  if not torch.equal(got, plain):
    raise AssertionError("phased_gt at s = 4 differs from its plain "
                         "version at the step's shapes")
  nbytes = packed_or.numel() * 4 + got.numel()
  row = {"s": 4, "packed": list(packed_or.shape), "out": list(got.shape),
         "bytes": nbytes, "max_abs_err": 0.0,
         "ms": device_ms(torch, lambda: phased.phased_gt(packed_or, 4)),
         "s2_ms": device_ms(torch, lambda: phased.phased_gt(packed_or, 2)),
         "plain_ms": device_ms(
             torch, lambda: phased.phased_gt_reference(packed_or, 4)),
         "library_ms": None, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
  log(f"phased_gt at s = 4 {list(packed_or.shape)} -> {list(got.shape)}: "
      f"kernel {row['ms']:.4f} ms (s = 2: {row['s2_ms']:.4f}), plain "
      f"{row['plain_ms']:.4f} ms, library none, bound {row['bound_ms']:.4f}"
      f" ms ({nbytes} B); equal bit for bit")
  return row


def packed_clis(torch, mods, CoreNet, config, dev):
  """The train CLI with --decoder_execution=packed (4 steps of h7 in bf16
  on phase 7's seeded dataset, no recurrent eval) and the eval CLI with
  --packed_inference against --nopacked_inference (phase 7's eval, no
  tiles) on a `.cpt` of the seeded h7 model."""
  from corenet_tpu_torch.cli import eval as eval_cli
  from corenet_tpu_torch.cli import train as train_cli_mod
  from corenet_tpu_torch.config import config as cfg
  from corenet_tpu_torch.data.manager import DatasetManager
  from corenet_tpu_torch.ops import phased_gt as phased
  from corenet_tpu_torch.train import pipeline as pipeline_mod
  from corenet_tpu_torch.train.checkpoint import CheckpointManager
  from corenet_tpu_torch.train.state import create_train_state
  out = {"step_launches": [], "step_s": []}
  batches = -(-EVAL_SCENES // BATCH)
  real_make_step = pipeline_mod.make_train_step

  def counted_step(*args, **kwargs):
    step = real_make_step(*args, **kwargs)

    def wrapped(state, batch):
      torch.cuda.synchronize()
      counts = launch_counts(*mods)
      start = time.perf_counter()
      result = step(state, batch)
      torch.cuda.synchronize()
      out["step_s"].append(time.perf_counter() - start)
      out["step_launches"].append(tuple(
          a - b for a, b in zip(launch_counts(*mods), counts)))
      return result

    return wrapped

  with tempfile.TemporaryDirectory() as root:
    manifest, meshes_dir = write_eval_dataset(root, SEED + 50)
    full = h7_train_config(manifest, meshes_dir, root)
    full["eval"] = []
    full["train"].update(checkpoint_interval=10 ** 6,
                         persistent_checkpoint_interval=10 ** 6)
    path = os.path.join(root, "h7_train.json")
    with open(path, "w") as f:
      json.dump(full, f)
    phasings = []
    pipeline_mod.make_train_step = counted_step
    try:
      with caught_calls(phased, "phased_gt_forward", phasings):
        start = time.perf_counter()
        trained = train_cli_mod.main([f"--config_path={path}",
                                      "--max_steps=16",
                                      "--decoder_execution=packed"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - start
    finally:
      pipeline_mod.make_train_step = real_make_step
    s_factors = sorted({args[1] for args, _ in phasings})
    if not (trained.model.packed_decoder and trained.model.phase_output
            and trained.model.compute_dtype == torch.bfloat16
            and trained.state.global_step == 16
            and out["step_launches"] == [(4, 4, 1, 1, 1)] * 4
            and s_factors == [4]):
      raise AssertionError(
          f"the packed train CLI: packed {trained.model.packed_decoder}, "
          f"step {trained.state.global_step}, launches "
          f"{out['step_launches']}, phased_gt at s = {s_factors}")
    log(f"packed train CLI: 4 steps of h7 in bf16 with "
        f"--decoder_execution=packed in {train_s:.1f} s; launches "
        f"{out['step_launches'][0]} every step, phased_gt at s = 4; seconds "
        "per step " + ", ".join(f"{v:.3f}" for v in out["step_s"]))
    out["train_call_s"] = train_s
    del trained
    torch.cuda.empty_cache()

    eval_dict = h7_eval_config(manifest, meshes_dir, "FG_BG")
    eval_dict["num_qualitative_results"] = 0
    model, _ = seeded_model(torch, CoreNet, config, SEED)
    full_config = {
        "string_templates": [], "output_path": os.path.join(root, "train"),
        "train": {"data": eval_dict["data"],
                  "resnet50_imagenet_checkpoint": ""},
        "eval": [{"start_step": 0, "interval": 10 ** 9,
                  "persistent_checkpoint": False, "config": eval_dict}]}
    classes = list(DatasetManager(cfg.config_from_dict(
        cfg.EvalConfig, eval_dict).data).classes)
    cpt = CheckpointManager(os.path.join(root, "cpt")).save_state(
        create_train_state(model, device=dev),
        {"full_config": full_config, "classes": classes})
    ious = {}
    for flag in ("--packed_inference", "--nopacked_inference"):
      zero_counts(*mods)
      start = time.perf_counter()
      ious[flag] = eval_cli.main([f"--checkpoint_path={cpt}",
                                  f"--output_path={root}/{flag[2:]}",
                                  flag])["full_eval"]
      torch.cuda.synchronize()
      out[f"eval{flag[1:]}_s"] = time.perf_counter() - start
      launches = launch_counts(*mods)
      if launches != (4 * batches, 0, 0, batches, 0):
        raise AssertionError(f"the eval CLI with {flag} launched {launches}")
    diff = abs(ious["--packed_inference"] - ious["--nopacked_inference"])
    if not diff <= PACKED_IOU_TOL:
      raise AssertionError(f"the eval CLI's mean IoU packed "
                           f"{ious['--packed_inference']} and fine "
                           f"{ious['--nopacked_inference']} differ by {diff}")
    log(f"packed eval CLI: mean IoU {ious['--packed_inference']:.6f} with "
        f"--packed_inference, {ious['--nopacked_inference']:.6f} with "
        f"--nopacked_inference (difference {diff:.2e}, tolerance "
        f"{PACKED_IOU_TOL}); K1 {4 * batches} and K3 {batches} launches in "
        f"{batches} batches each")
    out.update(eval_iou=ious, eval_iou_diff=diff)
  return out


def packed_phase(torch, mods, CoreNet, CoreNetConfig, DecoderConfig, image,
                 camera, v2x, offsets, dev, fine_bwd_rows):
  """Phase 12: packed (space-to-depth) execution against the fine
  decoder. Returns the figures and the two new kernel rows."""
  op, fgbg, scatter, phased = mods
  h7 = CoreNetConfig(DecoderConfig(OUTPUT_RES, 2))
  start = time.perf_counter()
  out = {"serve": packed_serving(torch, op, CoreNet, CoreNetConfig,
                                 DecoderConfig, image, camera, v2x, offsets,
                                 dev)}
  torch.cuda.empty_cache()
  host, _ = triangle_batch(torch, image, camera, SEED + 41)
  batch = {k: v.to(dev) for k, v in host.items()}
  train = {}
  for dtype in (torch.bfloat16, torch.float32):
    for name, packed in EXECUTIONS.items():
      key = f"{name}, {str(dtype).replace('torch.', '')}"
      train[key] = packed_training(torch, mods, CoreNet, h7, batch,
                                   f"h7 train {key}", dtype,
                                   packed_decoder=packed)
      torch.cuda.empty_cache()
  out["train"] = train
  from corenet_tpu_torch.train.step import compute_v2s
  v2s = compute_v2s(camera.to(dev), v2x.to(dev))
  gen = torch.Generator().manual_seed(SEED + 120)
  out["k1_bwd_packed"] = packed_backward_row(torch, op, v2s, offsets.to(dev),
                                             gen, fine_bwd_rows)
  out["k4_s4"] = phased_gt_s4_row(torch, phased, batch)
  del batch
  torch.cuda.empty_cache()
  out["clis"] = packed_clis(torch, mods, CoreNet, h7, dev)
  out["seconds"] = time.perf_counter() - start
  log(f"packed phase: {out['seconds']:.1f} s")
  return out


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
        out = op.skip_gather(fmap, px, py, (layer,) * 3)
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
            "ms": device_ms(torch, lambda: op.skip_gather(
                fmap, px, py, (layer,) * 3)),
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
  per_forward_bf16 = {
      key: sum(row[key] for row in shapes
               if row["path"] == "h7" and row["dtype"] == "bfloat16")
      for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
  log("skip_gather per h7 forward on the bf16 path (bfloat16, 4 launches): "
      + ", ".join(f"{key} {value:.4f}"
                  for key, value in per_forward_bf16.items()))
  for path, sums in per_forward.items():
    log(f"skip_gather per {path} forward (float32, 4 launches): " +
        ", ".join(f"{key} {value:.4f}" for key, value in sums.items()))

  # 3. Serving, h7.
  h7, h7_state = seeded_model(
      torch, CoreNet, CoreNetConfig(DecoderConfig(OUTPUT_RES, 2)), SEED)
  infer = super_resolution_from_model(h7, h7_state, OUTPUT_RES, device="cuda")
  main_launches, h7_serve = serve(torch, op, "h7", infer, args,
                               (BATCH,) + OUTPUT_RES + (2,))
  check_plain_skips(torch, op, fgbg, "h7", infer, args)
  del h7, infer
  torch.cuda.empty_cache()

  # 4. y1: 32³ native → 128³, 64 passes folded into one decode.
  y1_config = CoreNetConfig(DecoderConfig(Y1_NATIVE, 2))
  y1, y1_state = seeded_model(torch, CoreNet, y1_config, SEED + 10)
  infer = super_resolution_from_model(y1, y1_state, Y1_NATIVE, device="cuda")
  _, y1_serve = serve(torch, op, "y1", infer, args,
                     (BATCH,) + OUTPUT_RES + (2,))
  check_plain_skips(torch, op, fgbg, "y1", infer, args)
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
  card_model = copy.deepcopy(cpu_model).to(dev)
  with torch.inference_mode():
    ref = cpu_model.eval()(small_image, small_v2s, small_off)
    got = card_model.eval()(small_image.to(dev), small_v2s.to(dev),
                            small_off.to(dev)).cpu()
  scale = float(ref.abs().max())
  cpu_diff = float((got - ref).abs().max())
  if not torch.allclose(got, ref, rtol=2e-3, atol=2e-3 * scale):
    raise AssertionError(f"card and CPU logits differ by {cpu_diff} "
                         f"(max |logit| {scale})")
  log(f"y1 logits on the card match the CPU within {cpu_diff:.2e} "
      f"(max |logit| {scale:.4f}; tolerance 2e-3 relative)")
  del y1, y1_state, cpu_model, card_model, ref, got
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
  mods = (op, fgbg, scatter, phased)
  gt_launches, k3_row, k4_row, gt_split = train_gt_h7(
      torch, mods, CoreNet, CoreNetConfig(DecoderConfig(OUTPUT_RES, 2)),
      image, camera, dev)
  torch.cuda.empty_cache()

  # 7. Eval, h7's full_eval through EvalPipeline.
  eval_launches, eval_times = eval_h7(torch, mods, CoreNet, CoreNetConfig,
                                      DecoderConfig, dev)
  torch.cuda.empty_cache()

  # 8. y1 training on the general GT, as TrainPipeline builds the model for
  # y1 (latent 64, skip fraction 0.75, the phase loss), then the parity GT.
  y1_launches, y1_split = train_y1(
      torch, mods, CoreNet, CoreNetConfig(DecoderConfig(
          Y1_NATIVE, 2, last_upscale_factor=2, latent_channels=64,
          skip_fraction=0.75)), image, camera, dev)
  parity = parity_row(torch, image, camera, dev)
  torch.cuda.empty_cache()

  # 9. Serving from a checkpoint file: the eval and demo CLIs.
  cli_launches, cli_times = serve_cli(
      torch, mods, CoreNet, CoreNetConfig(DecoderConfig(OUTPUT_RES, 2)),
      image, camera, v2x, dev)
  torch.cuda.empty_cache()

  # 10. Training in bf16 (the JAX pipeline's default compute dtype).
  bf16 = train_bf16(torch, mods, CoreNet, CoreNetConfig, DecoderConfig,
                    image, camera, v2x, offsets, dev)
  torch.cuda.empty_cache()

  # 11. The train CLI: h7 in bf16 with a recurrent eval, then a resume.
  train_cli_figures = train_cli(torch, mods, dev)
  torch.cuda.empty_cache()

  # 12. Packed (space-to-depth) execution against the fine decoder.
  packed = packed_phase(torch, mods, CoreNet, CoreNetConfig, DecoderConfig,
                        image, camera, v2x, offsets, dev, bwd_rows)

  # Launches per path, each counted from zero just before the path ran:
  # one serving forward, one training step, one eval run of 3 batches, one
  # eval CLI run of 3 batches.
  def by_path(i, serve=None, train=None):
    return {"h7 serve, 1 forward": serve, "h7 train, 1 step": train,
            "h7 train-gt, 1 step": gt_launches[i],
            f"h7 eval, {-(-EVAL_SCENES // BATCH)} batches": eval_launches[i],
            "y1 train, 1 step": y1_launches[i],
            f"h7 eval CLI, {-(-EVAL_SCENES // BATCH)} batches":
                cli_launches[i],
            "h7 train-bf16 (GT in step), 1 step":
                bf16["h7_gt"]["launches"][i],
            "h7 train-bf16 (host GT), 1 step":
                bf16["h7_host"]["launches"][i],
            "y1 train-bf16, 1 step": bf16["y1"]["launches"][i],
            "h7 train CLI, 1 step":
                train_cli_figures["step_launches"][0][i],
            f"h7 train CLI eval, {-(-EVAL_SCENES // BATCH)} batches":
                train_cli_figures["eval_launches"][i],
            "h7 train packed bf16 (GT in step), 1 step":
                packed["train"]["packed pfs 5, bfloat16"]["launches"][i]}

  h7_sums = per_forward["h7"]
  entry = {
      "name": "skip_gather",
      "route": "cuda",
      "source": "corenet_tpu_torch/csrc/skip_gather.cu",
      "replaces": "corenet_tpu/ops/skip_gather.py:128",
      "launches": main_launches,
      "launches_by_path": by_path(0, main_launches, train_launches[0]),
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
      # The bf16 path (phase 10): the h7 forward's four skips in bf16.
      "per_forward_bfloat16_h7": per_forward_bf16,
      "shapes": shapes,
  }
  bwd_f32 = [row for row in bwd_rows if row["dtype"] == "float32"]
  bwd_entry = {
      "name": "skip_gather_bwd",
      "route": "cuda",
      "source": "corenet_tpu_torch/csrc/skip_gather.cu",
      "replaces": "corenet_tpu/ops/skip_gather.py:139",
      "launches": train_launches[1],
      "launches_by_path": by_path(1, 0, train_launches[1]),
      "max_abs_err": max(row["max_abs_err_vs_plain"] for row in bwd_rows),
      # Per h7 training step in float32: the sum over its four skips, the
      # kernel in the step's layout.
      **{key: sum(row[key] for row in bwd_f32)
         for key in ("ms", "plain_ms", "bound_ms", "library_ms", "copy_ms",
                     "zero_ms", "ms_contiguous", "flushes",
                     "atomics_first_version")},
      "bound_by": "bytes",
      "library_call": "torch.zeros(...).index_add_(0, flat_index, dout)",
      # The bf16 path (phase 10): the four skips in bf16, the kernel in the
      # step's layout; the library call accumulates in bf16 there.
      "per_step_bfloat16": {
          key: sum(row[key] for row in bwd_rows
                   if row["dtype"] == "bfloat16")
          for key in ("ms", "plain_ms", "bound_ms", "library_ms", "zero_ms",
                      "ms_contiguous")},
      "timing": entry["timing"],
      "shapes": bwd_rows,
  }
  log("skip_gather backward per h7 step on the bf16 path (bfloat16, step's "
      "layout, 4 launches): " + ", ".join(
          f"{key} {value:.4f}"
          for key, value in bwd_entry["per_step_bfloat16"].items()))
  int32_row = loss_rows[0]
  fgbg_entry = {
      "name": "fgbg_sums",
      "route": "cuda",
      "source": "corenet_tpu_torch/csrc/fgbg_sums.cu",
      "replaces": "corenet_tpu/ops/fgbg_loss.py:62",
      "launches": train_launches[2],
      "launches_by_path": by_path(2, 0, train_launches[2]),
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
       "launches_by_path": by_path(index, 0, 0),
       **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms")},
       "bound_by": "bytes", "library_ms": None, "library_call": None,
       "timing": entry["timing"], "shapes": [row]}
      for name, source, replaces, index, launches, row in (
          ("block_scatter_or", "block_scatter",
           "corenet_tpu/ops/block_scatter.py:219", 3, gt_launches[3], k3_row),
          ("phased_gt", "phased_gt", "corenet_tpu/ops/phased_gt.py:128", 4,
           gt_launches[4], k4_row))]
  packed_train = packed["train"]["packed pfs 5, bfloat16"]
  k1p = {row["dtype"]: row for row in packed["k1_bwd_packed"]}
  k4 = packed["k4_s4"]
  packed_entries = [
      {"name": "skip_gather_bwd (packed voxel order)", "route": "cuda",
       "source": "corenet_tpu_torch/csrc/skip_gather.cu",
       "replaces": "corenet_tpu/ops/skip_gather.py:139",
       # Per packed h7 step (bf16, the JAX default): skip 5's backward.
       "launches": packed_train["packed_order_backwards"],
       "max_abs_err": max(row["max_abs_err"] for row in k1p.values()),
       **{key: k1p["float32"][key]
          for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                      "fine_order_ms", "copy_ms", "mean_run_along_z",
                      "fine_mean_run_along_z")},
       "bound_by": "bytes",
       "library_call": "torch.zeros(...).index_add_(0, flat_index, dout)",
       "bfloat16": {key: k1p["bfloat16"][key]
                    for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                                "fine_order_ms", "copy_ms")},
       "timing": entry["timing"], "shapes": packed["k1_bwd_packed"]},
      {"name": "phased_gt (s = 4)", "route": "cuda",
       "source": "corenet_tpu_torch/csrc/phased_gt.cu",
       "replaces": "corenet_tpu/ops/phased_gt.py:128",
       "launches": packed_train["phased_gt_s"].count(4),
       **{key: k4[key] for key in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "library_ms", "s2_ms")},
       "bound_by": "bytes", "library_call": None,
       "timing": entry["timing"], "shapes": [k4]}]
  entry["serve"] = {"h7": h7_serve, "y1": y1_serve}
  entry["packed"] = {key: packed[key] for key in ("serve", "train", "clis",
                                                  "seconds")}
  gt_entries[0]["gt_split"] = gt_split
  gt_entries[0]["eval_h7"] = eval_times
  gt_entries[0]["serve_cli"] = cli_times
  entry["y1_general_gt_split"] = y1_split
  entry["parity_gt_128"] = parity
  entry["train_bf16"] = bf16
  entry["train_cli"] = {k: v for k, v in train_cli_figures.items()
                        if k != "losses"}
  log(f"h7 scenes/s {h7_serve['scenes_per_s']:.3f}; y1 scenes/s "
      f"{y1_serve['scenes_per_s']:.3f} (median of {SERVE_RUNS} forwards); h7 "
      f"training scenes/s {BATCH * 1e3 / train_ms:.3f} on host GT, "
      f"{BATCH * 1e3 / gt_split['step_ms']:.3f} on GT voxelized in the step, "
      f"y1 training scenes/s {BATCH * 1e3 / y1_split['step_ms']:.3f} on the "
      f"general GT (medians of {TRAIN_RUNS} steps); h7 eval scenes/s "
      f"{BATCH * 1e3 / eval_times['median_batch_ms']:.3f} (median of "
      f"{len(eval_times['batch_ms'])} batches); in bf16 h7 training "
      f"scenes/s {BATCH * 1e3 / bf16['h7_gt']['median_ms']:.3f} on GT "
      f"voxelized in the step, {BATCH * 1e3 / bf16['h7_host']['median_ms']:.3f}"
      f" on host GT, y1 {BATCH * 1e3 / bf16['y1']['median_ms']:.3f}; h7 "
      f"float32 with TF32 "
      f"{BATCH * 1e3 / bf16['h7_gt_tf32']['median_ms']:.3f}")
  log(smi)
  log(json.dumps({"kernels": [entry, bwd_entry, fgbg_entry] + gt_entries
                  + packed_entries}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": kind,
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
