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
              Times 15 forwards one by one (closed loop, one batch in
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
              Times 10 steps one by one and profiles one more. Then one
              step at 32³ on the card against the same step on the CPU.
  6. train-gt h7 training as the JAX package trains by default: ground
              truth voxelized in the step from the batch's triangles
              (the blocked rasterizer, one CUDA kernel from triangles to
              OR-ed words (blocked_raster_or), the packed fill, the OR
              over labeled mesh slots) and phased
              by the CUDA phased_gt (s = 2) for the phase loss on
              phase-major logits; h7's voxelization settings (irm 8, no
              conservative rasterization, adaptive fill, a 24-pixel
              window). Each scene: slot 0 a cube shell at [0.3, 0.7]³
              moved by a seeded offset of at most 0.05, subdivided to
              12,288 triangles; slot 1 a seeded closed sphere (~1.5k
              triangles), label 0 in the last scene; padded to 16,384.
              Checks 1 + 1 + 4 + 4 + 1 launches per step
              (blocked_raster_or, phased_gt, skip_gather, its backward,
              fgbg_sums), no launch of the standalone block_scatter_or and
              no call of phase A's tensor code, the step's phased GT
              against the plain phase A + scatter + fill + unpack +
              permute on the card and the card's packed GT against the
              CPU's (two scenes, bit for bit), finite loss and gradients,
              a falling loss, the kernel step against the plain step, and
              the phase loss against the plain loss on the same grid.
              Holds blocked_raster_or to its plain version (phase A + the
              scatter's plain version) bit for bit on the step's 4 scenes,
              on a space rank's 2 and on an edge batch (irm 1,
              conservative, zero-area, clipped and invalid triangles),
              and the standalone block_scatter_or to its own; times them,
              K4 at s = 2 and 4 on 2 and 4 scenes, the GT's parts beside
              the plain composition's (phase A + block_scatter_or), 10
              steps, the peak memory by part of a step, and profiles one
              more.
  7. eval     h7's full_eval through EvalPipeline.run_eval: a seeded
              dataset written to a temporary directory (a manifest of two
              classes, mesh NPZs of the cube shell and seeded spheres, 10
              scene NPZs with 256² images stored as uint8 arrays, one or
              two meshes per scene), the configuration built from a dict
              (128³, irm 8, no conservative rasterization, batch 4, 6
              worker processes, prefetch 2), the seeded h7 model through
              super_resolution_from_model: 3 batches, the last with 2
              valid scenes. Checks that the confusion matrix sums to
              10 · 128³, that each batch launched blocked_raster_or once
              (phase A's tensor code never called) and
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
              (CUDA events around eager calls), 10 steps, and profiles one
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
              falling loss, 10 timed steps, peak memory, a profile with
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
              execution 15 timed forwards, peak memory, a profile (idle
              share, convolution shares).
              Training on GT voxelized in the step with the phase loss
              (phase 6's batch), bf16 and float32, each execution: the
              first step's launches (K1 4 + 4, K2 1, K3 1, K4 1; K4 at
              s = 4 and one backward in packed voxel order for the packed
              decoder, whose factor-64 logits the loss takes); packed, the
              kernel step against the plain step (phase 5's and 10's
              rules), the phase loss against the plain loss on the
              unpacked logits (1e-6) and a falling loss; 10 timed steps and
              a profile. K1's backward in packed voxel order at skip 5
              (the packed step's gradient layout, no copy) and K4 at s = 4
              against their plain versions, timed; the backward beside the
              fine order on the same voxels, its runs along z and flushes
              (ops/skip_gather.py::walk_flushes) equal to the fine
              order's. The train CLI with
              --decoder_execution=packed (4 steps, launches, K4 at s = 4)
              and the eval CLI with --packed_inference against
              --nopacked_inference (mean IoU within 1e-3).
  13. dist    data parallelism over processes (corenet_tpu_torch/parallel).
              (a) The packed bf16 h7 step of phase 12 in an NCCL group of
              one rank on cuda:0 against the same step without a group:
              launches, the collectives per step, the loss and the new
              statistics bit-equal, the gradients bit-equal or within
              1e-6 (K1's backward adds with atomics), 10 timed steps
              without the group, in it and without it again, one profiled
              step each, the host time of an all-reduce. (b) 2 processes
              over gloo, both on cuda:0 (LOCAL_RANK 0: the shape of two
              one-card hosts), each a packed h7 step in float32 and in
              bf16: on its 2 of the 4 scenes against the one-process step
              on all 4 with the same weights (DIST_*'s rules; the
              one-process step with its halves swapped beside), and on the
              same 2 scenes each against one process on them (bit-equal
              loss and statistics); the ranks' launches, gradients and
              parameters after Adam equal; eval-mode logits of 2 scenes
              at a batch of 2 against a batch of 4. (c) TrainPipeline on
              2 gloo ranks at 32³ with a recurrent eval of 5 scenes
              (shards of 3 and 2): the eval's CSV against one process's,
              rank 0's summary tiles from both ranks, checkpoints by rank
              0 alone, a resume that goes on with each rank's shard; then
              the train CLI under cli.launch and torchrun (NCCL, one
              process), 4 steps and a resume.
  14. host-gt ground truth on the host: the native C++ voxelizer and
              flood fill (corenet_tpu_torch/cc/) in the loader's producer
              thread. (a) The library's g++ build (seconds) and the host's
              CPU count. (b) Phase 6's h7 triangle batch (128³, irm 8) and
              phase 8's y1 batch (32³, sub-grid, irm 31) through
              data/batching.py::host_voxelize against the GT that the step
              makes on the card, bit for bit (h7 also phased at s = 4:
              phase_permute of the host grid against K4 on the packed GT);
              host ms per batch (median of 5) and occupied voxels. (c)
              TrainPipeline at h7's full width (128³, batch 4, bf16, the
              packed decoder, the phase loss) on a seeded 72-scene dataset
              for 16 steps with gt_mode "host" and with "device": launches
              per step (K1 4, its backward 3 + 1 in packed voxel order,
              K2 1, and K3 and K4 0 on host GT, 1 each on device GT),
              finite losses, over steps 9-15 the median step, the
              loader's wait and the period from step to step, the idle
              share of a profiled step against the period, the host GT's
              ms per batch in the producer thread; one float32 packed step from a seeded
              state on the first host-GT batch with its grid and without
              it (the GT made in the step): the losses within 1e-6
              relative. (d) The train CLI with --gt_mode=host, 4 steps,
              seconds per step. (e) The dataset's meshes as a ShapeNet
              tree of OBJs through cli/preprocess_shapenet.py (the NPZ
              vertices bit for bit), and a seeded released-layout state
              dict at h7's widths through cli/import_corenet_checkpoint.py:
              the `.cpt` served on the card through cli/eval.py's
              load_model gives the directly loaded weights' PMF, bit for
              bit.
  15. space   the 'space' axis (parallel/mesh.py::create_mesh, the
              depth-sharded decoder): 2 gloo ranks on cuda:0 laid out as
              data 1 × space 2, each a depth slab of the decoder (from
              tower 2) on the same batch of 4 (phase 6's kind). (a) The
              packed h7 step (pack_from_stage 5) in bf16 and float32, (b)
              the fine h7 step in float32 (the fine halos), each against
              one process on that batch with the same weights by phase
              13 (b)'s rules: launches per rank (K1 4, its backward 3 + 1
              packed or 4, K2 1, K3 1, K4 1), the collectives per step
              (the data-parallel ones, 20 halo exchanges, 2 IoU sums over
              the space group), both ranks' losses, statistics, gradients
              and parameters after Adam bit-equal, 10 timed steps, the
              peak memory per rank beside one process's and the memory
              before and left by the decoder's forward. (c) TrainPipeline
              with the layout at 32³ (cut from 128³ for time) for 4 steps:
              the same batches on both ranks, launches, rank-0
              checkpoints read back, equal weights. (d) The GT shared
              over the space ranks (train/gt.py::space_shared), which (a)
              and (b) take: each rank launches K3 and K4 (s = 4) once, on
              its 2 of the 4 scenes, and the ranks trade depth slabs of
              the labels with an all-to-all (the zeroed-slot all-reduce
              of gloo on CUDA tensors). For each packed case, the step
              again with the GT replicated (each rank voxelizes all 4
              scenes and keeps its slab): labels, loss and statistics
              bit-equal, gradients within DIST_SAME_GRAD_TOL each (K1's
              backward adds with atomics in no fixed order); the peak
              memory per rank of both routes beside one process's, and
              the peak of each part of the step (the GT, the forward,
              the backward, the optimizer); rank by rank while the other
              waits, K3 and K4 on the rank's 2 scenes and on all 4
              against their plain versions, with the GT's device time by
              part (CUDA graphs); the labels' all-to-all's host time.
  16. space-nccl the 'space' axis's exchanges over NCCL, one card per
              rank, on a machine with two cards or more (up to 4): the
              labels' all-to-all against the row permutation, and halo
              exchanges, forward and backward, against their definition,
              bit for bit, with their collectives and host times. On one
              card it prints that it did not run, and why.

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
import hashlib
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
SERVE_RUNS = 15
TRAIN_RUNS = 10
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
EVAL_TIMING_PASSES = 2  # the timed eval reads the dataset this many times
# (class id, human-readable name) of the eval dataset's manifest.
EVAL_CLASSES = (("02958343", "cube"), ("03001627", "sphere"))
GT_TRIANGLES = 16384  # padded triangles per scene
GT_CPU_SCENES = [0, BATCH - 1]  # voxelized on the CPU too
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, the same sheet
# float32 operations of one sample in csrc/blocked_raster.cu's loop (a
# covered one): the sample's coordinate 2, three edge functions 12, the
# double area 2, the coverage test 7 (or the conservative one's), the
# area's test 1, the division 1, the depth 8, its range 2, its floor 1.
RASTER_OPS_PER_SAMPLE = 36
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
  zero_counts(op)
  start = time.perf_counter()
  pmf = infer(*args)
  torch.cuda.synchronize()
  first_s = time.perf_counter() - start
  launches = launch_counts(op)[0]
  if launches != 4:
    raise AssertionError(f"{label} forward launched skip_gather {launches} "
                         "times, expected 4 (one per skip)")
  sum_err = check_pmf(torch, pmf, shape)
  del pmf
  torch.cuda.reset_peak_memory_stats()
  zero_counts(op)
  times = []
  for _ in range(SERVE_RUNS):
    start = time.perf_counter()
    infer(*args)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - start) * 1e3)
  if launch_counts(op)[0] != 4 * SERVE_RUNS:
    raise AssertionError(f"{launch_counts(op)[0]} launches in {SERVE_RUNS} "
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
    walk = op.backward_walk(1, grid)
    mean_run, flushes = op.walk_flushes(px, py, h2, walk, c)
    chunk = walk.z_chunk
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
    "blocked_raster": (("blocked_raster_forward",
                        "blocked_raster_reference"),),
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


def counter(name):
  """The total of one of the program's counters (utils/tracing.py)."""
  from corenet_tpu_torch.utils import tracing
  return tracing.counters().get(name, 0)


def route_counts():
  """The labels' routes taken so far (train/gt.py::labels_slab)."""
  return {route: counter(f"gt.route.{route}")
          for route in ("space_shared", "replicated")}


def _launch_names(modules):
  """The launch counters of the given ops modules: `<op>.launches`, and
  skip_gather's backward too."""
  for module in modules:
    op = module.__name__.rsplit(".", 1)[-1]
    yield f"{op}.launches"
    if op == "skip_gather":
      yield f"{op}.backward_launches"


_ZEROED = {}  # each launch counter's total when `zero_counts` last ran


def launch_counts(*modules):
  """The launches of the given ops modules since `zero_counts`."""
  return tuple(counter(n) - _ZEROED.get(n, 0)
               for n in _launch_names(modules))


def zero_counts(*modules):
  for n in _launch_names(modules):
    _ZEROED[n] = counter(n)


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


def grad_gap(ref, got):
  """Gradients `got` against `ref` (name → tensor), leaving out the conv
  biases a BatchRenorm normalizes (their true gradient is 0): all of them
  together (relative L2), the worst one (relative L2) and the lowest
  cosine with their names, and how many were compared."""
  worst, worst_name, checked = 0.0, None, 0
  cosine, cosine_name = 1.0, None
  diff_sq = norm_sq = 0.0
  for name, gr in ref.items():
    if feeds_batch_renorm(name):
      continue
    gg = got[name]
    rel = float((gg - gr).norm() / gr.norm())
    cos = float((gg * gr).sum() / (gg.norm() * gr.norm()))
    diff_sq += float((gg - gr).norm()) ** 2
    norm_sq += float(gr.norm()) ** 2
    checked += 1
    if not math.isfinite(rel) or rel > worst:
      worst, worst_name = rel, name
    if not math.isfinite(cos) or cos < cosine:
      cosine, cosine_name = cos, name
  return (math.sqrt(diff_sq / norm_sq), worst, worst_name, cosine,
          cosine_name, checked)


def grad_levels(ref, got):
  """The three levels of tests/test_train_step_grad_parity.py: (cosine of
  all gradients together, the lowest cosine of those that carry mass
  (≥ 1e-4 of the mean norm), the worst relative L2 next to the loss), the
  conv biases a BatchRenorm normalizes left out."""
  names = [n for n in ref if not feeds_batch_renorm(n)]
  dot = sum(float((ref[n].double() * got[n].double()).sum()) for n in names)
  nr = math.sqrt(sum(float(ref[n].double().norm()) ** 2 for n in names))
  ng = math.sqrt(sum(float(got[n].double().norm()) ** 2 for n in names))
  lowest, near = 1.0, 0.0
  for n in names:
    r, g = ref[n].double(), got[n].double()
    if float(r.norm()) < 1e-4 * nr / math.sqrt(len(names)):
      continue
    lowest = min(lowest, float((r * g).sum() / (r.norm() * g.norm())))
    if n.startswith(NEAR_LOSS):
      near = max(near, float((g - r).norm() / r.norm()))
  return dot / (nr * ng), lowest, near


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
  together, worst, worst_name, cosine, cosine_name, checked = grad_gap(
      grads_p, grads_k)
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
  zero_counts(op, fgbg)
  start = time.perf_counter()
  state, metrics = step(state, batch)
  torch.cuda.synchronize()
  first_s = time.perf_counter() - start
  launches = launch_counts(op, fgbg)
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


def raster_row(torch, raster, tris, irm, conservative, where, m=None,
               timed=True):
  """The fused rasterizer (ops/blocked_raster.py) on the card against its
  plain version (phase A + the scatter's plain version) on the same
  inputs, bit for bit, and (`timed`) both timed. `tris` holds the
  triangle keys of a batch and "v2v"; m defaults to h7's grid. Returns
  (the row, the kernel's words)."""
  m = m or OUTPUT_RES[0]
  meshes = tris["v2v"].shape[1]
  args = (tris["triangles"], tris["tri_mesh_slot"], tris["v2v"],
          tris["tri_valid"])
  kw = dict(meshes=meshes, m=m, irm=irm, conservative=conservative)
  words = raster.blocked_raster_or(*args, **kw)
  plain = raster.blocked_raster_reference(*args, **kw)
  torch.cuda.synchronize()
  if not torch.equal(words, plain):
    differ = int((words != plain).sum())
    raise AssertionError(f"blocked_raster_or differs from its plain version "
                         f"{where}: {differ} of {words.numel()} words")
  b, t = tris["tri_valid"].shape
  valid = int(tris["tri_valid"].sum())
  samples = valid * (4 * irm) ** 2
  # Inputs read once (triangles, slots, validity, the scene's matrix) and
  # the grid written once; the operations every sample of a valid triangle
  # takes in the kernel's loop (RASTER_OPS_PER_SAMPLE).
  nbytes = b * t * (36 + 4 + 1) + b * 64 + words.numel() * 4
  ops_ms = samples * RASTER_OPS_PER_SAMPLE / F32_OPS_PER_S * 1e3
  bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
  row = {"triangles": [b, t], "valid_triangles": valid, "irm": irm,
         "conservative": conservative, "out": list(words.shape),
         "nonzero_words": int((words != 0).sum()), "samples": samples,
         "bytes": nbytes, "operations": samples * RASTER_OPS_PER_SAMPLE,
         "max_abs_err": 0.0, "bound_ms": max(ops_ms, bytes_ms),
         "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
         "library_ms": None}
  if timed:
    row["ms"] = device_ms(torch, lambda: raster.blocked_raster_or(*args,
                                                                  **kw))
    row["plain_ms"] = device_ms(
        torch, lambda: raster.blocked_raster_reference(*args, **kw), reps=2,
        trials=3)
    log(f"blocked_raster_or {where}: kernel {row['ms']:.4f} ms, plain "
        f"(phase A + the scatter's plain version) {row['plain_ms']:.4f} ms, "
        f"library none, bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
        f"{samples} samples of {valid} valid triangles × "
        f"{RASTER_OPS_PER_SAMPLE} float32 operations, {nbytes} B); "
        f"{row['nonzero_words']} nonzero words, equal to the plain version")
  else:
    log(f"blocked_raster_or {where}: {valid} valid triangles, "
        f"{row['nonzero_words']} nonzero words, equal to the plain version")
  return row, words


def edge_raster_batch(torch, dev, seed, m=OUTPUT_RES[0], irm=1):
  """Two scenes at irm 1 (the smallest window, 4 pixels) that reach the
  rasterizer's corners: the cube shell subdivided for irm 1, triangles
  with three equal vertices and collinear ones (zero area), triangles
  clipped at or beyond the grid's faces, invalid rows that hold
  triangles, and slots outside [0, 2) (skipped, as the scatter skips
  them). Returns the raster_row inputs on `dev`."""
  import numpy as np
  from corenet_tpu_torch.data.batching import subdivide_triangles
  from corenet_tpu_torch.train import gt
  rng = np.random.default_rng(seed)
  max_edge = 2.0 / irm / m  # a (4 + 2.5 irm)-pixel window's subdivision
  scenes = []
  for i in range(2):
    cube = subdivide_triangles(
        cube_shell() + rng.uniform(-0.05, 0.05, 3).astype(np.float32),
        max_edge)
    p = rng.uniform(0, 1, (64, 1, 3)).astype(np.float32)
    step = rng.uniform(-1, 1, (64, 1, 3)).astype(np.float32) * max_edge
    faces = rng.uniform(-0.02, 1.02, (512, 1, 3)).astype(np.float32)
    faces[:256, 0, i % 3] = rng.choice(
        np.float32([-0.01, 0.0, 0.999, 1.0, 1.01]), 256)
    faces = faces + (rng.uniform(-1, 1, (512, 3, 3)) * max_edge * 0.6
                     ).astype(np.float32)
    scenes.append(np.concatenate([
        cube, np.repeat(p, 3, axis=1),
        np.concatenate([p, p + step, p + 2 * step], axis=1), faces]))
  t = max(len(x) for x in scenes) + 64
  triangles = rng.uniform(0, 1, (2, t, 3, 3)).astype(np.float32)
  slot = rng.integers(0, 2, (2, t)).astype(np.int32)
  valid = np.zeros((2, t), bool)
  for i, tris in enumerate(scenes):
    triangles[i, :len(tris)] = tris
    valid[i, :len(tris)] = rng.random(len(tris)) > 0.05
    slot[i, :4] = (2, -1, 1 << 20, -(1 << 20))
  offsets = torch.from_numpy(rng.uniform(0, 1, (2, 3)).astype(np.float32))
  return {"triangles": torch.from_numpy(triangles).to(dev),
          "tri_mesh_slot": torch.from_numpy(slot).to(dev),
          "tri_valid": torch.from_numpy(valid).to(dev),
          "v2v": gt._view2voxel_uniform(offsets, float(m), 2).to(dev)}


def gt_kernel_rows(torch, raster, phased, batch, packed_or, rounds, s=2,
                   where="at the step's shapes"):
  """The fused rasterizer and K4 (at phase factor s) at the step's shapes
  against their plain versions, and the device time of the GT's parts:
  the fused rasterizer, the fill (its static loop with the rounds the
  adaptive fill ran), the slot OR with phased_gt; beside them the plain
  composition the rasterizer replaced, phase A and the standalone CUDA
  block_scatter_or (held against its plain version too)."""
  from corenet_tpu_torch.ops import block_scatter as scatter
  from corenet_tpu_torch.train import gt
  from corenet_tpu_torch.voxel import packed as packed_mod
  from corenet_tpu_torch.voxel import raster_fast
  m = OUTPUT_RES[0]
  nw = m // 32
  meshes = batch["mesh_labels"].shape[1]
  tris = {k: batch[k] for k in ("triangles", "tri_mesh_slot", "tri_valid")}
  tris["v2v"] = gt._view2voxel_uniform(batch["grid_offset"], float(m),
                                       meshes)
  irm = H7_VOX["image_resolution_multiplier"]
  conservative = H7_VOX["conservative_rasterization"]
  k3, grids = raster_row(torch, raster, tris, irm, conservative, where)

  def phase_a():
    return raster_fast._phase_a(
        batch["triangles"], batch["tri_mesh_slot"], tris["v2v"],
        batch["tri_valid"], m=m, irm=irm, conservative=conservative)

  origins, pw = phase_a()
  kw = dict(meshes=meshes, h=m, w=m, nw=nw)
  scattered = scatter.block_scatter_or(origins, pw, **kw)
  plain = scatter.block_scatter_or_reference(origins, pw, **kw)
  torch.cuda.synchronize()
  if not (torch.equal(scattered, plain) and torch.equal(scattered, grids)):
    raise AssertionError(f"block_scatter_or differs from its plain version "
                         f"or from blocked_raster_or {where}")
  valid = int((origins >= 0).sum())
  block_bytes = pw[0, 0].numel() * 4
  scatter_bytes = valid * (block_bytes + 4) + scattered.numel() * 4
  scatter_row = {
      "origins": list(origins.shape), "pw": list(pw.shape),
      "out": list(scattered.shape), "valid_triangles": valid,
      "nonzero_words": int((pw != 0).sum()), "bytes": scatter_bytes,
      "max_abs_err": 0.0,
      "ms": device_ms(torch, lambda: scatter.block_scatter_or(origins, pw,
                                                              **kw)),
      "plain_ms": device_ms(torch, lambda: scatter.
                            block_scatter_or_reference(origins, pw, **kw),
                            reps=2, trials=3),
      "library_ms": None,
      "bound_ms": scatter_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
  del origins, pw, scattered, plain
  log(f"block_scatter_or (standalone, off the main path) {where}: kernel "
      f"{scatter_row['ms']:.4f} ms, plain {scatter_row['plain_ms']:.4f} ms, "
      f"library none, bound {scatter_row['bound_ms']:.4f} ms "
      f"({scatter_bytes} B); {scatter_row['valid_triangles']} valid "
      f"triangles, {scatter_row['nonzero_words']} nonzero words (atomics); "
      "its grid equals blocked_raster_or's")
  k4 = phased_row(torch, phased, packed_or, s, where)

  words = grids.reshape(grids.shape[:-1] + (m, nw))
  labels = batch["mesh_labels"]

  def slot_or_phased():
    masked = torch.where((labels > 0)[:, :, None, None, None], words, 0)
    return phased.phased_gt((masked[:, 0] | masked[:, 1]).contiguous(), s)

  split = {"raster_ms": k3["ms"],
           "fill_ms": device_ms(torch, lambda: packed_mod.fill_inside_packed(
               words, fill_rounds=rounds), reps=3, trials=5),
           "fill_rounds": rounds,
           "slot_or_phased_gt_ms": device_ms(torch, slot_or_phased)}
  split["sum_ms"] = (split["raster_ms"] + split["fill_ms"] +
                     split["slot_or_phased_gt_ms"])
  composition = {"phase_a_ms": device_ms(torch, phase_a, reps=3, trials=5),
                 "scatter_ms": scatter_row["ms"]}
  composition["sum_ms"] = (composition["phase_a_ms"]
                           + composition["scatter_ms"] + split["fill_ms"]
                           + split["slot_or_phased_gt_ms"])
  split["plain_composition"] = composition
  log(f"GT device time {where} (CUDA graphs): " + ", ".join(
      f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
      for k, v in split.items() if k != "plain_composition"))
  log(f"GT device time {where}, the plain composition the rasterizer "
      f"replaced: phase A {composition['phase_a_ms']:.4f} + block_scatter_or "
      f"{composition['scatter_ms']:.4f} ms in place of "
      f"{split['raster_ms']:.4f}; the GT {composition['sum_ms']:.4f} ms in "
      f"place of {split['sum_ms']:.4f}")
  k3["scatter"] = scatter_row
  return k3, k4, split


def phased_row(torch, phased, packed_or, s, where):
  """K4 at phase factor s on `packed_or` against its plain version, bit
  for bit, and timed."""
  phases = phased.phased_gt(packed_or, s)
  plain = phased.phased_gt_reference(packed_or, s)
  torch.cuda.synchronize()
  if not torch.equal(phases, plain):
    raise AssertionError(f"phased_gt at s = {s} differs from its plain "
                         f"version {where}")
  nbytes = packed_or.numel() * 4 + phases.numel()
  row = {"s": s, "packed": list(packed_or.shape), "out": list(phases.shape),
         "bytes": nbytes, "max_abs_err": 0.0,
         "ms": device_ms(torch, lambda: phased.phased_gt(packed_or, s)),
         "plain_ms": device_ms(
             torch, lambda: phased.phased_gt_reference(packed_or, s)),
         "library_ms": None, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes"}
  log(f"phased_gt (s = {s}) {where}: kernel {row['ms']:.4f} ms, plain "
      f"{row['plain_ms']:.4f} ms, library none, bound {row['bound_ms']:.4f} "
      f"ms ({nbytes} B), equal to the plain version")
  return row


def train_gt_h7(torch, mods, CoreNet, config, image, camera, dev):
  """Phase 6: h7 training on ground truth voxelized in the step, with the
  phase loss. Returns the launches of the first step (skip_gather, its
  backward, fgbg_sums, blocked_raster_or, phased_gt), the rasterizer's and
  K4's rows, the GT split and the median step time in ms."""
  from corenet_tpu_torch.ops import block_scatter as scatter
  from corenet_tpu_torch.train import gt
  from corenet_tpu_torch.train.state import create_train_state
  from corenet_tpu_torch.train.step import make_train_step
  from corenet_tpu_torch.voxel import raster_fast
  op, fgbg, raster, phased = mods
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
  zero_counts(*mods, scatter)
  rounds0 = counter("fill.rounds")
  phase_a_calls = []
  start = time.perf_counter()
  try:
    with caught_calls(raster_fast, "_phase_a", phase_a_calls):
      state, metrics = step(state, batch)
      torch.cuda.synchronize()
  finally:
    phased.phased_gt_forward = kernel_phased
  first_s = time.perf_counter() - start
  launches = launch_counts(*mods)
  rounds = counter("fill.rounds") - rounds0
  if (launches != (4, 4, 1, 1, 1) or launch_counts(scatter)[0]
      or phase_a_calls):
    raise AssertionError(f"h7 train-gt step launched (skip_gather, its "
                         f"backward, fgbg_sums, blocked_raster_or, "
                         f"phased_gt) {launches} times, expected (4, 4, 1, "
                         f"1, 1), the standalone block_scatter_or "
                         f"{launch_counts(scatter)[0]} times and called "
                         f"phase A {len(phase_a_calls)} times, expected 0 "
                         "and 0")
  first_loss = float(metrics["loss"])
  bad = [n for n, p in state.model.named_parameters()
         if p.grad is None or not bool(torch.isfinite(p.grad).all())]
  if not math.isfinite(first_loss) or bad:
    raise AssertionError(f"h7 train-gt: loss {first_loss}, non-finite or "
                         f"missing gradients {bad[:5]}")
  log(f"h7 train-gt: first step {first_s:.3f} s, loss {first_loss:.6f}, "
      f"launches (skip_gather, backward, fgbg_sums, blocked_raster_or, "
      f"phased_gt) {launches}, the standalone block_scatter_or 0 and phase "
      f"A's tensor code 0 times, {rounds} fill rounds, loss and all "
      "gradients finite")

  # The step's GT against the plain path on the card and the CPU's.
  args = [batch[k] for k in GT_KEYS]
  packed_or, v2x = gt.voxelize_batch_packed_fgbg(*args, resolution=OUTPUT_RES,
                                                 **H7_VOX)
  with plain_versions(raster, phased):
    counted = launch_counts(raster, scatter, phased)
    plain_or, _ = gt.voxelize_batch_packed_fgbg(*args,
                                                resolution=OUTPUT_RES,
                                                **H7_VOX)
    plain_phased = phased.phased_gt(plain_or, 2)
    if launch_counts(raster, scatter, phased) != counted:
      raise AssertionError("the plain GT path launched a kernel")
  torch.cuda.synchronize()
  if not (torch.equal(caught[0], plain_phased)
          and torch.equal(packed_or, plain_or)):
    raise AssertionError("the step's phased GT differs from the plain "
                         "phase A + scatter + fill + unpack + permute")
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
      f"(foreground {share:.4f}) equals the plain phase A + scatter + fill + "
      f"unpack + permute on the card; the card's packed GT of scenes "
      f"{GT_CPU_SCENES} equals the CPU's bit for bit ({cpu_s:.1f} s on the CPU)")

  compare_with_plain_step(torch, mods, state, step, batch, "h7 train-gt")
  phase_loss_rel = compare_with_plain_loss(torch, CoreNet, config, state,
                                           step, batch, packed_or, v2x)

  state = loss_steps(state, step, batch, first_loss, "h7 train-gt")

  k3, k4, split = gt_kernel_rows(torch, raster, phased, batch, packed_or,
                                 rounds)
  # The rasterizer on a space rank's share (2 of the 4 scenes) and on the
  # edge batch; K4 at both phase factors on 2 and on 4 scenes.
  share = {k: batch[k][:BATCH // 2] for k in GT_KEYS}
  share_tris = {k: share[k] for k in ("triangles", "tri_mesh_slot",
                                      "tri_valid")}
  share_tris["v2v"] = gt._view2voxel_uniform(share["grid_offset"],
                                             float(OUTPUT_RES[0]), 2)
  k3["share"], _ = raster_row(
      torch, raster, share_tris, H7_VOX["image_resolution_multiplier"],
      H7_VOX["conservative_rasterization"],
      f"on a space rank's {BATCH // 2} scenes")
  k3["edge"], _ = raster_row(
      torch, raster, edge_raster_batch(torch, dev, SEED + 42), 1, True,
      "on the edge batch (irm 1, conservative; zero-area, clipped, invalid "
      "and out-of-range-slot triangles)", timed=False)
  k4["by_scenes"] = [
      phased_row(torch, phased, packed_or[:scenes], s,
                 f"on {scenes} scenes")
      for scenes in (BATCH // 2, BATCH) for s in (2, 4)]
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
  _, peaks = part_peaks(torch, state.model, state.optimizer, dev,
                        lambda: step(state, batch))
  split["part_peak_gib"] = {k: v / 2**30 for k, v in peaks.items()}
  log("h7 train-gt: peak memory by part of one step (GiB allocated, "
      "weights, gradients and Adam's moments included): " + ", ".join(
          f"{k} {v:.3f}" for k, v in split["part_peak_gib"].items()))
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


def write_eval_dataset(root, seed, scenes=EVAL_SCENES):
  """A seeded dataset in the on-disk format of corenet_tpu_torch/data:
  mesh NPZs (the cube shell, a small sphere near a corner and a big one
  at the centre), `scenes` scene NPZs (the cube alone or with a sphere,
  each moved by at most 0.05 per axis; 256² images stored as uint8
  arrays inside 0-d object arrays, so that no image codec is needed; the
  serving cameras) and the manifest. Returns (manifest path, meshes dir)."""
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
  for i in range(scenes):
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
  dataset. Returns the launches per run (skip_gather, its backward,
  fgbg_sums, blocked_raster_or, phased_gt) and the timings."""
  import numpy as np
  from corenet_tpu_torch.config import config as cfg
  from corenet_tpu_torch.eval import pipeline as pipeline_mod
  from corenet_tpu_torch.eval import results as results_mod
  from corenet_tpu_torch.eval.super_resolution import (
      super_resolution_from_model)
  from corenet_tpu_torch.voxel import raster_fast
  op, fgbg, raster, phased = mods
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
    phase_a_calls = []
    with caught_calls(raster_fast, "_phase_a", phase_a_calls):
      mean_iou, run_s = probe.run()
    launches = launch_counts(*mods)
    if launches != (4 * batches, 0, 0, batches, 0) or phase_a_calls:
      raise AssertionError(f"h7 eval launched (skip_gather, its backward, "
                           f"fgbg_sums, blocked_raster_or, phased_gt) "
                           f"{launches} times in {batches} batches, expected "
                           f"4 and 1 per batch, and called phase A's tensor "
                           f"code {len(phase_a_calls)} times, expected 0")
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
        f"(skip_gather, blocked_raster_or) ({launches[0]}, {launches[3]}) = "
        f"(4, 1) per batch, phase A's tensor code not called; "
        f"voxel_metrics.csv parses back to the table; "
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
        with plain_versions(op, raster) if plain else (
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
  rounds0 = counter("fill.rounds")
  start = time.perf_counter()
  state, metrics = step(state, batch)
  torch.cuda.synchronize()
  first_s = time.perf_counter() - start
  launches = launch_counts(*mods)
  rounds = counter("fill.rounds") - rounds0
  if launches != (4, 4, 1, 0, 0):
    raise AssertionError(f"y1 train step launched (skip_gather, its "
                         f"backward, fgbg_sums, blocked_raster_or, phased_gt) "
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
                           f"backward, fgbg_sums, blocked_raster_or, "
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
        f"blocked_raster_or) ({launches[0]}, {launches[3]}) in {batches} "
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
                         f"fgbg_sums, blocked_raster_or, phased_gt) "
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
def caught_calls(module, name, record, keep=lambda *call: call):
  """Wraps module.name to append each call's arguments to `record`, or
  what `keep(args, kwargs)` keeps of them."""
  real = getattr(module, name)

  def wrapped(*args, **kwargs):
    record.append(keep(args, kwargs))
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
  op, fgbg, raster, phased = mods
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
        f"blocked_raster_or, phased_gt) {launches} times, phased_gt at s = "
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


def packed_backward_row(torch, op, v2s, sample, gen):
  """K1's backward in packed voxel order at h7's skip 5 (batch 4, 64³
  fine, 12 channels), f32 and bf16, dout in the packed step's layout (the
  skip's slice of the per-phase concatenation's gradient): kernel against
  the float64 scatter-add; its time beside the fine order's on the same
  voxels and values (dout in the fine step's layout), the plain
  version's, index_add_'s, the bound; the run lengths along z and the
  flushes of the walk (ops/skip_gather.py::walk_flushes), which must
  equal the fine order's, beside those of the walk one phase at a time;
  the time of the copy to contiguous it does not need."""
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
  walk = op.backward_walk(8, half)
  mean_run, flushes = op.walk_flushes(px, py, h2, walk, c)
  fine_run, fine_flushes = op.walk_flushes(fine_px, fine_py, h2,
                                           op.backward_walk(1, fine), c)
  phase_run, phase_flushes = op.walk_flushes(
      px, py, h2, op.backward_walk(8, half, z_phases=1), c)
  if (mean_run, flushes) != (fine_run, fine_flushes):
    raise AssertionError(f"the packed walk's runs along z {mean_run} and "
                         f"flushes {flushes} differ from the fine order's "
                         f"{fine_run} and {fine_flushes}")
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
    # The same voxels and values in fine order, in the fine step's layout.
    fine_dout = dout.view((b, 2, 2, 2) + half + (c,)).permute(
        0, 4, 1, 5, 2, 6, 3, 7).reshape((b,) + fine + (c,))
    fine_cat = torch.zeros((b, cx + c) + fine, device=dev, dtype=dtype)
    fine_cat[:, cx:] = fine_dout.permute(0, 4, 1, 2, 3)
    fine_step = fine_cat[:, cx:].permute(0, 2, 3, 4, 1).reshape(b, -1, c)
    got = op.skip_gather_backward(step, px, py, h2, h2, grid_resolution=half)
    got_fine = op.skip_gather_backward(fine_step, fine_px, fine_py, h2, h2,
                                       grid_resolution=fine)
    plain = op.skip_gather_backward_reference(dout, px, py, h2, h2)
    ref64 = op.skip_gather_backward_reference(dout.double(), px, py, h2, h2)
    mass = op.skip_gather_backward_reference(dout.double().abs(), px, py, h2,
                                             h2)
    torch.cuda.synchronize()
    bound = 1e-5 * mass + 1e-30
    if dtype == torch.bfloat16:
      bound = bound + bf16_ulp(torch, ref64)
    for what, out in (("kernel", got), ("kernel in fine order", got_fine),
                      ("plain version", plain)):
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
        "phase_by_phase_mean_run_along_z": phase_run,
        "z_chunk": walk.z_chunk, "flushes": flushes,
        "fine_flushes": fine_flushes,
        "phase_by_phase_flushes": phase_flushes,
        "max_abs_err": float((got.float() - plain.float()).abs().max()),
        "ms": device_ms(torch, lambda: op.skip_gather_backward(
            step, px, py, h2, h2, grid_resolution=half)),
        "fine_order_ms": device_ms(torch, lambda: op.skip_gather_backward(
            fine_step, fine_px, fine_py, h2, h2, grid_resolution=fine)),
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
        f"{row['ms']:.4f} ms (fine order, same voxels "
        f"{row['fine_order_ms']:.4f}), plain {row['plain_ms']:.4f}, library "
        f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} ms ({nbytes} "
        f"B, {row['bound_ms'] / row['ms']:.3f} of it); copy to contiguous not "
        f"made ({row['copy_ms']:.4f} ms); mean run along z {mean_run:.3f} "
        f"(fine order {fine_run:.3f}, one phase per thread "
        f"{phase_run:.3f}), z chunk {walk.z_chunk}, flushes {flushes} (fine "
        f"order {fine_flushes}, one phase per thread {phase_flushes})")
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
                 camera, v2x, offsets, dev):
  """Phase 12: packed (space-to-depth) execution against the fine
  decoder. Returns the figures and the two new kernel rows."""
  op, fgbg, raster, phased = mods
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
                                             gen)
  out["k4_s4"] = phased_gt_s4_row(torch, phased, batch)
  del batch
  torch.cuda.empty_cache()
  out["clis"] = packed_clis(torch, mods, CoreNet, h7, dev)
  out["seconds"] = time.perf_counter() - start
  log(f"packed phase: {out['seconds']:.1f} s")
  return out


# Phase 13: data parallelism over processes (corenet_tpu_torch/parallel/).
# (b): 2 ranks of 2 scenes each against one process on all 4 scenes with
# the same weights. float32 (TF32 off): the loss within DIST_LOSS_TOL
# relative, the running statistics within DIST_STATS_TOL of the largest,
# the gradients by the three levels the port's training step is held to
# against JAX's (tests/test_train_step_grad_parity.py): all together at
# cosine ≥ 0.96, each that carries mass at ≥ 0.90, the layers next to the
# loss within 5 % relative L2. The ranks take BatchRenorm's statistics as
# a mean of two means, one process as one mean: they part in the last
# bits, and the train-mode backward carries that to about 5 % in some of
# the encoder's gradients, as far as the one-process step goes from itself
# when its scenes are reordered (H100, 700.00 W). Packed bf16: the loss
# within DIST_BF16_LOSS_TOL relative. Its statistics and gradients have no
# bit reference in one process on 4 scenes: the card's bf16 convolutions
# round the same scenes differently at a batch of 2 and of 4 (eval-mode
# logits part by up to 2.5 on an H100, measured beside). So both dtypes
# are also held where a reference exists: the ranks each on the same 2
# scenes against one process on those 2, whose loss and statistics the
# mean over equal ranks leaves bit for bit, and whose gradients only the
# order of K1's backward atomics moves (DIST_SAME_GRAD_TOL, each
# gradient's relative L2).
DIST_LOSS_TOL = 1e-5
DIST_STATS_TOL = 1e-5
DIST_BF16_LOSS_TOL = 1e-3
DIST_SAME_GRAD_TOL = 1e-4
NEAR_LOSS = ("decoder.stage_5", "decoder.stage_6", "decoder.rt_skip_5")
# (a): the step in an NCCL group of one against the step without a group,
# where the two are not bit-equal (see dist_nccl_world1).
DIST_WORLD1_TOL = 1e-6
DIST_WORLD = 2
DIST_SCENES = 5  # (c)'s eval: shards of 3 and 2 scenes, 2 and 1 batches
DIST_RES = (32, 32, 32)  # (c)'s pipeline
DIST_TIMEOUT_S = 600
DIST_DTYPES = (("float32", None), ("bfloat16", "bfloat16"))


def renorm_collectives(torch, model, run):
  """Runs `run()` and returns the all-reduces its BatchRenorm layers need
  by their inputs' dtypes: 4 for float32 (two reduces and their backward),
  2 for bf16 (one)."""
  from corenet_tpu_torch.models.batch_renorm import BatchRenorm
  dtypes = []
  hooks = [m.register_forward_pre_hook(
      lambda module, args: dtypes.append(args[0].dtype))
           for m in model.modules() if isinstance(m, BatchRenorm)]
  try:
    out = run()
  finally:
    for hook in hooks:
      hook.remove()
  return out, sum(4 if d == torch.float32 else 2 for d in dtypes)


def step_times(torch, step, state, batch):
  """TRAIN_RUNS steps one by one on the host clock, each ended by a
  synchronize: their times in ms."""
  times = []
  for _ in range(TRAIN_RUNS):
    start = time.perf_counter()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - start) * 1e3)
  return times


def dist_nccl_world1(torch, mods, CoreNet, config, batch, dev, root):
  """Phase 13 (a): the packed bf16 h7 step on GT made in the step (phase
  12's batch of 4) inside an NCCL group of one rank on cuda:0, against the
  same step from the same state without a group, and once more without
  (deterministic cuDNN). The forward has no order-dependent sum, so the
  loss and the new statistics must be bit-equal. Gradients must be
  bit-equal too where two runs without a group are; K1's backward adds
  with atomics (csrc/skip_gather.cu), so two runs may differ in the order
  of its float32 sums, and then each gradient must lie within
  DIST_WORLD1_TOL relative L2 of the run without a group. Then
  TRAIN_RUNS timed steps without a group, in the group, and without it
  again: their difference is the collectives' cost. Returns the
  figures."""
  from corenet_tpu_torch.parallel import mesh
  from corenet_tpu_torch.train.state import create_train_state
  from corenet_tpu_torch.train.step import make_train_step
  model, _ = seeded_model(torch, CoreNet, config, SEED + 130,
                          phase_output=True, compute_dtype=torch.bfloat16,
                          packed_decoder=True)
  state = create_train_state(model, device=dev)
  step = make_train_step(state.model, state.optimizer, "FG_BG", OUTPUT_RES,
                         voxelization_kwargs=H7_VOX)
  state, _ = step(state, batch)  # cuDNN's plans, the kernels' first calls
  torch.cuda.synchronize()
  snap_model = {k: v.clone() for k, v in model.state_dict().items()}
  snap_opt = copy.deepcopy(state.optimizer.state_dict())

  def one_step():
    model.load_state_dict(snap_model)
    state.optimizer.load_state_dict(snap_opt)
    torch.cuda.synchronize()
    zero_counts(*mods)
    count = counter("mesh.collectives")
    torch.backends.cudnn.deterministic = True
    try:
      (new_state, metrics), renorm = renorm_collectives(
          torch, model, lambda: step(state, batch))
      torch.cuda.synchronize()
    finally:
      torch.backends.cudnn.deterministic = False
    return {"loss": float(metrics["loss"]),
            "grads": {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()},
            "stats": {n: b.detach().clone()
                      for n, b in model.named_buffers()},
            "launches": launch_counts(*mods),
            "collectives": counter("mesh.collectives") - count,
            "renorm_collectives": renorm,
            "global_step": new_state.global_step - state.global_step}

  def profiled():
    holder = [state]

    def one():
      holder[0], _ = step(holder[0], batch)

    return device_profile(torch, one)

  alone = one_step()
  alone_ms = step_times(torch, step, state, batch)
  alone_profile = profiled()
  mesh.initialize(backend="nccl", init_method="file://" + os.path.join(
      root, "nccl_world1_store"), rank=0, world_size=1, device=dev)
  try:
    grouped = one_step()
    group_ms = step_times(torch, step, state, batch)
    group_profile = profiled()
    # One all-reduce of a BatchRenorm layer's [2, C] moments, C = 256:
    # host time per call over 200 calls, ended by a synchronize.
    x = torch.ones((2, 256), device=dev)
    mesh.all_reduce_sum(x)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(200):
      mesh.all_reduce_sum(x)
    torch.cuda.synchronize()
    all_reduce_us = (time.perf_counter() - start) / 200 * 1e6
    # The same through torch.distributed alone (no autograd, no copy).
    import torch.distributed as dist
    start = time.perf_counter()
    for _ in range(200):
      dist.all_reduce(x)
    torch.cuda.synchronize()
    raw_all_reduce_us = (time.perf_counter() - start) / 200 * 1e6
    # Whether a collective waits for the card: the host time of one
    # all-reduce enqueued behind about 50 ms of matrix products.
    a = torch.randn((8192, 8192), device=dev)
    b = a @ a
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(20):
      b = a @ a
    queued_ms = (time.perf_counter() - start) * 1e3
    start = time.perf_counter()
    mesh.all_reduce_sum(x)
    behind_ms = (time.perf_counter() - start) * 1e3
    torch.cuda.synchronize()
    del a, b
  finally:
    mesh.shutdown()
  again = one_step()
  again_ms = step_times(torch, step, state, batch)

  for label, run in (("without a group", alone), ("in the group", grouped)):
    if run["launches"] != (4, 4, 1, 1, 1) or run["global_step"] != BATCH:
      raise AssertionError(f"h7 packed bf16 step {label} launched "
                           f"{run['launches']}, advanced "
                           f"{run['global_step']}; expected (4, 4, 1, 1, 1) "
                           f"and {BATCH}")
  expected = grouped["renorm_collectives"] + 2 + 1  # the loss's, the grads'
  if alone["collectives"] != 0 or grouped["collectives"] != expected:
    raise AssertionError(f"collectives per step: {alone['collectives']} "
                         f"without a group, {grouped['collectives']} in it "
                         f"(expected 0 and {expected})")
  if not alone["loss"] == grouped["loss"] == again["loss"]:
    raise AssertionError(f"losses {alone['loss']}, {grouped['loss']} in the "
                         f"group, {again['loss']} differ")
  for name, value in alone["stats"].items():
    if not torch.equal(value, grouped["stats"][name]):
      raise AssertionError(f"statistic {name} differs in the group")

  def gap(other):
    equal = all(torch.equal(g, other["grads"][n])
                for n, g in alone["grads"].items())
    worst = max((float((other["grads"][n] - g).norm() / g.norm()), n)
                for n, g in alone["grads"].items() if float(g.norm()) > 0)
    return equal, worst

  group_equal, group_worst = gap(grouped)
  floor_equal, floor_worst = gap(again)
  if floor_equal and not group_equal:
    raise AssertionError(f"two steps without a group are bit-equal, the "
                         f"step in the group is not: {group_worst}")
  tolerance = max(DIST_WORLD1_TOL, 10 * floor_worst[0])
  if not group_equal and group_worst[0] > tolerance:
    raise AssertionError(f"gradient {group_worst[1]} in the group differs "
                         f"by {group_worst[0]} relative L2 (tolerance "
                         f"{tolerance}; two runs without a group: "
                         f"{floor_worst})")
  out = {"loss": alone["loss"], "launches": grouped["launches"],
         "collectives_per_step": grouped["collectives"],
         "renorm_collectives": grouped["renorm_collectives"],
         "renorm_layers": sum(1 for n in alone["stats"]
                              if n.endswith(".steps")),
         "grads_bit_equal": group_equal, "worst_grad_rel": group_worst,
         "no_group_repeat_bit_equal": floor_equal,
         "no_group_repeat_worst_grad_rel": floor_worst,
         "median_ms_no_group": statistics.median(alone_ms),
         "median_ms_group": statistics.median(group_ms),
         "median_ms_no_group_after": statistics.median(again_ms),
         "ms_no_group": alone_ms, "ms_group": group_ms,
         "ms_no_group_after": again_ms, "all_reduce_us": all_reduce_us,
         "raw_all_reduce_us": raw_all_reduce_us,
         "all_reduce_behind_queue_ms": behind_ms,
         "queue_enqueue_ms": queued_ms,
         "busy_ms_no_group": alone_profile and alone_profile["busy_ms"],
         "busy_ms_group": group_profile and group_profile["busy_ms"],
         "profile_group_top": group_profile and group_profile["top"]}
  out["collectives_ms"] = out["median_ms_group"] - statistics.mean(
      [out["median_ms_no_group"], out["median_ms_no_group_after"]])
  log(f"dist (a) NCCL world 1 on cuda:0, h7 packed bf16 step on GT made in "
      f"the step, batch {BATCH}: launches {grouped['launches']} with and "
      f"without the group; {grouped['collectives']} collectives per step "
      f"({out['renorm_layers']} BatchRenorm layers: "
      f"{grouped['renorm_collectives']} all-reduces, forward and backward; "
      f"the loss 2; the gradients 1); loss {alone['loss']:.7f} bit-equal, "
      f"statistics bit-equal, gradients "
      + ("bit-equal" if group_equal else
         f"worst {group_worst[0]:.2e} ({group_worst[1]})") +
      " (two runs without a group: " +
      ("bit-equal" if floor_equal else
       f"worst {floor_worst[0]:.2e} ({floor_worst[1]})") +
      f"); median step {out['median_ms_no_group']:.3f} ms without a group, "
      f"{out['median_ms_group']:.3f} ms in it, "
      f"{out['median_ms_no_group_after']:.3f} ms without it again "
      f"({TRAIN_RUNS} steps each): the collectives cost "
      f"{out['collectives_ms']:.3f} ms per step; one NCCL all-reduce of "
      f"[2, 256] takes {all_reduce_us:.1f} us of host time "
      f"({raw_all_reduce_us:.1f} us through torch.distributed alone), "
      f"{behind_ms:.3f} ms behind a queue of 20 matrix products enqueued "
      f"in {queued_ms:.3f} ms; device busy "
      f"{out['busy_ms_no_group']} ms without the group, "
      f"{out['busy_ms_group']} ms in it (one profiled step each); top "
      f"kernels in the group {out['profile_group_top']}")
  del model, state, step, snap_model, snap_opt, alone, grouped, again
  torch.cuda.empty_cache()
  return out


def run_dist_workers(torch, task, tag, root, args, world=DIST_WORLD,
                     card_per_rank=False):
  """Runs `chip_smoke.py --dist-worker` in `world` processes, each with
  LOCAL_RANK 0 (the shape of `world` one-card hosts, all on cuda:0),
  joined over gloo, or with `card_per_rank` on cuda:RANK over NCCL;
  returns their results in rank order. A rank that fails or a run past
  DIST_TIMEOUT_S fails the phase, and every process is ended."""
  procs = [subprocess.Popen(
      [sys.executable, os.path.abspath(__file__), "--dist-worker", task, tag,
       str(rank), str(world), root] + [str(a) for a in args],
      env=dict(os.environ, OMP_NUM_THREADS="4",
               LOCAL_RANK=str(rank) if card_per_rank else "0"),
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
           for rank in range(world)]
  outs = []
  try:
    for p in procs:
      outs.append(p.communicate(timeout=DIST_TIMEOUT_S)[0].decode(
          errors="replace"))
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.communicate()
  for rank, (p, text) in enumerate(zip(procs, outs)):
    if p.returncode != 0:
      raise AssertionError(f"dist {tag} rank {rank} exited with "
                           f"{p.returncode}:\n{text[-6000:]}")
  return [torch.load(os.path.join(root, f"{tag}_rank{rank}.pt"))
          for rank in range(world)]


def params_digest(model):
  digest = hashlib.sha256()
  for p in model.parameters():
    digest.update(p.detach().float().cpu().numpy().tobytes())
  return digest.hexdigest()


def dist_step_rank(torch, mods, CoreNet, config, batch, dtype, dev,
                   deterministic=False):
  """One packed step from SEED + 140's weights on `batch` (phase 12's
  scenes); the figures of (b)."""
  from corenet_tpu_torch.train.state import create_train_state
  from corenet_tpu_torch.train.step import make_train_step
  model, _ = seeded_model(torch, CoreNet, config, SEED + 140,
                          phase_output=True,
                          compute_dtype=getattr(torch, dtype) if dtype
                          else None, packed_decoder=True)
  state = create_train_state(model, device=dev)
  step = make_train_step(state.model, state.optimizer, "FG_BG", OUTPUT_RES,
                         voxelization_kwargs=H7_VOX)
  torch.cuda.synchronize()
  zero_counts(*mods)
  count = counter("mesh.collectives")
  torch.backends.cudnn.deterministic = deterministic
  try:
    new_state, metrics = step(state, batch)
    torch.cuda.synchronize()
  finally:
    torch.backends.cudnn.deterministic = False
  out = {"loss": float(metrics["loss"]), "launches": launch_counts(*mods),
         "collectives": counter("mesh.collectives") - count,
         "global_step": new_state.global_step,
         "grads": {n: p.grad.detach().float().cpu()
                   for n, p in model.named_parameters()},
         "stats": {n: b.detach().cpu() for n, b in model.named_buffers()},
         "params_digest": params_digest(model)}
  del model, state, step
  torch.cuda.empty_cache()
  return out


def tensors_digest(tensors):
  digest = hashlib.sha256()
  for t in tensors:
    digest.update(t.numpy().tobytes())
  return digest.hexdigest()


def dist_worker_step(torch, mods, rank, dev, root, batch_path):
  """(b) on one rank, in each dtype: the step on its 2 scenes of the
  batch ("split") and on scenes 0 and 1 ("same", every rank alike)."""
  from corenet_tpu_torch.models.corenet import (
      CoreNet, CoreNetConfig, DecoderConfig)
  host = torch.load(batch_path)
  per = BATCH // DIST_WORLD
  config = CoreNetConfig(DecoderConfig(OUTPUT_RES, 2))
  out = {}
  for kind, lo, deterministic in (("split", rank * per, False),
                                  ("same", 0, True)):
    batch = {k: v[lo:lo + per].to(dev) for k, v in host.items()}
    for name, dtype in DIST_DTYPES:
      result = dist_step_rank(torch, mods, CoreNet, config, batch, dtype,
                              dev, deterministic)
      if rank != 0:  # rank 0's gradients stand for both (the digests)
        result["grads_digest"] = tensors_digest(
            result.pop("grads").values())
      out[f"{name} {kind}"] = result
  return out


def stats_gap(ref, got):
  """The worst statistic's largest difference, relative to its largest
  value, and its name."""
  return max((float((got[k].float() - v.float()).abs().max()
                    / max(float(v.float().abs().max()), 1e-30)), k)
             for k, v in ref.items())


def batch_dependence(torch, CoreNet, config, batch, dev):
  """Eval-mode logits of scenes 0 and 1 at a batch of 2 against the same
  scenes in the batch of 4, in each dtype: the largest difference and the
  share of logits that differ."""
  from corenet_tpu_torch.train.step import compute_v2s
  v2s = compute_v2s(batch["camera"], batch["v2x"])
  out = {}
  for name, dtype in DIST_DTYPES:
    model, _ = seeded_model(torch, CoreNet, config, SEED + 140,
                            phase_output=True,
                            compute_dtype=getattr(torch, dtype) if dtype
                            else None, packed_decoder=True)
    model = model.to(dev).eval()
    with torch.no_grad():
      four = model(batch["image"], v2s, batch["grid_offset"])[:2].float()
      two = model(batch["image"][:2], v2s[:2],
                  batch["grid_offset"][:2]).float()
    out[name] = {"max_abs": float((four - two).abs().max()),
                 "max_abs_logit": float(four.abs().max()),
                 "share_differing": float((four != two).float().mean())}
    del model, four, two
    torch.cuda.empty_cache()
  return out


def dist_gloo_two_ranks(torch, mods, CoreNet, config, host_batch, v2x, dev,
                        root):
  """Phase 13 (b): 2 processes over gloo, both on cuda:0, each a packed h7
  step at full width, in float32 and in bf16: on its 2 of phase 12's 4
  scenes against the one-process step on all 4 (DIST_*'s rules, the
  step's spread under a swap of its halves beside), and on scenes 0 and 1
  each against one process on those 2. Each rank's launches are the
  step's; both ranks hold the same averaged gradients and, after Adam,
  the same parameters bit for bit. Returns the figures."""
  path = os.path.join(root, "dist_batch.pt")
  torch.save(host_batch, path)
  batch = {k: v.to(dev) for k, v in host_batch.items()}
  per = BATCH // DIST_WORLD
  order = torch.tensor([2, 3, 0, 1], device=dev)
  refs = {}
  for name, dtype in DIST_DTYPES:
    refs[f"{name} split"] = dist_step_rank(torch, mods, CoreNet, config,
                                           batch, dtype, dev)
    if dtype is None:  # float32: the spread the gradients' levels allow
      refs[f"{name} swapped"] = dist_step_rank(
          torch, mods, CoreNet, config,
          {k: v.index_select(0, order) for k, v in batch.items()}, dtype,
          dev)
    refs[f"{name} same"] = dist_step_rank(
        torch, mods, CoreNet, config,
        {k: v[:per] for k, v in batch.items()}, dtype, dev, True)
  dependence = batch_dependence(torch, CoreNet, config,
                                dict(batch, v2x=v2x.to(dev)), dev)
  del batch
  torch.cuda.empty_cache()
  start = time.perf_counter()
  ranks = run_dist_workers(torch, "step", "step", root, [path])
  out = {"workers_s": time.perf_counter() - start,
         "batch_dependence": dependence}
  failed = []
  for name, _ in DIST_DTYPES:
    for kind in ("split", "same"):
      key = f"{name} {kind}"
      ref, got = refs[key], [r[key] for r in ranks]
      for rank, r in enumerate(got):
        if r["launches"] != (4, 4, 1, 1, 1) or r["global_step"] != BATCH:
          raise AssertionError(f"dist (b) {key} rank {rank} launched "
                               f"{r['launches']}, counted "
                               f"{r['global_step']}")
      if not (got[0]["loss"] == got[1]["loss"]
              and got[0]["params_digest"] == got[1]["params_digest"]
              and tensors_digest(got[0]["grads"].values())
              == got[1]["grads_digest"]
              and all(torch.equal(v, got[1]["stats"][k])
                      for k, v in got[0]["stats"].items())):
        raise AssertionError(f"dist (b) {key}: the ranks' losses, "
                             "statistics, gradients or parameters after "
                             "Adam differ")
      loss_rel = abs(got[0]["loss"] - ref["loss"]) / abs(ref["loss"])
      stats_rel, stats_name = stats_gap(ref["stats"], got[0]["stats"])
      together, worst, worst_name, cosine, cosine_name, checked = grad_gap(
          ref["grads"], got[0]["grads"])
      figures = {"loss": ref["loss"], "loss_rel": loss_rel,
                 "stats_rel": stats_rel, "worst_stat": stats_name,
                 "grads_together_rel": together, "worst_grad_rel": worst,
                 "worst_grad": worst_name, "lowest_cosine": cosine,
                 "lowest_cosine_grad": cosine_name, "grads_checked": checked,
                 "launches": [r["launches"] for r in got],
                 "collectives_per_step": got[0]["collectives"]}
      if kind == "same":
        ok = (loss_rel == 0 and stats_rel == 0
              and worst <= DIST_SAME_GRAD_TOL)
        rule = (f"loss and statistics bit-equal, each gradient within "
                f"{DIST_SAME_GRAD_TOL}")
      else:
        levels = grad_levels(ref["grads"], got[0]["grads"])
        figures.update(global_cosine=levels[0],
                       lowest_massive_cosine=levels[1],
                       near_loss_worst_rel=levels[2])
        extra = (f"; levels: cosine together {levels[0]:.6f}, lowest "
                 f"{levels[1]:.6f}, next to the loss {levels[2]:.2e}")
        if name == "float32":
          floor = grad_gap(ref["grads"], refs[f"{name} swapped"]["grads"])
          figures.update(swapped_together_rel=floor[0],
                         swapped_worst_rel=floor[1],
                         swapped_lowest_cosine=floor[3])
          extra += (f"; the one-process step with its halves swapped: "
                    f"{floor[0]:.2e} together, worst {floor[1]:.2e}, lowest "
                    f"cosine {floor[3]:.6f}")
          ok = (loss_rel <= DIST_LOSS_TOL and stats_rel <= DIST_STATS_TOL
                and levels[0] >= 0.96 and levels[1] >= 0.90
                and levels[2] <= 0.05)
          rule = (f"loss {DIST_LOSS_TOL}, statistics {DIST_STATS_TOL}, "
                  "gradients cosine ≥ 0.96 together, ≥ 0.90 each, 5 % next "
                  "to the loss")
        else:
          ok = loss_rel <= DIST_BF16_LOSS_TOL
          rule = f"loss {DIST_BF16_LOSS_TOL}"
      out[key] = figures
      what = ("2 scenes each, against one process on 4" if kind == "split"
              else "the same 2 scenes each, against one process on them")
      log(f"dist (b) 2 gloo ranks on cuda:0, h7 packed {name}, {what}: "
          f"loss {ref['loss']:.7f}, {loss_rel:.2e} relative; statistics "
          f"{stats_rel:.2e} ({stats_name}); gradients together "
          f"{together:.2e}, worst {worst:.2e} ({worst_name}), lowest cosine "
          f"{cosine:.6f}" + (extra if kind == "split" else "") +
          f"; launches {figures['launches']}; "
          f"{got[0]['collectives']} collectives per step; both ranks' "
          f"gradients and parameters after Adam bit-equal; rule: {rule}: "
          + ("passed" if ok else "FAILED"))
      if not ok:
        failed.append(key)
  log(f"dist (b): eval-mode logits of scenes 0 and 1 at a batch of 2 "
      f"against the batch of 4, one process, no group: {dependence}; the "
      f"two ranks' processes took {out['workers_s']:.1f} s")
  if failed:
    raise AssertionError(f"dist (b) outside its rules: {failed}")
  return out


def dist_train_config(manifest, meshes_dir, root, name):
  """h7_train_config at DIST_RES: a batch of 1 per rank, thread loaders,
  checkpoints only at the start and the end, the loss every 2 examples,
  the recurrent eval at global step 2 with a tile per rank and 2 in the
  summaries."""
  full = h7_train_config(manifest, meshes_dir, root)
  res = dict(zip(("depth", "height", "width"), DIST_RES))
  train = full["train"]
  train["data"]["voxelization_config"]["resolution"] = res
  train["data"]["data_loader"].update(batch_size=1, num_data_workers=2,
                                      worker_processes=False)
  train.update(checkpoint_interval=10 ** 6,
               persistent_checkpoint_interval=10 ** 6,
               tensorboard_log_interval=2, fill_audit_interval=2)
  eval_dict = full["eval"][0]["config"]
  eval_dict["data"]["voxelization_config"]["resolution"] = res
  eval_dict["data"]["data_loader"].update(batch_size=2, num_data_workers=2,
                                          worker_processes=False)
  eval_dict.update(num_qualitative_results=1,
                   num_qualitative_results_in_tensor_board=2)
  full["eval"][0]["start_step"] = 2
  full["output_path"] = os.path.join(root, name)
  return full


def dist_worker_pipeline(torch, mods, rank, dev, root, config_path,
                         max_steps, space="1"):
  """(c) on one rank: TrainPipeline.run with its recurrent eval, recording
  the scenes of each batch, each checkpoint saved and each step's
  launches; with `space` > 1 (phase 15 (c)) on the data × space layout."""
  from corenet_tpu_torch import config as cfg
  from corenet_tpu_torch.parallel import mesh
  from corenet_tpu_torch.train import checkpoint
  from corenet_tpu_torch.train import pipeline as pipeline_mod
  torch.backends.cudnn.deterministic = True
  record = {"batches": [], "saves": [], "launches": []}
  real_loader = pipeline_mod.TrainPipeline._epoch_loader
  real_save = checkpoint.CheckpointManager.save_state
  real_make_step = pipeline_mod.make_train_step

  def epoch_loader(self, start):
    for hb, valid in real_loader(self, start):
      record["batches"].append(list(hb.scene_ids))
      yield hb, valid

  def save_state(self, state, *args, **kwargs):
    record["saves"].append(state.global_step)
    return real_save(self, state, *args, **kwargs)

  def counted_step(*args, **kwargs):
    step = real_make_step(*args, **kwargs)

    def wrapped(state, batch):
      counts = launch_counts(*mods)
      result = step(state, batch)
      record["launches"].append(tuple(
          a - b for a, b in zip(launch_counts(*mods), counts)))
      return result

    return wrapped

  pipeline_mod.TrainPipeline._epoch_loader = epoch_loader
  checkpoint.CheckpointManager.save_state = save_state
  pipeline_mod.make_train_step = counted_step
  with open(config_path) as f:
    full = cfg.config_from_dict(cfg.TrainPipeline, json.load(f))
  p = pipeline_mod.TrainPipeline(full.train, full.output_path, device=dev,
                                 mesh=mesh.create_mesh(space=int(space)))
  p.run(recurrent_evals=pipeline_mod.RecurrentEvals(full.eval,
                                                    full.output_path),
        max_steps=int(max_steps))
  record.update(global_step=p.state.global_step, fill_rounds=p.fill_rounds,
                params_digest=params_digest(p.model),
                depth_shard=p.model.depth_shard,
                shard_stage=p.model.decoder.shard_stage)
  return record


def shard_scenes(full, rank, epoch):
  """The scene ids of rank's shard of an epoch, from the dataset manager
  and distributed_indices: the order (c)'s batches must follow."""
  from corenet_tpu_torch import config as cfg
  from corenet_tpu_torch.data.loader import distributed_indices
  from corenet_tpu_torch.data.manager import DatasetManager
  config = cfg.config_from_dict(cfg.TrainPipeline, full)
  dataset = DatasetManager(config.train.data).create_dataset(
      local_seed=epoch)
  covered = len(dataset) // DIST_WORLD * DIST_WORLD  # a batch of 1
  indices = distributed_indices(len(dataset), DIST_WORLD, rank,
                                pad_data=True, shuffle=False)
  return [dataset[int(i)].scene_id for i in indices[:covered // DIST_WORLD]]


def dist_pipeline(torch, mods, dev, root):
  """Phase 13 (c): TrainPipeline on 2 gloo ranks on cuda:0 at DIST_RES in
  bf16 with the phase loss on DIST_SCENES scenes, a batch of 1 per rank:
  one step and the recurrent eval of all the scenes (shards of 3 and 2
  scenes, 2 and 1 batches), then a resume for 2 more steps. Checks the
  eval's CSV on rank 0 against a one-process eval of the same weights
  (deterministic cuDNN), rank 0's summaries holding the tiles of both
  ranks, each checkpoint written once (by rank 0), both ranks' weights
  equal, the static fill, each step's launches, and that the resumed run
  goes on with the next batch of each rank's shard. Then the train CLI
  through cli.launch and torchrun (--standalone, one process, NCCL): 4
  steps, and a resume for 2. Returns the figures."""
  import shutil
  from corenet_tpu_torch import config as cfg
  from corenet_tpu_torch.train import pipeline as pipeline_mod
  manifest, meshes_dir = write_eval_dataset(
      os.path.join(root, "dist_ds"), SEED + 150, scenes=DIST_SCENES)
  full = dist_train_config(manifest, meshes_dir, root, "dist_out")
  path = os.path.join(root, "dist_train.json")
  with open(path, "w") as f:
    json.dump(full, f)
  out = full["output_path"]
  start = time.perf_counter()
  first = run_dist_workers(torch, "pipeline", "pipeline1", root, [path, 2])
  first_s = time.perf_counter() - start

  # The one-process eval of the weights the eval saw: the newest .cpt.
  eval_csv = os.path.join(out, "evals", "full_eval", "2",
                          "voxel_metrics.csv")
  one = dist_train_config(manifest, meshes_dir, root, "dist_one")
  config = cfg.config_from_dict(cfg.TrainPipeline, one)
  os.makedirs(os.path.join(one["output_path"], "cpt", "persistent"))
  shutil.copy(os.path.join(out, "cpt", "persistent", "state_000000002.cpt"),
              os.path.join(one["output_path"], "cpt", "persistent"))
  single = pipeline_mod.TrainPipeline(config.train, one["output_path"],
                                      device=dev)
  single.create_or_load_state()
  torch.backends.cudnn.deterministic = True
  try:
    single_miou = pipeline_mod.RecurrentEvals(
        config.eval, one["output_path"]).run_single(
            single, config.eval[0].config, 2)
  finally:
    torch.backends.cudnn.deterministic = False
  del single
  torch.cuda.empty_cache()
  with open(eval_csv) as f, open(os.path.join(
      one["output_path"], "evals", "full_eval", "2",
      "voxel_metrics.csv")) as g:
    csv_two, csv_one = f.read(), g.read()
  if csv_two != csv_one:
    raise AssertionError(f"the eval's CSV on 2 ranks:\n{csv_two}\ndiffers "
                         f"from one process's:\n{csv_one}")
  summary_tiles = sorted(f for f in os.listdir(
      os.path.join(out, "tb", "full_eval")) if f.startswith("rec_"))
  eval_tiles = sorted(f for f in os.listdir(os.path.dirname(eval_csv))
                      if f.startswith("img_"))
  if (summary_tiles != [f"rec_{i}_2.png" for i in range(2)]
      or len(eval_tiles) != 2):
    raise AssertionError(f"summary tiles {summary_tiles}, eval tiles "
                         f"{eval_tiles}: expected one from each rank")

  start = time.perf_counter()
  second = run_dist_workers(torch, "pipeline", "pipeline2", root, [path, 6])
  second_s = time.perf_counter() - start
  for rank in range(DIST_WORLD):
    epoch0, epoch1 = (shard_scenes(full, rank, e) for e in (0, 1))
    want = [[s] for s in epoch0 + epoch1[:1]]
    got = first[rank]["batches"] + second[rank]["batches"]
    if got != want:
      raise AssertionError(f"rank {rank} trained on {got}, its shards in "
                           f"order are {want}")
    launches = first[rank]["launches"] + second[rank]["launches"]
    if set(launches) != {(4, 4, 1, 1, 1)} or len(launches) != 3:
      raise AssertionError(f"rank {rank}'s launches per step {launches}")
  if not (first[1]["saves"] == second[1]["saves"] == []
          and first[0]["saves"] == [0, 2] and second[0]["saves"] == [6]):
    raise AssertionError(f"checkpoints saved by rank 0: {first[0]['saves']}"
                         f", {second[0]['saves']}; by rank 1: "
                         f"{first[1]['saves']}, {second[1]['saves']}")
  for run in (first, second):
    if run[0]["params_digest"] != run[1]["params_digest"]:
      raise AssertionError("the ranks' weights differ")
    if [r["fill_rounds"] for r in run] != [6, 6]:
      raise AssertionError("the static fill is off under 2 processes")
  log(f"dist (c) TrainPipeline on 2 gloo ranks on cuda:0 at "
      f"{DIST_RES[0]}³ in bf16: batches {[r['batches'] for r in first]} "
      f"then, resumed, {[r['batches'] for r in second]} (each rank's shard "
      f"in order); the eval over {DIST_SCENES} scenes (3 and 2) equal to one "
      f"process's CSV (mean IoU {single_miou:.6f}); summary tiles "
      f"{summary_tiles}; checkpoints by rank 0 only at 0, 2, 6; weights "
      f"equal; static fill 6; launches per step (4, 4, 1, 1, 1); runs "
      f"{first_s:.1f} s and {second_s:.1f} s")
  cli = dist_cli(manifest, meshes_dir, root)
  return {"first_s": first_s, "second_s": second_s,
          "eval_miou": single_miou, "summary_tiles": summary_tiles,
          "batches": [first[r]["batches"] + second[r]["batches"]
                      for r in range(DIST_WORLD)],
          "launches": first[0]["launches"][0], "cli": cli}


def dist_cli(manifest, meshes_dir, root):
  """The train CLI as a user starts it on N cards, here 1: cli.launch
  around torchrun --standalone around cli.train --multihost (NCCL), 4
  steps, then the same command resumes for 2 more (no recurrent eval:
  dist_pipeline ran one)."""
  full = dist_train_config(manifest, meshes_dir, root, "dist_cli")
  full["eval"] = []  # (c) ran the recurrent eval
  path = os.path.join(root, "dist_cli.json")
  with open(path, "w") as f:
    json.dump(full, f)
  out = full["output_path"]
  seconds = []
  for max_steps in (4, 6):
    command = [sys.executable, "-m", "corenet_tpu_torch.cli.launch",
               "--num_retries=0", "--", sys.executable, "-m",
               "torch.distributed.run", "--standalone", "--nproc_per_node=1",
               "-m", "corenet_tpu_torch.cli.train", "--multihost",
               f"--config_path={path}", f"--max_steps={max_steps}"]
    start = time.perf_counter()
    proc = subprocess.run(command, capture_output=True, text=True,
                          timeout=DIST_TIMEOUT_S)
    seconds.append(time.perf_counter() - start)
    if proc.returncode != 0:
      raise AssertionError(f"{' '.join(command)} exited with "
                           f"{proc.returncode}:\n{proc.stderr[-6000:]}")

  def listing(tier):
    return sorted(os.listdir(os.path.join(out, "cpt", tier)))

  with open(os.path.join(out, "logs", "worker_0.log")) as f:
    log_text = f.read()
  with open(os.path.join(out, "tb", "train", "scalars.jsonl")) as f:
    losses = [(r["step"], r["value"]) for r in map(json.loads, f)
              if r["tag"] == "loss"]
  if (listing("temp") != ["state_000000000.cpt"]
      or listing("persistent") != ["state_000000004.cpt",
                                   "state_000000006.cpt"]
      or [s for s, _ in losses] != [2, 4, 6]
      or not all(math.isfinite(v) for _, v in losses)
      or " W:0 " not in log_text or "Loaded checkpoint" not in log_text):
    raise AssertionError(f"the CLI under torchrun wrote temp "
                         f"{listing('temp')}, persistent "
                         f"{listing('persistent')}, losses {losses}")
  log(f"dist (c) cli.launch -- torchrun --standalone --nproc_per_node=1 -m "
      f"corenet_tpu_torch.cli.train --multihost (NCCL, world 1): 4 steps "
      f"in {seconds[0]:.1f} s, a resume to 6 in {seconds[1]:.1f} s; "
      f"checkpoints temp (0), persistent (4, 6); losses {losses}; "
      "logs/worker_0.log")
  return {"seconds": seconds, "losses": losses}


def dist_worker(argv) -> int:
  """`chip_smoke.py --dist-worker TASK TAG RANK WORLD ROOT ARGS...`: one
  rank of phase 13 (b) or (c) or of phase 15, joined over gloo on this
  process's card
  (cuda:LOCAL_RANK); its result goes to ROOT/TAG_rankRANK.pt."""
  import torch
  from corenet_tpu_torch.ops import blocked_raster as raster
  from corenet_tpu_torch.ops import fgbg_loss as fgbg
  from corenet_tpu_torch.ops import phased_gt as phased
  from corenet_tpu_torch.ops import skip_gather as op
  from corenet_tpu_torch.parallel import mesh
  task, tag, rank, world, root = argv[:5]
  rank, world = int(rank), int(world)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  dev = mesh.initialize(backend="nccl" if task == "nccl" else "gloo",
                        init_method="file://" + os.path.join(
                            root, f"{tag}_store"),
                        rank=rank, world_size=world, device="cuda")
  try:
    work = {"step": dist_worker_step, "pipeline": dist_worker_pipeline,
            "space": space_worker_step, "nccl": nccl_worker}[task]
    result = work(torch, (op, fgbg, raster, phased), rank, dev, root,
                  *argv[5:])
    torch.save(result, os.path.join(root, f"{tag}_rank{rank}.pt"))
    mesh.barrier("done")
  finally:
    mesh.shutdown()
  return 0


def dist_phase(torch, mods, CoreNet, CoreNetConfig, DecoderConfig, image,
               camera, v2x, dev):
  """Phase 13: data parallelism over processes. Returns the figures."""
  h7 = CoreNetConfig(DecoderConfig(OUTPUT_RES, 2))
  start = time.perf_counter()
  host, _ = triangle_batch(torch, image, camera, SEED + 41)
  batch = {k: v.to(dev) for k, v in host.items()}
  seconds = {}
  with tempfile.TemporaryDirectory() as root:
    out = {"a": dist_nccl_world1(torch, mods, CoreNet, h7, batch, dev, root)}
    del batch
    torch.cuda.empty_cache()
    seconds["a"] = time.perf_counter() - start
    out["c"] = dist_pipeline(torch, mods, dev, root)
    seconds["c"] = time.perf_counter() - start - sum(seconds.values())
    out["b"] = dist_gloo_two_ranks(torch, mods, CoreNet, h7, host, v2x, dev,
                                   root)
    seconds["b"] = time.perf_counter() - start - sum(seconds.values())
  out["seconds"] = time.perf_counter() - start
  out["part_seconds"] = seconds
  log(f"dist phase: {out['seconds']:.1f} s (" + ", ".join(
      f"({k}) {v:.1f} s" for k, v in seconds.items()) + ")")
  return out


# Phase 14: ground truth on the host (the native C++ voxelizer and fill in
# the loader's producer thread), the dataset tools and the importer.
# 16 steps: the loader's prefetch queue (2 batches, and those made while
# the model and its first checkpoint are set up) hides the producer's pace
# for the first ~6; the medians are taken over steps 9-15.
HOST_GT_STEPS = 16
HOST_GT_STEADY_FROM = 8
HOST_GT_SCENES = 72  # one epoch of 18 batches covers the 16 steps
HOST_GT_TIMED = 5    # host_voxelize calls per batch for the median
# Launches per packed bf16 h7 step (skip_gather, its backward, fgbg_sums,
# blocked_raster_or, phased_gt) and the backwards of them in packed voxel
# order: on host GT the step phases the batch's grid (phase_permute), so
# K3 and K4 do not run.
HOST_GT_LAUNCHES = {"host": ((4, 4, 1, 0, 0), 1),
                    "device": ((4, 4, 1, 1, 1), 1)}


def host_batch_of(batch):
  """A HostBatch of a triangle batch (phase 6's or 8's). The step's
  `mesh_labels` are each slot's voxel value, and host_voxelize takes them
  as SEMANTIC content (mesh_labels × mesh_valid) with every slot valid:
  the same grid, label 0 leaving its mesh out."""
  import numpy as np
  from corenet_tpu_torch.data.batching import HostBatch
  arrays = {k: batch[k].numpy() for k in GT_KEYS}
  return HostBatch(
      image=None, camera=None, view_transform=None,
      triangles=arrays["triangles"], tri_mesh_slot=arrays["tri_mesh_slot"],
      tri_valid=arrays["tri_valid"], mesh_labels=arrays["mesh_labels"],
      mesh_valid=np.ones_like(arrays["mesh_labels"], bool),
      grid_offset=arrays["grid_offset"], scene_ids=[])


def host_grid_row(torch, phased, name, batch, res, vox, dev):
  """(b): a triangle batch through host_voxelize (HOST_GT_TIMED calls, the
  median ms) and through the GT that the step makes on the card, bit for
  bit; on h7's blocked path also the phase labels at s = 4, as the packed
  step phases its packed grid (K4) and a host grid (phase_permute)."""
  from corenet_tpu_torch.data.batching import host_voxelize
  from corenet_tpu_torch.ops.phased_gt import phase_permute
  from corenet_tpu_torch.train import gt
  hb = host_batch_of(batch)
  kwargs = dict(image_resolution_multiplier=vox["image_resolution_multiplier"],
                conservative_rasterization=vox["conservative_rasterization"],
                projection_depth_multiplier=vox["projection_depth_multiplier"],
                sub_grid_sampling=vox["sub_grid_sampling"])
  times = []
  for _ in range(HOST_GT_TIMED):
    start = time.perf_counter()
    grid, v2x = host_voxelize(hb, "SEMANTIC", res, **kwargs)
    times.append((time.perf_counter() - start) * 1e3)
  card = {k: batch[k].to(dev) for k in GT_KEYS}
  device_grid, device_v2x = gt.voxelize_batch(
      *(card[k] for k in GT_KEYS), resolution=res, **vox)
  host = torch.from_numpy(grid).to(dev)
  differ = int((host != device_grid.to(torch.int32)).sum())
  if differ or not torch.equal(torch.from_numpy(v2x).to(dev), device_v2x):
    raise AssertionError(f"host-gt {name}: the host grid differs from the "
                         f"card's GT in {differ} voxels (or v2x differs)")
  row = {"host_ms": statistics.median(times), "host_ms_all": times,
         "occupied": int((grid > 0).sum()), "voxels": int(grid.size),
         "device_dtype": str(device_grid.dtype).replace("torch.", "")}
  if gt.packed_fgbg_eligible(resolution=res, **vox):
    packed, _ = gt.voxelize_batch_packed_fgbg(*(card[k] for k in GT_KEYS),
                                              resolution=res, **vox)
    if not torch.equal(phase_permute(host.to(torch.uint8), 4),
                       phased.phased_gt(packed, 4)):
      raise AssertionError(f"host-gt {name}: the phased host grid differs "
                           "from the card's phased packed GT (s = 4)")
    row["phased_s4_equal"] = True
  log(f"host-gt (b) {name}: host grid = the card's GT bit for bit "
      f"({row['occupied']} of {row['voxels']} voxels occupied, the card's "
      f"grid {row['device_dtype']}"
      + ("; phased at s = 4: host phase_permute = the card's phased_gt"
         if "phased_s4_equal" in row else "")
      + f"); host_voxelize {row['host_ms']:.1f} ms per batch of "
      f"{grid.shape[0]} (median of {HOST_GT_TIMED}: "
      + ", ".join(f"{t:.1f}" for t in times) + ")")
  return row


def host_gt_train_config(manifest, meshes_dir, root, name):
  """h7's train configuration (h7_train_config) on phase 14's dataset,
  with no recurrent eval and checkpoints only at the start and the end."""
  full = h7_train_config(manifest, meshes_dir, root)
  full["train"].update(checkpoint_interval=10 ** 6,
                       persistent_checkpoint_interval=10 ** 6,
                       tensorboard_log_interval=BATCH)
  full["eval"] = []
  full["output_path"] = os.path.join(root, name)
  return full


@contextlib.contextmanager
def timed_pipeline_steps(torch, mods, figures, profile_index=None):
  """Wraps the pipeline's make_train_step: each step is ended by a
  synchronize and records its start, end and launches (with its
  backwards in packed voxel order); the step at `profile_index` runs
  under the profiler, and the first step's batch is kept."""
  from corenet_tpu_torch.train import pipeline as pipeline_mod
  op = mods[0]
  real_make_step = pipeline_mod.make_train_step
  backwards = []
  for key in ("starts", "ends", "launches"):
    figures.setdefault(key, [])

  def counted_step(*args, **kwargs):
    step = real_make_step(*args, **kwargs)

    def wrapped(state, batch):
      torch.cuda.synchronize()
      counts = launch_counts(*mods)
      seen = len(backwards)
      if not figures["starts"]:
        figures["first_batch"] = {k: v.clone() for k, v in batch.items()}
      start = time.perf_counter()
      if len(figures["starts"]) == profile_index:
        holder = []
        figures["profile"] = device_profile(
            torch, lambda: holder.append(step(state, batch)))
        result = holder[0]
      else:
        result = step(state, batch)
        torch.cuda.synchronize()
      figures["ends"].append(time.perf_counter())
      figures["starts"].append(start)
      figures["launches"].append((
          tuple(a - b for a, b in zip(launch_counts(*mods), counts)),
          sum(1 for args, _ in backwards[seen:] if args[0].dim() == 4)))
      return result

    return wrapped

  pipeline_mod.make_train_step = counted_step
  try:
    with caught_calls(op, "skip_gather_backward", backwards):
      yield figures
  finally:
    pipeline_mod.make_train_step = real_make_step


def step_periods(figures, skip_last=False, first=1):
  """Per step from index `first` (at least 1) on: the step's own ms, the
  loader's wait (from the previous step's end to this step's start) and
  the period (end to end), without the profiled last step if asked."""
  starts, ends = figures["starts"], figures["ends"]
  last = len(ends) - (1 if skip_last else 0)
  idx = range(max(first, 1), last)
  return ([(ends[i] - starts[i]) * 1e3 for i in idx],
          [(starts[i] - ends[i - 1]) * 1e3 for i in idx],
          [(ends[i] - ends[i - 1]) * 1e3 for i in idx])


def host_gt_training(torch, mods, full, gt_mode, dev):
  """(c): TrainPipeline at h7's full width (bf16, packed, the phase loss)
  for HOST_GT_STEPS steps with `gt_mode`: launches per step, finite
  losses, the median step, loader wait and period over the steady steps,
  the idle share of the profiled last step against the median period, and
  the host GT's ms per batch in the loader's producer thread."""
  from corenet_tpu_torch import config as cfg
  from corenet_tpu_torch.train import pipeline as pipeline_mod
  config = cfg.config_from_dict(cfg.TrainPipeline, full)
  label = f"host-gt (c) TrainPipeline gt_mode={gt_mode!r}"
  figures = {}
  gt_ms = []
  real_host_voxelize = pipeline_mod.host_voxelize

  def timed_host_voxelize(*args, **kwargs):
    start = time.perf_counter()
    result = real_host_voxelize(*args, **kwargs)
    gt_ms.append((time.perf_counter() - start) * 1e3)
    return result

  pipeline_mod.host_voxelize = timed_host_voxelize
  try:
    with timed_pipeline_steps(torch, mods, figures,
                              profile_index=HOST_GT_STEPS - 1):
      start = time.perf_counter()
      p = pipeline_mod.TrainPipeline(config.train, config.output_path,
                                     gt_mode=gt_mode, device=dev)
      p.run(max_steps=HOST_GT_STEPS * BATCH)
      torch.cuda.synchronize()
      run_s = time.perf_counter() - start
  finally:
    pipeline_mod.host_voxelize = real_host_voxelize
  expected = HOST_GT_LAUNCHES[gt_mode]
  if (len(figures["launches"]) != HOST_GT_STEPS
      or set(figures["launches"]) != {expected}):
    raise AssertionError(f"{label}: launches per step (K1 fwd, K1 bwd, K2, "
                         f"K3, K4; packed-order backwards) "
                         f"{figures['launches']}, expected {expected}")
  if not (p.model.packed_decoder and p.model.phase_output
          and p.model.compute_dtype == torch.bfloat16):
    raise AssertionError(f"{label}: not the packed bf16 phase-loss model")
  with open(os.path.join(config.output_path, "tb", "train",
                         "scalars.jsonl")) as f:
    losses = [json.loads(line)["value"] for line in f
              if json.loads(line)["tag"] == "loss"]
  if len(losses) != HOST_GT_STEPS or not all(map(math.isfinite, losses)):
    raise AssertionError(f"{label}: losses {losses}")
  step_ms, wait_ms, period_ms = step_periods(figures, skip_last=True,
                                             first=HOST_GT_STEADY_FROM)
  profile = figures["profile"]
  out = {"launches": figures["launches"][0][0],
         "loader_gt_ms": statistics.median(gt_ms) if gt_ms else None,
         "loader_gt_calls": len(gt_ms),
         "packed_order_backwards": figures["launches"][0][1],
         "losses": losses, "run_s": run_s,
         "first_step_ms": (figures["ends"][0] - figures["starts"][0]) * 1e3,
         "step_ms": statistics.median(step_ms), "step_ms_all": step_ms,
         "wait_ms": statistics.median(wait_ms), "wait_ms_all": wait_ms,
         "period_ms": statistics.median(period_ms),
         "busy_ms": profile["busy_ms"] if profile else None}
  out["idle_share"] = (1 - out["busy_ms"] / out["period_ms"]
                       if profile else None)
  log(f"{label}: {HOST_GT_STEPS} steps in {run_s:.1f} s (with the model, "
      f"the loader's start and 2 checkpoints); launches per step "
      f"{out['launches']}, {out['packed_order_backwards']} backward in "
      f"packed order, in every step; losses "
      + ", ".join(f"{v:.5f}" for v in losses)
      + f"; over steps {HOST_GT_STEADY_FROM + 1}-{HOST_GT_STEPS - 1}: step "
      f"{out['step_ms']:.3f} ms, loader wait {out['wait_ms']:.3f} ms, period "
      f"{out['period_ms']:.3f} ms (medians); the waits of steps 2-"
      f"{HOST_GT_STEPS}: " + ", ".join(
          f"{w:.1f}" for w in step_periods(figures)[1])
      + (f"; host_voxelize in the producer thread {out['loader_gt_ms']:.1f} "
         f"ms per batch (median of {len(gt_ms)})" if gt_ms else ""))
  log_profile(label, profile, out["period_ms"], what="step (against the "
              "median period)")
  return out, figures["first_batch"]


def host_gt_float32_loss(torch, mods, CoreNet, model_config, batch, dev):
  """(c): one float32 packed step from a seeded state on the first host-GT
  batch, and the same step from the same state on that batch without its
  grid (the GT made in the step): the losses within 1e-6 relative."""
  from corenet_tpu_torch.train.state import create_train_state
  from corenet_tpu_torch.train.step import make_train_step
  model, _ = seeded_model(torch, CoreNet, model_config, SEED + 140,
                          phase_output=True, packed_decoder=True)
  state = create_train_state(model, device=dev)
  step = make_train_step(state.model, state.optimizer, "FG_BG", OUTPUT_RES,
                         voxelization_kwargs=H7_VOX)
  saved = (copy.deepcopy(state.model.state_dict()),
           copy.deepcopy(state.optimizer.state_dict()))
  losses, launches = {}, {}
  for mode, inputs in (("host", batch),
                       ("device", {k: v for k, v in batch.items()
                                   if k not in ("grid", "v2x")})):
    state.model.load_state_dict(saved[0])
    state.optimizer.load_state_dict(saved[1])
    torch.cuda.synchronize()
    zero_counts(*mods)
    _, metrics = step(state, inputs)
    losses[mode] = float(metrics["loss"])
    launches[mode] = launch_counts(*mods)
  rel = abs(losses["host"] - losses["device"]) / abs(losses["device"])
  if rel > 1e-6 or launches != {k: v[0] for k, v in HOST_GT_LAUNCHES.items()}:
    raise AssertionError(f"host-gt (c) float32: losses {losses} ({rel:.2e} "
                         f"relative), launches {launches}")
  log(f"host-gt (c) float32 packed step from one seeded state on the first "
      f"host-GT batch: loss {losses['host']:.8f} on the host grid, "
      f"{losses['device']:.8f} with the GT made in the step ({rel:.2e} "
      f"relative; tolerance 1e-6); launches {launches['host']} and "
      f"{launches['device']}")
  return {"losses": losses, "rel": rel}


def host_gt_cli(torch, mods, full, root):
  """(d): the train CLI with --gt_mode=host, 4 steps: seconds per step
  (the period from step end to step end, the loader's wait included)."""
  from corenet_tpu_torch.cli import train as train_cli_mod
  path = os.path.join(root, "h7_host_cli.json")
  with open(path, "w") as f:
    json.dump(full, f)
  figures = {}
  with timed_pipeline_steps(torch, mods, figures):
    start = time.perf_counter()
    p = train_cli_mod.main([f"--config_path={path}", "--max_steps=16",
                            "--gt_mode=host"])
    torch.cuda.synchronize()
    call_s = time.perf_counter() - start
  if p.gt_mode != "host" or p.state.global_step != 16 or (
      set(figures["launches"]) != {HOST_GT_LAUNCHES["host"]}):
    raise AssertionError(f"host-gt (d): gt_mode {p.gt_mode}, step "
                         f"{p.state.global_step}, launches "
                         f"{figures['launches']}")
  _, _, period_ms = step_periods(figures)
  out = {"call_s": call_s, "s_per_step": [t / 1e3 for t in period_ms],
         "first_step_s": figures["ends"][0] - figures["starts"][0]}
  log(f"host-gt (d) train CLI --gt_mode=host: 4 steps, the call "
      f"{call_s:.1f} s; seconds per step after the first "
      + ", ".join(f"{s:.3f}" for s in out["s_per_step"])
      + f" (the first {out['first_step_s']:.3f} s); launches "
      f"{figures['launches'][0]}")
  return out


def write_obj(path, triangles):
  """An OBJ of a triangle soup: three vertices per face, each written with
  9 significant digits, so that it reads back as the same float32."""
  lines = []
  for tri in triangles:
    lines += ["v " + " ".join(f"{v:.9g}" for v in vertex) for vertex in tri]
  lines += [f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}"
            for i in range(len(triangles))]
  os.makedirs(os.path.dirname(path), exist_ok=True)
  with open(path, "w") as f:
    f.write("\n".join(lines) + "\n")


def tools_and_importer(torch, CoreNet, manifest, meshes_dir, root, dev):
  """(e): phase 14's meshes written as a ShapeNet tree of OBJs through
  cli/preprocess_shapenet.py give the mesh NPZs' vertices bit for bit; a
  seeded released-layout state dict at h7's widths through
  cli/import_corenet_checkpoint.py gives a `.cpt` that serves on the card
  (cli/eval.py::load_model) the PMF of the same weights loaded directly,
  bit for bit."""
  import numpy as np
  from corenet_tpu_torch import config as cfg
  from corenet_tpu_torch.cli import import_corenet_checkpoint as importer
  from corenet_tpu_torch.cli import preprocess_shapenet
  from corenet_tpu_torch.cli.eval import load_model
  from corenet_tpu_torch.eval.super_resolution import (
      super_resolution_from_model)
  from corenet_tpu_torch.models.convert import jax_variables_from_state_dict
  from corenet_tpu_torch.train.pipeline import model_config_from_train_config
  out = {}
  sources = sorted(
      (label, os.path.splitext(name)[0])
      for label in os.listdir(meshes_dir)
      for name in os.listdir(os.path.join(meshes_dir, label)))
  for label, name in sources:
    with np.load(os.path.join(meshes_dir, label, name + ".npz")) as z:
      write_obj(os.path.join(root, "shapenet", label, name, "models",
                             "model_normalized.obj"), z["vertices"])
  start = time.perf_counter()
  preprocess_shapenet.main([f"--shapenet_root={root}/shapenet",
                            f"--output_root={root}/preprocessed",
                            "--num_workers=2"])
  out["preprocess_s"] = time.perf_counter() - start
  for label, name in sources:
    with np.load(os.path.join(meshes_dir, label, name + ".npz")) as want, \
        np.load(os.path.join(root, "preprocessed", label,
                             name + ".npz")) as got:
      if not (got["vertices"].dtype == want["vertices"].dtype
              and np.array_equal(got["vertices"], want["vertices"])
              and str(got["label"]) == label
              and str(got["mesh_id"]) == name):
        raise AssertionError(f"host-gt (e): preprocessed {label}/{name} "
                             "differs from the mesh written directly")
  log(f"host-gt (e) preprocess_shapenet: {len(sources)} meshes as OBJ → "
      f"NPZ in {out['preprocess_s']:.2f} s (2 spawned workers), vertices "
      "equal to the NPZs written directly, bit for bit")

  full = host_gt_train_config(manifest, meshes_dir, root, "h7_imported")
  config_path = os.path.join(root, "h7_import.json")
  with open(config_path, "w") as f:
    json.dump(full, f)
  model_config = model_config_from_train_config(
      cfg.config_from_dict(cfg.TrainPipeline, full).train, 2)
  model, state_dict = seeded_model(torch, CoreNet, model_config, SEED + 150)
  flat = {}
  for collection, tree in jax_variables_from_state_dict(state_dict).items():
    stack = [((collection,), tree)]
    while stack:
      prefix, node = stack.pop()
      for key, value in node.items():
        if isinstance(value, dict):
          stack.append((prefix + (key,), value))
        else:
          flat["/".join(prefix + (key,))] = value
  released = os.path.join(root, "released.cpt")
  torch.save({"model_state": importer.reference_state_dict(flat),
              "global_step": 7}, released)
  cpt = os.path.join(root, "imported", "h7.cpt")
  start = time.perf_counter()
  importer.main([f"--torch_checkpoint={released}",
                 f"--train_config={config_path}", f"--output_path={cpt}"])
  out["import_s"] = time.perf_counter() - start
  served, _, _, step = load_model(cpt)
  camera, v2x = camera_and_v2x(torch, OUTPUT_RES[0])
  image = torch.randint(0, 256, (BATCH, IMAGE_HW, IMAGE_HW, 3),
                        dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(SEED + 151))
  args = (image, camera, v2x, torch.full((BATCH, 3), 0.5), OUTPUT_RES)
  # cuDNN held to deterministic algorithms, so that no convolution sums in
  # a run-dependent order.
  torch.backends.cudnn.deterministic = True
  try:
    pmfs = [super_resolution_from_model(m, m.state_dict(), OUTPUT_RES,
                                        device=dev)(*args)
            for m in (served, model)]
    torch.cuda.synchronize()
  finally:
    torch.backends.cudnn.deterministic = False
  if step != 7 or not torch.equal(*pmfs):
    raise AssertionError(f"host-gt (e): the imported .cpt (step {step}) "
                         f"serves a PMF {float((pmfs[0] - pmfs[1]).abs().max())}"
                         " from the direct one")
  out["cpt_mb"] = os.path.getsize(cpt) / 2 ** 20
  log(f"host-gt (e) import_corenet_checkpoint: {len(flat)} released-layout "
      f"tensors at h7's widths → {out['cpt_mb']:.1f} MiB .cpt in "
      f"{out['import_s']:.2f} s; served on the card through load_model, the "
      f"PMF {list(pmfs[0].shape)} equals the directly loaded weights', bit "
      "for bit")
  return out


def host_gt_phase(torch, mods, CoreNet, image, camera, dev):
  """Phase 14: the native library's build, (b) host grids against the
  card's GT, (c) TrainPipeline on host GT against device GT, (d) the train
  CLI on host GT, (e) the dataset tool and the importer."""
  import pathlib
  from corenet_tpu_torch import config as cfg
  from corenet_tpu_torch.cc import native
  from corenet_tpu_torch.train.pipeline import model_config_from_train_config
  phase_start = time.perf_counter()
  # The checkout's library is built at its first use, here; where a
  # library is there already, a fresh build into a temporary directory
  # is timed instead.
  existed = native.library_path().exists()
  with tempfile.TemporaryDirectory() as tmp:
    saved_dir = native.BUILD_DIR
    if existed:
      native.BUILD_DIR = pathlib.Path(tmp)
    try:
      start = time.perf_counter()
      native.build()
      build_s = time.perf_counter() - start
    finally:
      native.BUILD_DIR = saved_dir
  native.load_library()
  out = {"build_s": build_s, "cpu_count": os.cpu_count(),
         "library": native.library_path().name, "rebuilt": existed}
  log(f"host-gt (a) build: the native GT library ({out['library']}) with "
      f"g++ {' '.join(native.GXX_FLAGS)} in {out['build_s']:.2f} s"
      + (" (a fresh build beside the checkout's existing one)" if existed
         else " at its first use")
      + f"; os.cpu_count() {out['cpu_count']}")

  h7_batch, _ = triangle_batch(torch, image, camera, SEED + 41)
  y1_batch, _ = triangle_batch(torch, image, camera, SEED + 61,
                               irm=Y1_VOX["image_resolution_multiplier"],
                               res=Y1_NATIVE[0])
  out["grids"] = {
      "h7": host_grid_row(torch, mods[3], "h7 (phase 6's batch, 128³, irm 8)",
                          h7_batch, OUTPUT_RES, H7_VOX, dev),
      "y1": host_grid_row(torch, mods[3], "y1 (phase 8's batch, 32³, "
                          "sub-grid, irm 31)", y1_batch, Y1_NATIVE, Y1_VOX,
                          dev)}
  del h7_batch, y1_batch

  with tempfile.TemporaryDirectory() as root:
    manifest, meshes_dir = write_eval_dataset(root, SEED + 140,
                                              scenes=HOST_GT_SCENES)
    runs = {}
    for mode in ("host", "device"):
      runs[mode], first_batch = host_gt_training(
          torch, mods, host_gt_train_config(manifest, meshes_dir, root,
                                            f"h7_{mode}"), mode, dev)
      if mode == "host":
        host_first_batch = first_batch
      torch.cuda.empty_cache()
    out["train"] = runs
    log(f"host-gt (c) on host GT against device GT: step "
        f"{runs['host']['step_ms']:.3f} against {runs['device']['step_ms']:.3f}"
        f" ms, loader wait {runs['host']['wait_ms']:.3f} against "
        f"{runs['device']['wait_ms']:.3f} ms, period "
        f"{runs['host']['period_ms']:.3f} against "
        f"{runs['device']['period_ms']:.3f} ms, idle share "
        f"{runs['host']['idle_share']} against {runs['device']['idle_share']}")
    if set(host_first_batch) != set(GT_KEYS) | {"image", "camera", "grid",
                                                "v2x"}:
      raise AssertionError(f"host-gt (c): the host-GT batch holds "
                           f"{sorted(host_first_batch)}")
    model_config = model_config_from_train_config(
        cfg.config_from_dict(cfg.TrainPipeline, host_gt_train_config(
            manifest, meshes_dir, root, "x")).train, 2)
    out["float32"] = host_gt_float32_loss(torch, mods, CoreNet, model_config,
                                          host_first_batch, dev)
    del host_first_batch
    torch.cuda.empty_cache()
    out["cli"] = host_gt_cli(torch, mods, host_gt_train_config(
        manifest, meshes_dir, root, "h7_host_cli"), root)
    torch.cuda.empty_cache()
    out["tools"] = tools_and_importer(torch, CoreNet, manifest, meshes_dir,
                                      root, dev)
  out["seconds"] = time.perf_counter() - phase_start
  log(f"host-gt: phase 14 took {out['seconds']:.1f} s")
  return out


# Phase 15: the 'space' axis (parallel/mesh.py::create_mesh, the
# depth-sharded decoder of models/decoder.py): DIST_WORLD gloo ranks on
# cuda:0 laid out as data 1 × space DIST_WORLD, each a depth slab of the
# decoder on the same batch of 4, against one process on that batch with
# the same weights, by phase 13 (b)'s rules (float32: loss and statistics
# within 1e-5, gradients by the step levels; bf16: the loss within
# DIST_BF16_LOSS_TOL). (a) the packed h7 step (pack_from_stage 5) in bf16
# and in float32, (b) the fine h7 step in float32 (the fine halos); each
# with its launches per rank, its collectives, both ranks bit-equal, its
# step time (TRAIN_RUNS steps, both ranks at once on the one card) and
# its peak memory per rank beside one process's. (c) TrainPipeline at
# DIST_RES with --space's layout for SPACE_STEPS steps.
SPACE_CASES = (("packed bfloat16", "bfloat16", True),
               ("packed float32", None, True),
               ("fine float32", None, False))
SPACE_STEPS = 4
SPACE_SCENES = 5


@contextlib.contextmanager
def caught_results(module, name, record):
  """Wraps module.name to append each call's result to `record`."""
  real = getattr(module, name)

  def wrapped(*args, **kwargs):
    record.append(real(*args, **kwargs))
    return record[-1]

  setattr(module, name, wrapped)
  try:
    yield
  finally:
    setattr(module, name, real)


def part_peaks(torch, model, optimizer, dev, run):
  """Runs `run()` (one step) with the peak of allocated memory read and
  reset at the step's seams: the GT (up to the model's forward), the
  forward, the backward (the loss, its backward and the gradients'
  all-reduce, up to the optimizer) and the optimizer's update. Returns
  (run's result, {part: peak bytes})."""
  parts, current = {}, ["gt"]

  def seam(name):
    def hook(*_):
      parts[current[0]] = torch.cuda.max_memory_allocated(dev)
      torch.cuda.reset_peak_memory_stats(dev)
      current[0] = name
    return hook

  hooks = [model.register_forward_pre_hook(seam("forward")),
           model.register_forward_hook(seam("backward")),
           optimizer.register_step_pre_hook(seam("optimizer"))]
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats(dev)
  try:
    out = run()
    torch.cuda.synchronize()
    seam("done")()
  finally:
    for hook in hooks:
      hook.remove()
  return out, parts


def space_step(torch, mods, CoreNet, config, batch, dtype, packed, dev,
               depth_shard=None, route="shared", timed=True,
               deterministic=False):
  """run_space_step with the GT's route: "shared" over the space group
  where the batch divides (the step's own choice), or "replicated" (the
  sharing turned off: train/gt.py::shares_over_space)."""
  from corenet_tpu_torch.train import gt
  shares = gt.shares_over_space
  if route == "replicated":
    gt.shares_over_space = lambda *_: False
  try:
    return run_space_step(torch, mods, CoreNet, config, batch, dtype, packed,
                          dev, depth_shard, timed, deterministic)
  finally:
    gt.shares_over_space = shares


def run_space_step(torch, mods, CoreNet, config, batch, dtype, packed, dev,
                   depth_shard, timed, deterministic):
  """One h7 step from SEED + 160's weights on `batch`, a second one with
  the peak of each of its parts (part_peaks; Adam's moments exist from
  the first), then (`timed`) TRAIN_RUNS timed steps: its figures, with
  the peak of memory allocated over all of them above what was allocated
  before the model was made, and in the first step the memory the
  decoder's forward leaves allocated (its saved activations and logits)
  and what was allocated above the start when it began (the GT's labels
  and the encoder's saved activations), the labels' digest, and the
  batch of each K3 and K4 launch. `deterministic` runs cuDNN's
  deterministic algorithms."""
  from corenet_tpu_torch.train import gt
  from corenet_tpu_torch.train.state import create_train_state
  from corenet_tpu_torch.train.step import make_train_step
  op, _, raster, phased = mods
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  base = torch.cuda.memory_allocated(dev)
  torch.cuda.reset_peak_memory_stats(dev)
  model, _ = seeded_model(torch, CoreNet, config, SEED + 160,
                          phase_output=True,
                          compute_dtype=getattr(torch, dtype) if dtype
                          else None, packed_decoder=packed,
                          depth_shard=depth_shard)
  state = create_train_state(model, device=dev)
  step = make_train_step(state.model, state.optimizer, "FG_BG", OUTPUT_RES,
                         voxelization_kwargs=H7_VOX)
  backwards, labels, k3_calls, k4_calls = [], [], [], []
  marks = []
  hooks = [model.decoder.register_forward_pre_hook(
      lambda *_: marks.append(torch.cuda.memory_allocated(dev))),
           model.decoder.register_forward_hook(
               lambda *_: marks.append(torch.cuda.memory_allocated(dev)))]
  torch.cuda.synchronize()
  zero_counts(*mods)
  count = counter("mesh.collectives")
  routes = route_counts()
  start = torch.cuda.memory_allocated(dev)
  torch.backends.cudnn.deterministic = deterministic
  try:
    with contextlib.ExitStack() as stack:
      stack.enter_context(caught_calls(op, "skip_gather_backward", backwards))
      stack.enter_context(caught_results(gt, "labels_slab", labels))
      # Each launch's scenes only: its tensors would move the peaks.
      scenes = lambda args, kwargs: args[0].shape[0]  # noqa: E731
      stack.enter_context(caught_calls(raster, "blocked_raster_forward",
                                       k3_calls, scenes))
      stack.enter_context(caught_calls(phased, "phased_gt_forward",
                                       k4_calls, scenes))
      (state, metrics), renorm = renorm_collectives(
          torch, model, lambda: step(state, batch))
      torch.cuda.synchronize()
  finally:
    torch.backends.cudnn.deterministic = False
    for hook in hooks:
      hook.remove()
  if len(labels) != 1:
    raise AssertionError(f"space step: {len(labels)} labels_slab calls")
  out = {"decoder_forward_gib": (marks[1] - marks[0]) / 2**30,
         "before_decoder_gib": (marks[0] - start) / 2**30,
         "loss": float(metrics["loss"]), "launches": launch_counts(*mods),
         "k3_scenes": k3_calls, "k4_scenes": k4_calls,
         "labels_digest": tensors_digest([labels[0][0].cpu()]),
         "labels_shape": list(labels[0][0].shape),
         "packed_order_backwards": sum(1 for args, _ in backwards
                                       if args[0].dim() == 4),
         "collectives": counter("mesh.collectives") - count,
         "routes": {k: v - routes[k] for k, v in route_counts().items()
                    if v != routes[k]},
         "renorm_collectives": renorm,
         "shard_stage": model.decoder.shard_stage,
         "global_step": state.global_step,
         "grads": {n: p.grad.detach().float().cpu()
                   for n, p in model.named_parameters()},
         "stats": {n: b.detach().cpu() for n, b in model.named_buffers()},
         "params_digest": params_digest(model)}
  del labels
  first_peak = torch.cuda.max_memory_allocated(dev)
  _, peaks = part_peaks(torch, model, state.optimizer, dev,
                        lambda: step(state, batch))
  out["part_peak_gib"] = {k: (v - base) / 2**30 for k, v in peaks.items()}
  if timed:
    times = step_times(torch, step, state, batch)
    out.update(step_ms=statistics.median(times), step_ms_each=times)
  out["peak_gib"] = (max(first_peak, *peaks.values(),
                         torch.cuda.max_memory_allocated(dev)) - base) / 2**30
  del model, state, step, metrics
  torch.cuda.empty_cache()
  return out


def space_gt_times(torch, mods, rank, dev, batch):
  """Phase 15 (d)'s GT on the card, rank by rank while the other ranks
  wait: K3 and K4 (s = 4) on this rank's share of the scenes (the shared
  route's launches) and on the whole batch (the replicated route's),
  each against its plain version with the device time of the GT's parts
  (gt_kernel_rows)."""
  from corenet_tpu_torch.parallel import mesh
  from corenet_tpu_torch.train import gt
  _, _, raster, phased = mods
  per = BATCH // DIST_WORLD
  out = {}
  for turn in range(DIST_WORLD):
    mesh.barrier(f"space gt times {turn}")
    if turn != rank:
      continue
    for name, lo, n in (("share", rank * per, per), ("whole", 0, BATCH)):
      part = {k: batch[k][lo:lo + n] for k in GT_KEYS}
      rounds0 = counter("fill.rounds")
      packed_or, _ = gt.voxelize_batch_packed_fgbg(
          *(part[k] for k in GT_KEYS), resolution=OUTPUT_RES, **H7_VOX)
      rounds = counter("fill.rounds") - rounds0
      k3, k4, split = gt_kernel_rows(
          torch, raster, phased, part, packed_or, rounds, s=4,
          where=f"on rank {rank}'s {n} scenes ({name})")
      out[name] = {"scenes": n, "k3": k3, "k4": k4, "split": split}
      del packed_or
  mesh.barrier("space gt times done")
  # The labels' trade, on the host clock: what space_shared sends.
  depth = OUTPUT_RES[0] // 4 // DIST_WORLD
  rows = torch.zeros((DIST_WORLD, per, depth, OUTPUT_RES[1] // 4,
                      OUTPUT_RES[2] // 4 * 64), dtype=torch.uint8,
                     device=dev)
  times = []
  for _ in range(5):
    mesh.barrier("space all-to-all")
    torch.cuda.synchronize()
    begin = time.perf_counter()
    mesh.space_all_to_all(rows)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - begin) * 1e3)
  out["labels_all_to_all"] = {"bytes_per_rank": rows.numel(),
                              "ms": statistics.median(times)}
  return out


def space_worker_step(torch, mods, rank, dev, root, batch_path):
  """Phase 15 (a), (b) and (d) on one space rank: each case on its slab,
  the GT shared over the space ranks; the packed cases again with the GT
  replicated; then the GT's kernels and parts, rank by rank."""
  from corenet_tpu_torch.models.corenet import CoreNetConfig, DecoderConfig
  from corenet_tpu_torch.models.corenet import CoreNet
  from corenet_tpu_torch.parallel import mesh
  layout = mesh.create_mesh(space=DIST_WORLD)
  batch = {k: v.to(dev) for k, v in torch.load(batch_path).items()}
  config = CoreNetConfig(DecoderConfig(OUTPUT_RES, 2))
  out = {"layout": (layout.data, layout.space, mesh.space_index())}
  shard = (mesh.space_index(), DIST_WORLD)
  for name, dtype, packed in SPACE_CASES:
    result = space_step(torch, mods, CoreNet, config, batch, dtype, packed,
                        dev, depth_shard=shard)
    if rank != 0:  # rank 0's gradients stand for both (the digests)
      result["grads_digest"] = tensors_digest(result.pop("grads").values())
    out[name] = result
    if not packed:
      continue
    # (d): both routes under cuDNN's deterministic algorithms.
    for route in ("shared", "replicated"):
      again = space_step(torch, mods, CoreNet, config, batch, dtype, packed,
                         dev, depth_shard=shard, route=route, timed=False,
                         deterministic=True)
      if rank != 0:
        again["grads_digest"] = tensors_digest(again.pop("grads").values())
      out[name, route] = again
  out["gt_times"] = space_gt_times(torch, mods, rank, dev, batch)
  return out


def space_steps(torch, mods, CoreNet, config, host_batch, dev, root):
  """Phase 15 (a), (b) and (d): each case in one process, then on
  DIST_WORLD space ranks. Returns the figures."""
  path = os.path.join(root, "space_batch.pt")
  torch.save(host_batch, path)
  batch = {k: v.to(dev) for k, v in host_batch.items()}
  refs = {name: space_step(torch, mods, CoreNet, config, batch, dtype,
                           packed, dev)
          for name, dtype, packed in SPACE_CASES}
  del batch
  torch.cuda.empty_cache()
  start = time.perf_counter()
  ranks = run_dist_workers(torch, "space", "space", root, [path])
  out = {"workers_s": time.perf_counter() - start}
  failed = []
  for name, dtype, packed in SPACE_CASES:
    ref, got = refs[name], [r[name] for r in ranks]
    stage = got[0]["shard_stage"]
    # The data-parallel collectives (BatchRenorm's, the loss's mean and
    # its backward, the gradients' one), the IoU's sums over the space
    # group and their backward, the labels' all-to-all, and a halo
    # exchange forward and backward for each of the two convolutions of
    # every tower from the shard stage on. gloo on CUDA tensors: every
    # one an all-reduce (the halos' and the all-to-all's zeroed slots).
    halos = 2 * 2 * (7 - stage)
    want = got[0]["renorm_collectives"] + 2 + 1 + 2 + 1 + halos
    for rank, r in enumerate(got):
      if (r["launches"] != (4, 4, 1, 1, 1)
          or r["packed_order_backwards"] != (1 if packed else 0)
          or r["global_step"] != BATCH or r["collectives"] != want
          or r["routes"] != {"space_shared": 1}
          or r["k3_scenes"] != [BATCH // DIST_WORLD]
          or r["k4_scenes"] != [BATCH // DIST_WORLD]
          or r["shard_stage"] != 2):
        raise AssertionError(
            f"space {name} rank {rank} launched {r['launches']} "
            f"({r['packed_order_backwards']} backward(s) in packed order; "
            f"K3 on {r['k3_scenes']} and K4 on {r['k4_scenes']} scenes), "
            f"counted {r['global_step']}, made {r['collectives']} "
            f"collectives (expected {want} "
            f"all-reduces), took the GT routes {r['routes']}, sharded from "
            f"tower {r['shard_stage']}")
    if not (got[0]["loss"] == got[1]["loss"]
            and got[0]["params_digest"] == got[1]["params_digest"]
            and tensors_digest(got[0]["grads"].values())
            == got[1]["grads_digest"]
            and all(torch.equal(v, got[1]["stats"][k])
                    for k, v in got[0]["stats"].items())):
      raise AssertionError(f"space {name}: the ranks' losses, statistics, "
                           "gradients or parameters after Adam differ")
    loss_rel = abs(got[0]["loss"] - ref["loss"]) / abs(ref["loss"])
    stats_rel, stats_name = stats_gap(ref["stats"], got[0]["stats"])
    together, worst, worst_name, cosine, cosine_name, checked = grad_gap(
        ref["grads"], got[0]["grads"])
    levels = grad_levels(ref["grads"], got[0]["grads"])
    if dtype is None:
      ok = (loss_rel <= DIST_LOSS_TOL and stats_rel <= DIST_STATS_TOL
            and levels[0] >= 0.96 and levels[1] >= 0.90
            and levels[2] <= 0.05)
      rule = (f"loss {DIST_LOSS_TOL}, statistics {DIST_STATS_TOL}, "
              "gradients cosine ≥ 0.96 together, ≥ 0.90 each, 5 % next to "
              "the loss")
    else:
      ok = loss_rel <= DIST_BF16_LOSS_TOL
      rule = f"loss {DIST_BF16_LOSS_TOL}"
    figures = {
        "loss": ref["loss"], "loss_rel": loss_rel, "stats_rel": stats_rel,
        "worst_stat": stats_name, "grads_together_rel": together,
        "worst_grad_rel": worst, "worst_grad": worst_name,
        "lowest_cosine": cosine, "lowest_cosine_grad": cosine_name,
        "grads_checked": checked, "global_cosine": levels[0],
        "lowest_massive_cosine": levels[1],
        "near_loss_worst_rel": levels[2],
        "launches": [r["launches"] for r in got],
        "packed_order_backwards": got[0]["packed_order_backwards"],
        "collectives_per_step": got[0]["collectives"],
        "halo_collectives_per_step": halos, "shard_stage": stage,
        "one_process_step_ms": ref["step_ms"],
        "rank_step_ms": [r["step_ms"] for r in got],
        "one_process_peak_gib": ref["peak_gib"],
        "rank_peak_gib": [r["peak_gib"] for r in got],
        "one_process_part_peak_gib": ref["part_peak_gib"],
        "rank_part_peak_gib": [r["part_peak_gib"] for r in got],
        "one_process_decoder_forward_gib": ref["decoder_forward_gib"],
        "rank_decoder_forward_gib": got[0]["decoder_forward_gib"],
        "one_process_before_decoder_gib": ref["before_decoder_gib"],
        "rank_before_decoder_gib": got[0]["before_decoder_gib"], "ok": ok}
    out[name] = figures
    log(f"space ({'a' if packed else 'b'}) h7 {name} on data 1 × space "
        f"{DIST_WORLD} (gloo ranks on cuda:0, sharded from tower {stage}, "
        f"the GT shared over the space ranks) "
        f"against one process on the same 4 scenes: loss "
        f"{ref['loss']:.7f}, {loss_rel:.2e} relative; statistics "
        f"{stats_rel:.2e} ({stats_name}); gradients together "
        f"{together:.2e}, worst {worst:.2e} ({worst_name}), levels: cosine "
        f"together {levels[0]:.6f}, lowest {levels[1]:.6f}, next to the "
        f"loss {levels[2]:.2e}; launches per rank {figures['launches']} "
        f"({got[0]['packed_order_backwards']} backward(s) in packed order; "
        f"K3 and K4 each once on {BATCH // DIST_WORLD} scenes); "
        f"{got[0]['collectives']} all-reduces per step, {halos} of them "
        f"halo exchanges, 2 IoU sums over the space group and 1 labels' "
        f"all-to-all; both ranks' "
        f"losses, statistics, gradients and parameters after Adam "
        f"bit-equal; step (median of {TRAIN_RUNS}) {ref['step_ms']:.3f} ms "
        f"in one process, per rank {figures['rank_step_ms']} ms; peak "
        f"memory {ref['peak_gib']:.3f} GiB in one process, per rank "
        f"{[round(g, 3) for g in figures['rank_peak_gib']]} GiB (allocated "
        f"when the decoder's forward began {ref['before_decoder_gib']:.3f} "
        f"and {got[0]['before_decoder_gib']:.3f} GiB, left by it "
        f"{ref['decoder_forward_gib']:.3f} and "
        f"{got[0]['decoder_forward_gib']:.3f} GiB: one process and rank 0); "
        f"rule: {rule}: " + ("passed" if ok else "FAILED"))
    if not ok:
      failed.append(name)
    if packed:
      out[name]["d"] = space_routes(
          torch, ref, got, [r[name, "shared"] for r in ranks],
          [r[name, "replicated"] for r in ranks], name)
  out["gt_times"] = [r["gt_times"] for r in ranks]
  for rank, times in enumerate(out["gt_times"]):
    share, trade = times["share"], times["labels_all_to_all"]
    log(f"space (d) rank {rank}: GT device time on its {share['scenes']} "
        f"scenes {share['split']['sum_ms']:.4f} ms, on all {BATCH} "
        f"{times['whole']['split']['sum_ms']:.4f} ms (CUDA graphs, the other "
        f"rank waiting); K3 {share['k3']['ms']:.4f} and K4 (s = 4) "
        f"{share['k4']['ms']:.4f} ms on {share['scenes']} scenes, equal to "
        f"their plain versions; the labels' all-to-all {trade['ms']:.3f} ms "
        f"({trade['bytes_per_rank']} B per rank, the host clock)")
  log(f"space (a, b, d): the two ranks' processes took "
      f"{out['workers_s']:.1f} s")
  if failed:
    raise AssertionError(f"space steps outside their rules: {failed}")
  return out


def space_routes(torch, ref, timed, shared, replicated, name):
  """Phase 15 (d) for one packed case, both routes under cuDNN's
  deterministic algorithms: the GT shared over the space ranks against
  the GT replicated on each, rank by rank (labels, loss and statistics
  bit-equal; the gradients, which K1's backward adds with atomics in an
  order no two steps share, within DIST_SAME_GRAD_TOL each, but the conv
  biases a BatchRenorm normalizes (grad_gap); K3 and K4 on
  B/S and on B scenes; one collective more), the shared route's loss
  against one process's bit for bit, and the peaks of memory,
  whole and per part, beside one process's and the timed (a) run's.
  Returns the figures."""
  def gib(g):
    return round(g, 3)

  def parts(r):
    return {k: gib(v) for k, v in r["part_peak_gib"].items()}

  for rank, (s, r) in enumerate(zip(shared, replicated)):
    stats = [k for k, v in s["stats"].items()
             if not torch.equal(v, r["stats"][k])]
    unequal = [what for what, same in (
        ("labels", s["labels_digest"] == r["labels_digest"]
         and s["labels_shape"] == r["labels_shape"]),
        ("loss", s["loss"] == r["loss"]),
        (f"statistics {stats[:4]} (of {len(stats)})", not stats))
               if not same]
    if unequal:
      raise AssertionError(f"space (d) {name} rank {rank}: the shared and "
                           f"the replicated GT's {unequal} differ")
    if (r["routes"] != {"replicated": 1} or r["launches"] != s["launches"]
        or r["k3_scenes"] != [BATCH] or r["k4_scenes"] != [BATCH]
        or r["collectives"] != s["collectives"] - 1):
      raise AssertionError(
          f"space (d) {name} rank {rank}: the replicated route took "
          f"{r['routes']}, launched {r['launches']} (K3 on "
          f"{r['k3_scenes']}, K4 on {r['k4_scenes']} scenes), made "
          f"{r['collectives']} collectives against {s['collectives']}")
  if shared[0]["loss"] != ref["loss"]:
    raise AssertionError(f"space (d) {name}: the shared GT's loss "
                         f"{shared[0]['loss']!r} is not one process's "
                         f"{ref['loss']!r} bit for bit")
  # The conv biases a BatchRenorm normalizes are left out (grad_gap):
  # their true gradient is 0 and both sides hold rounding dust.
  _, worst_rel, worst, _, _, _ = grad_gap(replicated[0]["grads"],
                                          shared[0]["grads"])
  if not worst_rel <= DIST_SAME_GRAD_TOL:
    raise AssertionError(f"space (d) {name}: the shared and the replicated "
                         f"GT's gradient {worst} differ by {worst_rel}")
  out = {"labels_equal": True, "loss_equal": True, "statistics_equal": True,
         "worst_grad_rel": worst_rel, "worst_grad": worst,
         "grads_bit_equal": all(
             torch.equal(g, replicated[0]["grads"][k])
             for k, g in shared[0]["grads"].items()),
         "params_bit_equal": (shared[0]["params_digest"]
                              == replicated[0]["params_digest"]),
         "loss_equals_one_process": True,
         "one_process_peak_gib": ref["peak_gib"],
         "timed_shared_peak_gib": [t["peak_gib"] for t in timed],
         "shared_peak_gib": [s["peak_gib"] for s in shared],
         "replicated_peak_gib": [r["peak_gib"] for r in replicated],
         "one_process_part_peak_gib": ref["part_peak_gib"],
         "shared_part_peak_gib": [s["part_peak_gib"] for s in shared],
         "replicated_part_peak_gib": [r["part_peak_gib"] for r in replicated],
         "shared_collectives": shared[0]["collectives"],
         "replicated_collectives": replicated[0]["collectives"]}
  log(f"space (d) h7 {name}: the GT shared over the space ranks (K3 and K4 "
      f"once per rank on {BATCH // DIST_WORLD} scenes) against the GT "
      f"replicated (on {BATCH}), cuDNN deterministic: labels, loss and "
      f"statistics bit-equal on "
      f"both ranks; gradients (rank 0) worst {worst_rel:.2e} ({worst}; "
      f"bit-equal: {out['grads_bit_equal']}; parameters after Adam "
      f"bit-equal: {out['params_bit_equal']}); the loss equal to one "
      f"process's bit for bit; all-reduces per step shared "
      f"{out['shared_collectives']}, replicated "
      f"{out['replicated_collectives']}; peak memory per rank shared "
      f"{[gib(g) for g in out['shared_peak_gib']]} GiB (over the "
      f"{TRAIN_RUNS + 2} steps of (a): "
      f"{[gib(g) for g in out['timed_shared_peak_gib']]}), "
      f"replicated "
      f"{[gib(g) for g in out['replicated_peak_gib']]} GiB, one process "
      f"{gib(ref['peak_gib'])} GiB; peak by part of the second step (GiB "
      f"above the start) shared rank 0 {parts(shared[0])}, replicated rank 0 "
      f"{parts(replicated[0])}, one process {parts(ref)}")
  return out


def space_pipeline(torch, mods, dev, root):
  """Phase 15 (c): TrainPipeline on DIST_WORLD gloo ranks on cuda:0 laid
  out as data 1 × space DIST_WORLD (mesh=create_mesh(space=...)), at
  DIST_RES in bf16 with the phase loss, a batch of 1, SPACE_STEPS steps
  and no eval: both ranks train on the same batches, the epoch in the
  dataset's order, with the step's launches; rank 0 alone writes the
  checkpoints (the initial state and the last step's), which read back
  at the last step; both ranks end with the same weights. Returns the
  figures."""
  from corenet_tpu_torch import config as cfg
  from corenet_tpu_torch.data.manager import DatasetManager
  from corenet_tpu_torch.train import checkpoint
  manifest, meshes_dir = write_eval_dataset(
      os.path.join(root, "space_ds"), SEED + 170, scenes=SPACE_SCENES)
  full = dist_train_config(manifest, meshes_dir, root, "space_out")
  full["eval"] = []
  path = os.path.join(root, "space_train.json")
  with open(path, "w") as f:
    json.dump(full, f)
  start = time.perf_counter()
  ranks = run_dist_workers(torch, "pipeline", "space_pipeline", root,
                           [path, SPACE_STEPS, DIST_WORLD])
  seconds = time.perf_counter() - start
  dataset = DatasetManager(cfg.config_from_dict(
      cfg.TrainPipeline, full).train.data).create_dataset(local_seed=0)
  want = [[dataset[i].scene_id] for i in range(SPACE_STEPS)]
  for rank, r in enumerate(ranks):
    if (r["batches"] != want or r["depth_shard"] != (rank, DIST_WORLD)
        or set(r["launches"]) != {(4, 4, 1, 1, 1)}
        or len(r["launches"]) != SPACE_STEPS
        or r["global_step"] != SPACE_STEPS or r["fill_rounds"] != 6):
      raise AssertionError(
          f"space (c) rank {rank}: batches {r['batches']} (want {want}), "
          f"slab {r['depth_shard']}, launches {r['launches']}, global step "
          f"{r['global_step']}, fill rounds {r['fill_rounds']}")
  if not (ranks[0]["saves"] == [0, SPACE_STEPS] and ranks[1]["saves"] == []
          and ranks[0]["params_digest"] == ranks[1]["params_digest"]):
    raise AssertionError(f"space (c): saves {ranks[0]['saves']} and "
                         f"{ranks[1]['saves']}, or the ranks' weights differ")
  reader = checkpoint.CheckpointReader(
      os.path.join(full["output_path"], "cpt"))
  state, _, cpt_path = reader.read_last_checkpoint()
  if int(state.global_step) != SPACE_STEPS:
    raise AssertionError(f"space (c): {cpt_path} holds global step "
                         f"{state.global_step}")
  log(f"space (c) TrainPipeline on data 1 × space {DIST_WORLD} (gloo ranks "
      f"on cuda:0) at {DIST_RES[0]}³ in bf16, sharded from tower "
      f"{ranks[0]['shard_stage']}: both ranks trained on {want}; launches "
      f"per step (4, 4, 1, 1, 1); checkpoints by rank 0 only at 0 and "
      f"{SPACE_STEPS}, the last read back at step {SPACE_STEPS}; weights "
      f"equal; {seconds:.1f} s")
  return {"seconds": seconds, "batches": want,
          "launches": ranks[0]["launches"][0],
          "shard_stage": ranks[0]["shard_stage"]}


def space_phase(torch, mods, CoreNet, CoreNetConfig, DecoderConfig, image,
                camera, dev):
  """Phase 15: the 'space' axis. Returns the figures."""
  h7 = CoreNetConfig(DecoderConfig(OUTPUT_RES, 2))
  start = time.perf_counter()
  host, _ = triangle_batch(torch, image, camera, SEED + 161)
  with tempfile.TemporaryDirectory() as root:
    out = {"steps": space_steps(torch, mods, CoreNet, h7, host, dev, root)}
    steps_s = time.perf_counter() - start
    out["c"] = space_pipeline(torch, mods, dev, root)
  out["seconds"] = time.perf_counter() - start
  out["part_seconds"] = {"a, b": steps_s, "c": out["seconds"] - steps_s}
  log(f"space phase: {out['seconds']:.1f} s ((a, b) {steps_s:.1f} s, (c) "
      f"{out['seconds'] - steps_s:.1f} s)")
  return out


# Phase 16: the 'space' axis's exchanges (parallel/mesh.py) over NCCL, one
# card per rank: the labels' all-to-all against the row permutation and
# the halo exchange against its definition, forward and backward, bit for
# bit. It runs where the machine has two cards or more (up to NCCL_RANKS
# of them) and says so where it has one.
NCCL_RANKS = 4
NCCL_HALOS = ((2, 2), (3, 3), (0, 3))  # k5; k7 transposed; one side only
NCCL_SLAB = (BATCH, 32, 8, 32, 32)  # [B, C, slab, H, W]: h7's stage 3


def nccl_rows(torch, rank, world):
  """Rank `rank`'s all-to-all input: its share of phase-major h7 labels,
  one row per space rank, from a seed."""
  gen = torch.Generator().manual_seed(SEED + 190 + rank)
  depth = OUTPUT_RES[0] // 4 // world
  return torch.randint(0, 2, (world, BATCH // world, depth,
                              OUTPUT_RES[1] // 4, OUTPUT_RES[2] // 4 * 64),
                       generator=gen, dtype=torch.uint8)


def nccl_slab(torch, rank):
  """Rank `rank`'s slab and the output gradient of each halo case, from a
  seed, on the CPU."""
  gen = torch.Generator().manual_seed(SEED + 195 + rank)
  x = torch.randn(NCCL_SLAB, generator=gen)
  return x, {h: torch.randn(NCCL_SLAB[:2] + (h[0] + NCCL_SLAB[2] + h[1],)
                            + NCCL_SLAB[3:], generator=gen)
             for h in NCCL_HALOS}


def nccl_halo_reference(torch, rank, world, h):
  """The halo exchange's definition on rank `rank`: the neighbours' slices
  around its slab (zeros past the grid's ends), and its input gradient,
  the neighbours' halo gradients added back in the backward's order."""
  lo, hi = h
  size = NCCL_SLAB[2]
  x, douts = nccl_slab(torch, rank)
  prev = nccl_slab(torch, rank - 1) if rank > 0 else None
  nxt = nccl_slab(torch, rank + 1) if rank < world - 1 else None
  below = (prev[0].narrow(2, size - lo, lo) if prev
           else torch.zeros_like(x.narrow(2, 0, lo)))
  above = (nxt[0].narrow(2, 0, hi) if nxt
           else torch.zeros_like(x.narrow(2, 0, hi)))
  dx = douts[h].narrow(2, lo, size).clone()
  if prev:
    dx.narrow(2, 0, hi).add_(prev[1][h].narrow(2, lo + size, hi))
  if nxt:
    dx.narrow(2, size - lo, lo).add_(nxt[1][h].narrow(2, 0, lo))
  return torch.cat([below, x, above], 2), dx


def nccl_worker(torch, mods, rank, dev, root):
  """Phase 16 on one rank of an NCCL group: each exchange, with its
  collectives and its time on the host clock."""
  from corenet_tpu_torch.parallel import mesh
  world = mesh.process_count()
  mesh.create_mesh(space=world)
  x, douts = nccl_slab(torch, rank)
  x, douts = x.to(dev), {h: d.to(dev) for h, d in douts.items()}
  rows = nccl_rows(torch, rank, world).to(dev)

  def timed(fn):
    times = []
    for _ in range(10):
      mesh.barrier("nccl timing")
      torch.cuda.synchronize()
      begin = time.perf_counter()
      fn()
      torch.cuda.synchronize()
      times.append((time.perf_counter() - begin) * 1e3)
    return statistics.median(times)

  def halo(h):
    xt = x.clone().requires_grad_(True)
    y = mesh.halo_exchange(xt, 2, *h)
    (y * douts[h]).sum().backward()
    return y.detach(), xt.grad

  count = counter("mesh.collectives")
  out = {"a2a": mesh.space_all_to_all(rows).cpu(),
         "a2a_collectives": counter("mesh.collectives") - count,
         "a2a_ms": timed(lambda: mesh.space_all_to_all(rows))}
  for h in NCCL_HALOS:
    count = counter("mesh.collectives")
    y, dx = halo(h)
    out["halo", h] = (y.cpu(), dx.cpu(), counter("mesh.collectives") - count)
    out["halo_ms", h] = timed(lambda: halo(h))
  return out


def space_nccl_phase(torch):
  """Phase 16. Returns the figures."""
  count = torch.cuda.device_count()
  if count < 2:
    log(f"space-nccl: not run: this machine has {count} CUDA device(s), and "
        "the exchanges over NCCL need a card per rank (NCCL refuses two "
        "ranks on one card)")
    return {"ran": False, "cards": count}
  world = min(count, NCCL_RANKS)
  start = time.perf_counter()
  with tempfile.TemporaryDirectory() as root:
    ranks = run_dist_workers(torch, "nccl", "nccl", root, [], world=world,
                             card_per_rank=True)
  out = {"ran": True, "ranks": world, "seconds": time.perf_counter() - start,
         "a2a_ms": [r["a2a_ms"] for r in ranks],
         "halo_ms": {str(h): [r["halo_ms", h] for r in ranks]
                     for h in NCCL_HALOS}}
  for rank, r in enumerate(ranks):
    want = torch.stack([nccl_rows(torch, i, world)[rank]
                        for i in range(world)])
    if not (torch.equal(r["a2a"], want) and r["a2a_collectives"] == 1):
      raise AssertionError(f"space-nccl rank {rank}: the all-to-all is not "
                           f"the row permutation, or took "
                           f"{r['a2a_collectives']} collectives")
    for h in NCCL_HALOS:
      y, dx, collectives = r["halo", h]
      want_y, want_dx = nccl_halo_reference(torch, rank, world, h)
      if not (torch.equal(y, want_y) and torch.equal(dx, want_dx)
              and collectives == 2):
        raise AssertionError(f"space-nccl rank {rank}: halos {h} differ "
                             f"from their definition, or took "
                             f"{collectives} collectives")
  log(f"space-nccl: {world} ranks over NCCL, a card each: the labels' "
      f"all-to-all is the row permutation and the halos {NCCL_HALOS} "
      f"(forward and backward, {list(NCCL_SLAB)} slabs) equal their "
      f"definition bit for bit, each by zeroed-slot all-reduces; host ms "
      f"per call on the card's tensors (median of 10) all-to-all "
      f"{out['a2a_ms']}, halo forward + backward {out['halo_ms']}; "
      f"{out['seconds']:.1f} s")
  return out


def main() -> int:
  smoke_start = time.perf_counter()
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
  from corenet_tpu_torch.ops import blocked_raster as raster
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
  zero_counts(op)
  start = time.perf_counter()
  pmf_seq = sequential(*args)
  torch.cuda.synchronize()
  seq_s = time.perf_counter() - start
  if launch_counts(op)[0] != 4 * 64:
    raise AssertionError(f"y1 sequential passes launched skip_gather "
                         f"{launch_counts(op)[0]} times, expected 256")
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
  mods = (op, fgbg, raster, phased)
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
                        image, camera, v2x, offsets, dev)
  torch.cuda.empty_cache()

  # 13. Data parallelism over processes: NCCL at world 1, 2 gloo ranks.
  dist = dist_phase(torch, mods, CoreNet, CoreNetConfig, DecoderConfig,
                    image, camera, v2x, dev)
  torch.cuda.empty_cache()

  # 14. Ground truth on the host (native C++ in the loader), the dataset
  # tool and the importer.
  host_gt = host_gt_phase(torch, mods, CoreNet, image, camera, dev)
  torch.cuda.empty_cache()

  # 15. The 'space' axis: the decoder's depth over 2 gloo ranks.
  space = space_phase(torch, mods, CoreNet, CoreNetConfig, DecoderConfig,
                      image, camera, dev)
  torch.cuda.empty_cache()

  # 16. The 'space' axis's NCCL transports, where there are several cards.
  space_nccl = space_nccl_phase(torch)

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
                packed["train"]["packed pfs 5, bfloat16"]["launches"][i],
            "h7 train packed bf16 in an NCCL group of one, 1 step":
                dist["a"]["launches"][i],
            **{f"h7 train packed {name} on 2 gloo ranks, rank {rank}, 1 "
               f"step": dist["b"][f"{name} split"]["launches"][rank][i]
               for name, _ in DIST_DTYPES for rank in range(DIST_WORLD)},
            "TrainPipeline on 2 gloo ranks at 32³, rank 0, 1 step":
                dist["c"]["launches"][i],
            "h7 TrainPipeline packed bf16 on host GT, 1 step":
                host_gt["train"]["host"]["launches"][i],
            **{f"h7 train {name} on data 1 × space {DIST_WORLD}, rank "
               f"{rank}, 1 step": space["steps"][name]["launches"][rank][i]
               for name, _, _ in SPACE_CASES for rank in range(DIST_WORLD)},
            f"TrainPipeline on data 1 × space {DIST_WORLD} at 32³, rank 0, "
            "1 step": space["c"]["launches"][i]}

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
                                    "bound_ms", "bound_by")},
       "library_ms": None, "library_call": None,
       "timing": entry["timing"], "shapes": [row]}
      for name, source, replaces, index, launches, row in (
          ("blocked_raster_or", "blocked_raster",
           "corenet_tpu/ops/block_scatter.py:219 with "
           "corenet_tpu/voxel/raster_fast.py:147 (_phase_a)", 3,
           gt_launches[3], k3_row),
          ("phased_gt", "phased_gt", "corenet_tpu/ops/phased_gt.py:128", 4,
           gt_launches[4], k4_row))]
  # The standalone scatter, which no main path calls any more (phase 6
  # checks that its step launched it 0 times): held to its plain version
  # at the step's shapes all the same.
  scatter_row = k3_row.pop("scatter")
  gt_entries.append(
      {"name": "block_scatter_or (standalone)", "route": "cuda",
       "source": "corenet_tpu_torch/csrc/block_scatter.cu",
       "replaces": "corenet_tpu/ops/block_scatter.py:219", "launches": 0,
       **{key: scatter_row[key] for key in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms")},
       "library_call": None, "timing": entry["timing"],
       "shapes": [scatter_row]})
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
                      "fine_mean_run_along_z", "z_chunk", "flushes",
                      "fine_flushes", "phase_by_phase_flushes")},
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
  # K3 and K4 on a space rank (phase 15 (d)): one launch each per step on
  # the rank's share of the scenes, held against their plain versions.
  space_case = space["steps"]["packed bfloat16"]
  for index, (gt_entry, key) in enumerate(((gt_entries[0], "k3"),
                                          (gt_entries[1], "k4")), 3):
    gt_entry["space_rank"] = [
        {"rank": rank, "launches": space_case["launches"][rank][index],
         "scenes": times["share"]["scenes"],
         **{k: times["share"][key][k]
            for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")}}
        for rank, times in enumerate(space["steps"]["gt_times"])]
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
  entry["distributed"] = dist
  entry["host_gt"] = host_gt
  entry["space"] = space
  entry["space_nccl"] = space_nccl
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
  log(f"smoke: all 16 phases in {time.perf_counter() - smoke_start:.1f} s")
  log(smi)
  log(json.dumps({"kernels": [entry, bwd_entry, fgbg_entry] + gt_entries
                  + packed_entries}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": kind,
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  if sys.argv[1:2] == ["--dist-worker"]:
    sys.exit(dist_worker(sys.argv[2:]))
  sys.exit(main())
