"""Training driver: `TrainPipeline.train_steps()`, the train CLI's loop of
loader → ground truth voxelized in the step → forward → loss → backward →
Adam, on a seeded dataset that set-up writes into the run's scratch
directory under TMPDIR.

Set-up builds one pipeline from the configuration's `train` section (its
loader included), loads the benchmark's seeded weights into its model,
gives it the state and step that `TrainPipeline.create_or_load_state`
makes (a fresh Adam; no checkpoint is written or read), and drives it
through `warmup_steps` steps: the first three are the ones the reference
follows, and the rest drain what the loader built ahead while the first
step compiled (its queue of `prefetch_factor` batches and the batch in
its producer's hands), so that the window starts at the loader's steady
fill. The window then steps the same generator for its seconds; a step
is counted when the window's closing synchronize finds it done.

`correct`: the reference works the first three steps out again from the
scene files and the initial weights (benchmark/reference/train.py), and
the first step's loss, each leaf's gradient norm in the first step (the
program's read from Adam's first moment) and each leaf's change after
the third are compared, by the median leaf's gap, each leaf's gap taken
against the larger of that leaf's and the median leaf's reference norm.
Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by rounding alone, and are left out of the
change. The worst leaves are printed, not compared: for the widest
change leaves each side's update in each of the three steps (its norm,
the share of its elements whose sign turned from the step before, and
the share whose sign differs between the sides), and the widest gap of
a single step's update over all leaves (PERF.md gives the readings).
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import scenes, weights
from benchmark.reference import gt as ref_gt
from benchmark.reference import model as ref
from benchmark.reference import precision
from benchmark.reference import train as ref_train
from benchmark.counts import flops as flop_counts
from benchmark.counts import raster as raster_counts
from benchmark.counts.peaks import PEAK_FLOPS

FOLLOWED = 3  # steps that the reference follows
BETA1 = 0.9
EARLY_S = 20.0  # the window's first seconds, whose rate is printed apart


class State:
  pass


def _spec(ctx):
  m = ctx.config["model"]
  return weights.shapes((m["resolution"],) * 3, m["num_classes"],
                        m["latent_channels"], m["skip_fraction"],
                        m["last_upscale_factor"])


def _batch(ctx) -> int:
  return ctx.config["train"]["data"]["data_loader"]["batch_size"]


def _dataset(ctx) -> str:
  data_dir = os.path.join(ctx.scratch, "data")
  scenes.write_dataset(data_dir, ctx.traffic, ctx.seed)
  return data_dir


def _batches(ctx, steps: range) -> List[np.ndarray]:
  """The scene indices of the batch at each step of `steps` (the first
  epoch's order)."""
  order = ref_gt.epoch_order(ctx.traffic["scenes"])
  b = _batch(ctx)
  return [order[k * b:(k + 1) * b] for k in steps]


def setup(ctx) -> State:
  from corenet_tpu_torch.config import config as cfg
  from corenet_tpu_torch.train.pipeline import TrainPipeline
  from corenet_tpu_torch.train.state import create_train_state
  from corenet_tpu_torch.train.step import make_train_step
  s = State()
  s.ctx = ctx
  s.data_dir = _dataset(ctx)
  ctx.mark("dataset")
  train = json.loads(json.dumps(ctx.config["train"]).replace(
      "{data_dir}", s.data_dir))
  s.config = cfg.config_from_dict(cfg.TrainConfig, train)
  s.pipe = pipe = TrainPipeline(
      s.config, os.path.join(ctx.scratch, "out"),
      compute_dtype=ctx.config["train_precision"], device=ctx.device)
  s.weights = weights.make(_spec(ctx), ctx.seed, ctx.device)
  pipe.model.load_state_dict(s.weights, strict=True)
  pipe.state = create_train_state(pipe.model, s.config.initial_learning_rate,
                                  s.config.adam_epsilon, device=pipe.device)
  pipe.train_step = make_train_step(
      pipe.model, pipe.state.optimizer, pipe.task_type, pipe.resolution,
      voxelization_kwargs=dict(pipe.voxelization_kwargs,
                               algorithm=pipe.gt_algorithm))
  ctx.mark("pipeline and weights")
  s.steps = pipe.train_steps()
  named = list(pipe.model.named_parameters())
  s.losses: List[float] = []
  s.trail: List[Dict[str, torch.Tensor]] = []  # the leaves after each step
  for k in range(ctx.traffic["warmup_steps"]):
    _, metrics = next(s.steps)
    ctx.mark(f"step {k + 1}")
    if k < FOLLOWED:
      s.losses.append(float(metrics["loss"]))
      s.trail.append({n: p.detach().to("cpu", torch.float32, copy=True)
                      for n, p in named})
    if k == 0:
      opt = pipe.state.optimizer
      s.grad = dict(zip([n for n, _ in named], torch.stack(
          [(opt.state[p]["exp_avg"] / (1 - BETA1)).norm()
           for _, p in named]).tolist()))
    if k == FOLLOWED - 1:
      s.change = dict(zip([n for n, _ in named], torch.stack(
          [(p.detach() - s.weights[n]).norm() for n, p in named]).tolist()))
  _sync(ctx.device)
  return s


def _sync(device):
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def window(s: State, seconds: float) -> Dict:
  ctx = s.ctx
  t0 = time.perf_counter()
  ends = []
  while time.perf_counter() - t0 < seconds:
    next(s.steps)
    ends.append(time.perf_counter())
  _sync(ctx.device)
  window_s = time.perf_counter() - t0
  n = len(ends)
  b = _batch(ctx)
  ends = np.asarray(ends) - t0
  gaps_ms = np.diff(np.concatenate([[0.0], ends])) * 1e3
  print("window: step ms p10 %.1f p50 %.1f p90 %.1f max %.1f" % (
      *np.percentile(gaps_ms, [10, 50, 90]), gaps_ms.max()),
      file=sys.stderr)
  early = min(EARLY_S, seconds / 2)
  k = int((ends <= early).sum())
  print(f"window: scenes/s over its first {early:g} s {k * b / early:.3f}, "
        f"over the rest {(n - k) * b / (window_s - early):.3f}",
        file=sys.stderr)
  return {"e2e": {"train_scenes_per_s": n * b / window_s},
          "attempted": n, "failed": 0, "window_s": window_s, "steps": n,
          "units": n}


def counts(s: State, result: Dict) -> Dict:
  """The model's operations over the window (3 × forward per scene)
  against the card's peak, and the rasterizer's least time over the
  window's batches, counted from their scenes."""
  ctx = s.ctx
  m = ctx.config["model"]
  res = m["resolution"]
  vc = ctx.config["train"]["data"]["voxelization_config"]
  irm = vc["voxelization_image_resolution_multiplier"]
  per_scene = 3 * flop_counts.forward(ctx.traffic["image_hw"], res,
                                      m["num_classes"], m["latent_channels"],
                                      m["skip_fraction"],
                                      m["last_upscale_factor"])
  first = ctx.traffic["warmup_steps"]
  edge = ref_gt.max_edge_view(irm, res)
  raster_s = 0.0
  for batch in _batches(ctx, range(first, first + result["steps"])):
    sizes = [sum(len(ref_gt.subdivide(t, edge)) for _, t in
                 _scene(s.data_dir, i)[2]) for i in batch]
    padded = 8
    while padded < max(sizes):
      padded *= 2
    raster_s += raster_counts.bound_s(sum(sizes), len(batch), padded, res,
                                      irm)
  scenes_done = result["steps"] * _batch(ctx)
  return {"model_flops": per_scene * scenes_done,
          "peak_flops": PEAK_FLOPS[ctx.config["train_precision"]],
          "raster_bound_s": raster_s}


def _scene(data_dir: str, i: int):
  return ref_gt.read_scene(os.path.join(data_dir, f"scene_{i:05d}.npz"),
                           os.path.join(data_dir, "meshes"))


def _release(s: State) -> None:
  s.steps.close()
  s.pipe = s.steps = None
  gc.collect()
  if s.ctx.device.type == "cuda":
    torch.cuda.empty_cache()


def _reference(ctx, data_dir: str, p0, low=None, keep: int = 0,
               trail: bool = False) -> Dict:
  """The reference's three steps on the window's first batches; `keep` > 0
  keeps that many scenes of each batch (a fault: the rest left out)."""
  m = ctx.config["model"]
  res = m["resolution"]
  vc = ctx.config["train"]["data"]["voxelization_config"]
  irm = vc["voxelization_image_resolution_multiplier"]
  batches = []
  for batch in _batches(ctx, range(FOLLOWED)):
    items = [_scene(data_dir, i) for i in batch[:keep or None]]
    batches.append({
        "image": torch.from_numpy(np.stack([x[0] for x in items])).to(
            ctx.device),
        "camera": torch.from_numpy(np.stack([x[1] for x in items])).to(
            ctx.device),
        "labels": ref_gt.fgbg_labels([x[2] for x in items], res, irm,
                                     ctx.device)})
  dtype = {"bfloat16": torch.bfloat16, "float32": None}[
      ctx.config["train_precision"]]
  train = ctx.config["train"]
  return ref_train.steps(p0, batches, (res,) * 3,
                         train["initial_learning_rate"],
                         train["adam_epsilon"], ref.Precision(dtype, low),
                         trail)


def gaps(got: Dict, want: Dict) -> Dict[str, float]:
  """The compared numbers of `got` (losses, grad, change) against the
  reference `want`: the first step's loss gap and the median leaf's
  gradient and change gaps; and three that are read but not compared:
  the widest loss gap over the steps and the worst leaf's gradient and
  change gaps."""
  losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                want["losses"])]
  grad_median = float(np.median(list(want["grad"].values())))

  def leaf_gaps(key, names):
    floor = float(np.median([want[key][n] for n in names]))
    return [abs(got[key][n] - want[key][n]) / max(want[key][n], floor)
            for n in names]

  names = list(want["grad"])
  moved = [n for n in names if want["grad"][n] >= 1e-3 * grad_median]
  change = leaf_gaps("change", moved)
  grad = leaf_gaps("grad", names)
  return {"loss_gap": losses[0], "grad_gap": float(np.median(grad)),
          "change_gap": float(np.median(change)),
          "loss_gap_worst_step": max(losses), "grad_worst_leaf": max(grad),
          "change_worst_leaf": max(change)}


def worst_leaves(got: Dict, want: Dict, key: str, count: int = 3):
  """The leaves of `key` whose gaps are widest: (name, gap, got, want)."""
  floor = float(np.median(list(want[key].values())))
  rows = [(n, abs(got[key][n] - want[key][n]) / max(want[key][n], floor),
           got[key][n], want[key][n]) for n in want[key]]
  return sorted(rows, key=lambda r: -r[1])[:count]


def check(s: State):
  _release(s)
  ctx = s.ctx
  want = _reference(ctx, s.data_dir, s.weights, trail=True)
  got = {"losses": s.losses, "grad": s.grad, "change": s.change}
  for key in ("grad", "change"):
    for row in worst_leaves(got, want, key):
      print(f"widest {key} gap: {row}", file=sys.stderr)
  grad_median = float(np.median(list(want["grad"].values())))
  moved = [n for n, g in want["grad"].items() if g >= 1e-3 * grad_median]
  look(s.trail, want["trail"], s.weights, moved,
       [row[0] for row in worst_leaves(got, want, "change")])
  s.trail = want["trail"] = None
  limits = ctx.cell["limits"]
  readings = gaps(got, want)
  for k, v in readings.items():
    if k not in limits:
      print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
  return [(k, v, limits[k]) for k, v in readings.items() if k in limits]


def _turned(a: torch.Tensor, b: torch.Tensor) -> float:
  """The share of the elements, nonzero in both, whose signs differ."""
  both = (a != 0) & (b != 0)
  return float(((a * b < 0) & both).sum()) / max(int(both.sum()), 1)


def look(got_trail, want_trail, p0, names, widest) -> None:
  """Prints why a leaf's change after the three steps parts from the
  reference's: each step's update (θₖ − θₖ₋₁) of the leaves `widest` on
  both sides, by its norm, the share of its elements whose sign turned
  from the step before, and the share whose sign differs between the
  sides; the three steps' change over the sum of the updates' norms (1
  where every step moves the same way); and, over the leaves `names`,
  the widest gap of a single step's update norm, against the larger of
  the leaf's and the median leaf's reference norm in that step."""
  steps = {}
  for side, trail in (("program", got_trail), ("reference", want_trail)):
    prev = {n: p0[n].detach().float().cpu() for n in names}
    steps[side] = []
    for theta in trail:
      steps[side].append({n: theta[n] - prev[n] for n in names})
      prev = theta
  ug, uw = steps["program"], steps["reference"]
  worst = (0.0, "", 0)
  for k in range(len(uw)):
    norms = {n: (float(ug[k][n].norm()), float(uw[k][n].norm()))
             for n in names}
    floor = float(np.median([w for _, w in norms.values()]))
    for n, (g, w) in norms.items():
      if abs(g - w) / max(w, floor) > worst[0]:
        worst = (abs(g - w) / max(w, floor), n, k + 1)
  print(f"look: widest gap of one step's update, over the leaves: {worst}",
        file=sys.stderr)
  for n in widest:
    if n not in names:
      continue
    for side, u in steps.items():
      norms = [float(x[n].norm()) for x in u]
      change = float(sum(x[n] for x in u).norm())
      path = sum(norms) or float("nan")
      turned = [_turned(u[k - 1][n], u[k][n]) for k in range(1, len(u))]
      print(f"look {n} {side}: update norms {norms}, change {change}, "
            f"change / their sum {change / path}, sign turned from "
            f"the step before {turned}", file=sys.stderr)
    differ = [_turned(ug[k][n], uw[k][n]) for k in range(len(uw))]
    print(f"look {n}: sign differs between the sides {differ}",
          file=sys.stderr)


def control(ctx) -> Dict:
  """The reference one precision down (fp8 operands for bf16) in the
  program's place, against the reference."""
  data_dir = _dataset(ctx)
  p0 = weights.make(_spec(ctx), ctx.seed, ctx.device)
  want = _reference(ctx, data_dir, p0)
  return gaps(_reference(ctx, data_dir, p0, low=precision.fp8), want)


def fault(ctx, name: str) -> Dict:
  """The reference with a planted fault in the program's place, against
  the reference: 'half_batch' leaves half of each batch out, the mean
  taken over the rest. 'one_ulp' plants none: it is the reach of the
  rounding alone, the reference from initial weights one ulp above the
  reference's, with the look at the change (`look`) printed."""
  if name not in ("half_batch", "one_ulp"):
    raise ValueError(f"the training driver plants no fault {name!r}")
  data_dir = _dataset(ctx)
  p0 = weights.make(_spec(ctx), ctx.seed, ctx.device)
  if name == "half_batch":
    want = _reference(ctx, data_dir, p0)
    return gaps(_reference(ctx, data_dir, p0, keep=_batch(ctx) // 2), want)
  want = _reference(ctx, data_dir, p0, trail=True)
  up = {k: torch.nextafter(v, torch.full_like(v, float("inf")))
        if k in want["grad"] else v for k, v in p0.items()}
  got = _reference(ctx, data_dir, up, trail=True)
  grad_median = float(np.median(list(want["grad"].values())))
  moved = [n for n, g in want["grad"].items() if g >= 1e-3 * grad_median]
  look(got["trail"], want["trail"], p0, moved,
       [row[0] for row in worst_leaves(got, want, "change")])
  return gaps(got, want)
