"""What the training drivers that came after benchmark/drivers/train.py
share with it: a `TrainPipeline` built from the configuration's `train`
section with the benchmark's seeded weights, its warm-up steps, the first
of which keep the numbers that `correct` compares, the comparison with
the reference's, and the reach of the rounding (as drivers/train.py's
set-up, check and 'one_ulp' fault do)."""

from __future__ import annotations

import json
import sys
from typing import Callable, Dict, List

import numpy as np
import torch

from benchmark.drivers.train import (
    BETA1, FOLLOWED, _spec, gaps, look, worst_leaves)
from benchmark.harness import weights


def pipeline(s, data_dir: str, out_dir: str, device) -> None:
  """Sets `s.pipe` (the pipeline, its model loaded with the seeded
  weights, a fresh Adam and the step that `create_or_load_state` makes),
  `s.weights` and `s.steps` (its step generator)."""
  from corenet_tpu_torch.config import config as cfg
  from corenet_tpu_torch.train.pipeline import TrainPipeline
  from corenet_tpu_torch.train.state import create_train_state
  from corenet_tpu_torch.train.step import make_train_step
  ctx = s.ctx
  train = json.loads(json.dumps(ctx.config["train"]).replace(
      "{data_dir}", data_dir))
  config = cfg.config_from_dict(cfg.TrainConfig, train)
  s.pipe = pipe = TrainPipeline(config, out_dir,
                                compute_dtype=ctx.config["train_precision"],
                                device=device)
  s.weights = weights.make(_spec(ctx), ctx.seed, pipe.device)
  pipe.model.load_state_dict(s.weights, strict=True)
  pipe.state = create_train_state(pipe.model, config.initial_learning_rate,
                                  config.adam_epsilon, device=pipe.device)
  pipe.train_step = make_train_step(
      pipe.model, pipe.state.optimizer, pipe.task_type, pipe.resolution,
      voxelization_kwargs=dict(pipe.voxelization_kwargs,
                               algorithm=pipe.gt_algorithm))
  s.steps = pipe.train_steps()


def warm(s, keep: bool = True) -> None:
  """The traffic's warm-up steps. With `keep`: the first steps' losses
  (`s.losses`), the leaves after each (`s.trail`), each leaf's gradient
  norm in the first step, read from Adam's first moment (`s.grad`), and
  each leaf's change after the last followed step (`s.change`)."""
  ctx, pipe = s.ctx, s.pipe
  named = list(pipe.model.named_parameters())
  s.losses: List[float] = []
  s.trail: List[Dict[str, torch.Tensor]] = []
  for k in range(ctx.traffic["warmup_steps"]):
    _, metrics = next(s.steps)
    ctx.mark(f"step {k + 1}")
    if not keep:
      continue
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


def moved(want: Dict) -> List[str]:
  """The leaves whose reference gradient is at least a thousandth of the
  median leaf's: those whose change is compared."""
  grad_median = float(np.median(list(want["grad"].values())))
  return [n for n, g in want["grad"].items() if g >= 1e-3 * grad_median]


def compare(s, want: Dict):
  """drivers/train.py's check after the reference `want` (with its trail):
  prints the widest leaves and the look at the change, and returns the
  compared numbers beside the cell's limits."""
  got = {"losses": s.losses, "grad": s.grad, "change": s.change}
  for key in ("grad", "change"):
    for row in worst_leaves(got, want, key):
      print(f"widest {key} gap: {row}", file=sys.stderr)
  look(s.trail, want["trail"], s.weights, moved(want),
       [row[0] for row in worst_leaves(got, want, "change")])
  s.trail = want["trail"] = None
  limits = s.ctx.cell["limits"]
  readings = gaps(got, want)
  for k, v in readings.items():
    if k not in limits:
      print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
  return [(k, v, limits[k]) for k, v in readings.items() if k in limits]


def one_ulp(reference: Callable[..., Dict], p0) -> Dict:
  """The rounding's own reach: `reference(p, trail=True)` from the initial
  weights `p0` one ulp up against it from `p0`, with the look at the
  change printed."""
  want = reference(p0, trail=True)
  up = {k: torch.nextafter(v, torch.full_like(v, float("inf")))
        if k in want["grad"] else v for k, v in p0.items()}
  got = reference(up, trail=True)
  look(got["trail"], want["trail"], p0, moved(want),
       [row[0] for row in worst_leaves(got, want, "change")])
  return gaps(got, want)
