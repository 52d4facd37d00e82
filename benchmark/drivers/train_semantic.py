"""Semantic training driver: benchmark/drivers/train.py's loop on scenes of
several objects with class labels, for a configuration whose task is
SEMANTIC (m9).

The window, the counts and the compared numbers are the training
driver's (its `window`, `counts` and `gaps`; the counts take the
configuration's classes and every mesh of a scene, whose subdivided
triangles the rasterizer's least time counts; that time is its
operations' at these sizes, ten times its bytes'). What differs: set-up
writes the traffic's multi-object dataset (harness/triplets.py) into the
run's scratch directory; the reference (reference/semantic.py) labels
each voxel with the largest class of the meshes that hold it and trains
under the SEMANTIC loss; and a second fault, 'label_swap', exchanges the
two classes that fill the most voxels of each batch in the reference's
labels.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from benchmark.drivers.train import (  # noqa: F401  (the loop and counts)
    FOLLOWED, State, _batch, _batches, _release, _scene, _spec, _sync,
    counts, gaps, window)
from benchmark.harness import training, triplets, weights
from benchmark.reference import model as ref
from benchmark.reference import precision
from benchmark.reference import semantic

FAULTS = ("half_batch", "label_swap", "one_ulp")


def _dataset(ctx) -> str:
  data_dir = os.path.join(ctx.scratch, "data")
  triplets.write_dataset(data_dir, ctx.traffic, ctx.seed)
  return data_dir


def setup(ctx) -> State:
  s = State()
  s.ctx = ctx
  s.data_dir = _dataset(ctx)
  ctx.mark("dataset")
  training.pipeline(s, s.data_dir, os.path.join(ctx.scratch, "out"),
                    ctx.device)
  ctx.mark("pipeline and weights")
  training.warm(s)
  _sync(ctx.device)
  return s


def _values(data_dir: str) -> Dict[str, int]:
  with open(os.path.join(data_dir, "dataset.json")) as f:
    classes = json.load(f)["classes"]
  return semantic.class_values([(c["id"], c["human_readable"])
                                for c in classes])


def _swap_top_two(labels: torch.Tensor) -> torch.Tensor:
  """`labels` with the two classes that fill the most of its voxels
  exchanged."""
  counts = torch.bincount(labels.flatten().long(), minlength=256)
  counts[0] = 0
  a, b = torch.topk(counts, 2).indices.tolist()
  out = labels.clone()
  out[labels == a] = b
  out[labels == b] = a
  return out


def _reference(ctx, data_dir: str, p0, low=None, keep: int = 0,
               swap: bool = False, trail: bool = False) -> Dict:
  """The reference's three steps on the window's first batches; `keep` > 0
  keeps that many scenes of each batch, `swap` exchanges two classes in
  every batch's labels (faults)."""
  m = ctx.config["model"]
  res = m["resolution"]
  vc = ctx.config["train"]["data"]["voxelization_config"]
  irm = vc["voxelization_image_resolution_multiplier"]
  values = _values(data_dir)
  batches = []
  for batch in _batches(ctx, range(FOLLOWED)):
    items = [_scene(data_dir, i) for i in batch[:keep or None]]
    labels = semantic.labels([x[2] for x in items], values, res, irm,
                             ctx.device)
    if swap:
      labels = _swap_top_two(labels)
    batches.append({
        "image": torch.from_numpy(np.stack([x[0] for x in items])).to(
            ctx.device),
        "camera": torch.from_numpy(np.stack([x[1] for x in items])).to(
            ctx.device),
        "labels": labels})
  dtype = {"bfloat16": torch.bfloat16, "float32": None}[
      ctx.config["train_precision"]]
  train = ctx.config["train"]
  return semantic.steps(p0, batches, (res,) * 3,
                        train["initial_learning_rate"], train["adam_epsilon"],
                        ref.Precision(dtype, low), trail)


def check(s: State):
  _release(s)
  return training.compare(s, _reference(s.ctx, s.data_dir, s.weights,
                                        trail=True))


def control(ctx) -> Dict:
  """The reference one precision down (fp8 operands for bf16) in the
  program's place, against the reference."""
  data_dir = _dataset(ctx)
  p0 = weights.make(_spec(ctx), ctx.seed, ctx.device)
  want = _reference(ctx, data_dir, p0)
  return gaps(_reference(ctx, data_dir, p0, low=precision.fp8), want)


def fault(ctx, name: str) -> Dict:
  """The reference with a planted fault in the program's place, against
  the reference: 'half_batch' leaves half of each batch out; 'label_swap'
  exchanges the two classes that fill the most voxels of each batch;
  'one_ulp' plants none, the reference from initial weights one ulp
  above (the rounding's own reach), with the look at the change."""
  if name not in FAULTS:
    raise ValueError(f"the semantic training driver plants no fault "
                     f"{name!r}")
  data_dir = _dataset(ctx)
  p0 = weights.make(_spec(ctx), ctx.seed, ctx.device)
  if name == "one_ulp":
    return training.one_ulp(
        lambda p, trail: _reference(ctx, data_dir, p, trail=trail), p0)
  want = _reference(ctx, data_dir, p0)
  return gaps(_reference(ctx, data_dir, p0, keep=(
      _batch(ctx) // 2 if name == "half_batch" else 0),
      swap=name == "label_swap"), want)
