"""Plain reference of multi-object semantic training: labeled ground truth,
the SEMANTIC loss and the first training steps under it.

- Labels: each voxel holds the largest class of the scene's meshes that
  occupy or enclose it, void 0. A mesh's class is its rank in the
  dataset's classes sorted by name, from 1 (the mapping of the program's
  data/dataset.py). Each mesh is subdivided and voxelized alone
  (reference/gt.py's `subdivide`, `surface_voxels`, `fill_enclosed`).
- Loss: (1 + the class-agnostic soft-IoU loss)(1 + the mean softmax
  cross-entropy), written from its definition. The IoU takes the one-hot
  of classes 1 to C − 1 against the softmax of those channels, weighs
  each term C − 1 where the one-hot is 1 and 1 elsewhere, sums the
  minimum (intersection) and maximum (union) per scene, and averages
  1 − intersection / union over the batch. The cross-entropy is the
  mean negative log-softmax of each voxel's class.
- Steps: reference/train.py's steps with this loss, from
  reference/model.py's `forward`, `trainable` and `Adam`, TF32 off as in
  reference/precision.py's baseline.

Where it departs from the JAX package (corenet_tpu/models/losses.py,
train/gt.py): the per-scene IoU sums are taken in float64 (the package
sums in float32); the logits come from the fine decoder in voxel order
(the program's packed decoder runs space-to-depth); the labels are made
densely, mesh by mesh, without bit packing, blocks or kernels.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import gt as ref_gt
from benchmark.reference import model as ref


def class_values(classes: Sequence[Tuple[str, str]]) -> Dict[str, int]:
  """Class id → label: its rank among the (id, name) classes sorted by
  name, from 1."""
  ranked = sorted(classes, key=lambda c: c[1])
  return {cid: k + 1 for k, (cid, _) in enumerate(ranked)}


@torch.no_grad()
def labels(scene_meshes: Sequence[List[Tuple[str, np.ndarray]]],
           values: Dict[str, int], m: int, irm: int,
           device) -> torch.Tensor:
  """uint8 [B, m, m, m] (z, y, x): the largest label among the meshes
  that occupy or enclose each voxel, void 0; each mesh subdivided for
  the sampling window, grid offsets 0.5."""
  edge = ref_gt.max_edge_view(irm, m)
  offset = torch.full((3,), 0.5, device=device)
  out = []
  for meshes in scene_meshes:
    grid = torch.zeros((m, m, m), dtype=torch.uint8, device=device)
    for cid, tris in meshes:
      t = torch.from_numpy(ref_gt.subdivide(tris, edge)).to(device)
      inside = ref_gt.fill_enclosed(ref_gt.surface_voxels(t, m, irm, offset))
      grid = torch.where(inside, torch.clamp(grid, min=values[cid]), grid)
    out.append(grid)
  return torch.stack(out)


def loss(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
  """(1 + iou_agnostic)(1 + xent) of float32 logits [B, D, H, W, C]
  against labels [B, D, H, W]."""
  b, c = logits.shape[0], logits.shape[-1]
  gt = torch.nn.functional.one_hot(labels.long(), c)[..., 1:].float()
  gt = gt.reshape(b, -1, c - 1)
  probs = torch.softmax(logits, dim=-1)
  pred = probs[..., 1:].reshape(b, -1, c - 1)
  weight = torch.where(gt == 1, float(c - 1), 1.0)
  inter = (torch.minimum(gt, pred) * weight).sum((1, 2), dtype=torch.float64)
  union = (torch.maximum(gt, pred) * weight).sum((1, 2), dtype=torch.float64)
  iou = inter / torch.where(union == 0, 1.0, union)
  iou_loss = (1.0 - iou.mean()).float()
  log_probs = torch.log_softmax(logits, dim=-1)
  nll = -log_probs.gather(-1, labels.long()[..., None])
  return (1.0 + iou_loss) * (1.0 + nll.mean())


@contextlib.contextmanager
def _tf32_off():
  saved = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    yield
  finally:
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def steps(p0: Dict[str, torch.Tensor], batches: Sequence[dict], resolution,
          lr: float, eps: float, prec: ref.Precision,
          trail: bool = False) -> dict:
  """reference/train.py's `steps` under the SEMANTIC loss: one train-mode
  step per batch (image uint8 [B, H, W, 3], camera [B, 4, 4], labels
  [B, D, H, W]); the losses, each leaf's gradient norm in the first
  step, each leaf's change after the last and, with `trail`, the leaves
  after each step, on the host."""
  p = {k: v.clone() for k, v in p0.items()}
  leaves = ref.trainable(p)
  adam = ref.Adam(lr, eps)
  losses: List[float] = []
  first_grad = {}
  after = []
  m = resolution[0]
  with _tf32_off():
    for i, batch in enumerate(batches):
      b = batch["image"].shape[0]
      dev = batch["image"].device
      v2x = torch.diag(torch.tensor([float(m)] * 3 + [1.0],
                                    device=dev)).expand(b, 4, 4)
      v2s = ref.compute_v2s(batch["camera"], v2x)
      offset = torch.full((b, 3), 0.5, device=dev)
      for k in leaves:
        p[k] = p[k].detach().requires_grad_(True)
      logits = ref.forward(p, batch["image"], v2s, offset, resolution, True,
                           prec)
      value = loss(batch["labels"], logits)
      grads = torch.autograd.grad(value, [p[k] for k in leaves])
      del logits
      losses.append(value.item())
      if i == 0:
        first_grad = dict(zip(leaves, torch.stack(
            [g.norm() for g in grads]).tolist()))
      for k in leaves:
        p[k] = p[k].detach()
      adam.step(p, dict(zip(leaves, grads)))
      del grads
      if trail:
        after.append({k: p[k].to("cpu", torch.float32, copy=True)
                      for k in leaves})
  change = dict(zip(leaves, torch.stack(
      [(p[k] - p0[k]).norm() for k in leaves]).tolist()))
  return {"losses": losses, "grad": first_grad, "change": change,
          "trail": after}
