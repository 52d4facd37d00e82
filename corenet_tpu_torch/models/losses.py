"""Training losses on voxel-grid logits, channel-last.

Counterpart of corenet_tpu/models/losses.py: soft-IoU on softmax
probabilities with (C−1):1 foreground weighting (iou_agnostic),
foreground-collapsed soft-IoU with GT overlap clamping (iou_fgbg), mean
softmax cross-entropy (xent), and the (1 + iou)(1 + xent) products used
for SEMANTIC training.

Shapes: gt_volume int or uint8 [B, D, H, W]; logits float32
[B, D, H, W, C]; weights (optional) float32 [B, D, H, W]. The phase-loss
step passes phase-major labels [B, D/2, H/2, (W/2)·8] with its logits
viewed as [B, D/2, H/2, (W/2)·8, C]: the losses do not depend on voxel
order. With two
classes and no weights, iou_fgbg reduces through ops/fgbg_loss.py (a CUDA
kernel on the card); everything else is plain tensor code.

Each loss is a function of batch means (the IoU's over scenes, the
cross-entropy's over voxels). Under a process group (parallel/mesh.py)
those means are taken over the global batch, the mean of the ranks'
means of equal shards: every rank returns the loss of the global batch,
and the products of the SEMANTIC losses multiply global means, as the
JAX package's losses do over its sharded batch.

Under the 'space' axis (parallel/mesh.py) the labels and logits are this
rank's depth slab of each scene. The cross-entropy's mean over voxels
needs nothing more (every rank holds an equal share), but the IoU is a
ratio per scene: each scene's intersection and union are summed over the
space group (`mesh.space_sum`, as the JAX package's `fgbg_sums` sums over
'space') before the division, on every route: the FG_BG sums of
ops/fgbg_loss.py, which reduce the slab, and the plain ones.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from corenet_tpu_torch.ops import fgbg_loss
from corenet_tpu_torch.parallel import mesh


def _check(gt_volume, logits, weights):
  if logits.dim() != 5:
    raise ValueError(f"logits must be [B, D, H, W, C], got "
                     f"{tuple(logits.shape)}")
  if gt_volume.shape != logits.shape[:-1]:
    raise ValueError(f"gt_volume {tuple(gt_volume.shape)} does not match "
                     f"logits {tuple(logits.shape)}")
  if weights is not None and weights.shape != logits.shape[:-1]:
    raise ValueError(f"weights {tuple(weights.shape)} do not match logits "
                     f"{tuple(logits.shape)}")


def _iou_loss(intersection: torch.Tensor, union: torch.Tensor
              ) -> torch.Tensor:
  if mesh.space_count() > 1:
    intersection, union = mesh.space_sum(
        torch.stack([intersection, union])).unbind()
  iou = intersection / torch.where(union == 0, 1.0, union)
  return 1.0 - mesh.mean_over_ranks(iou.mean())


def iou_agnostic(gt_volume: torch.Tensor, logits: torch.Tensor,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Class-agnostic soft-IoU loss."""
  _check(gt_volume, logits, weights)
  c = logits.shape[-1]
  gt = F.one_hot(gt_volume.long(), c).float()[..., 1:]
  pred = torch.softmax(logits, dim=-1)[..., 1:]
  final_weights = torch.where(gt == 0, 1.0, float(c - 1))
  if weights is not None:
    final_weights = final_weights * weights[..., None]
  intersection = (torch.minimum(gt, pred) * final_weights).sum((1, 2, 3, 4))
  union = (torch.maximum(gt, pred) * final_weights).sum((1, 2, 3, 4))
  return _iou_loss(intersection, union)


def iou_fgbg(gt_volume: torch.Tensor, logits: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Foreground/background soft-IoU loss."""
  _check(gt_volume, logits, weights)
  c = logits.shape[-1]
  if fgbg_loss.use_fgbg_kernel(logits, weights):
    # softmax₁ of two logits is the sigmoid of their difference, and the
    # one-hot/collapse/clamp pipeline reduces to an equality test. The
    # difference is taken in f32.
    diff = logits[..., 1].float() - logits[..., 0].float()
    return _iou_loss(*fgbg_loss.fgbg_sums(diff, gt_volume.contiguous()))
  if c == 2:
    pred = torch.sigmoid(logits[..., 1] - logits[..., 0])
    gt = (gt_volume == 1).float()
  else:
    gt = F.one_hot(gt_volume.long(), c).float()[..., 1:].sum(-1)
    gt = torch.clamp(gt, max=1.0)
    pred = torch.softmax(logits, dim=-1)[..., 1:].sum(-1)
  intersection = torch.minimum(gt, pred)
  union = torch.maximum(gt, pred)
  if weights is not None:
    intersection = intersection * weights
    union = union * weights
  b = logits.shape[0]
  return _iou_loss(intersection.reshape(b, -1).sum(1),
                   union.reshape(b, -1).sum(1))


def xent(gt_volume: torch.Tensor, logits: torch.Tensor,
         weights: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Mean softmax cross-entropy."""
  _check(gt_volume, logits, weights)
  log_probs = torch.log_softmax(logits, dim=-1)
  nll = -torch.take_along_dim(log_probs, gt_volume.long()[..., None],
                              dim=-1)[..., 0]
  if weights is not None:
    nll = nll * weights
  return mesh.mean_over_ranks(nll.mean())


def xent_times_iou_agnostic(gt_volume, logits, weights=None):
  """(1 + iou_agnostic)(1 + xent)."""
  return ((1.0 + iou_agnostic(gt_volume, logits, weights)) *
          (1.0 + xent(gt_volume, logits, weights)))


def xent_times_iou_fgbg(gt_volume, logits, weights=None):
  """(1 + iou_fgbg)(1 + xent)."""
  return ((1.0 + iou_fgbg(gt_volume, logits, weights)) *
          (1.0 + xent(gt_volume, logits, weights)))
