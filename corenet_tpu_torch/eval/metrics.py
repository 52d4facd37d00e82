"""Voxel evaluation metrics: confusion matrices, TFPN, IoU/precision/recall.

Counterpart of corenet_tpu/eval/metrics.py: confusion[gt, pred] counts;
per-class TP/TN/FP/FN from the matrix; binary FG/BG TFPN by collapsing the
classes ≥ 1; metrics in float64 with NaN for classes absent from both GT
and prediction (NaN where tp == 0).

Division of labour: the per-batch confusion matrix is counted on the
device (one bincount over gt·C + pred); accumulation across batches and
the float64 metric math (numpy, a near-copy of the JAX package's) happen
on the host, because full-dataset counts (~5e11 voxels) exceed both int32
and float32's integer range.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def confusion_matrix(predicted: torch.Tensor, gt: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
  """Per-batch confusion matrix int64[num_classes, num_classes] on the
  inputs' device; rows = GT, columns = predicted. A label outside
  [0, num_classes), in either input, raises: such a pair is counted in one
  extra bin past the matrix, so the `bincount`'s length shows it without a
  read of its own from the device."""
  n = num_classes * num_classes
  gt, predicted = gt.long(), predicted.long()
  inside = ((gt >= 0) & (gt < num_classes) &
            (predicted >= 0) & (predicted < num_classes))
  index = torch.where(inside, gt * num_classes + predicted, n).reshape(-1)
  counts = torch.bincount(index, minlength=n)
  if counts.numel() != n:
    raise ValueError(f"a label lies outside the {num_classes} classes")
  return counts.reshape(num_classes, num_classes)


@dataclasses.dataclass
class TfpnValues:
  """True/false positives/negatives, float64[num_classes] (or scalars)."""
  tp: np.ndarray
  tn: np.ndarray
  fp: np.ndarray
  fn: np.ndarray


def compute_tfpn(matrix: np.ndarray) -> TfpnValues:
  """Per-class TFPN from a confusion matrix."""
  matrix = np.asarray(matrix, np.float64)
  num_classes = matrix.shape[0]
  assert matrix.shape == (num_classes, num_classes)
  tp = np.diagonal(matrix).copy()
  fp = matrix.sum(axis=0) - tp   # column sums: predicted-as-class
  fn = matrix.sum(axis=1) - tp   # row sums: gt-is-class
  tn = matrix.sum() - tp - fp - fn
  return TfpnValues(tp, tn, fp, fn)


def compute_tfpn_fg(matrix: np.ndarray) -> TfpnValues:
  """2-class foreground/background TFPN."""
  matrix = np.asarray(matrix, np.float64)
  tp = matrix[1:, 1:].sum()
  tn = matrix[0, 0]
  fp = matrix[0, 1:].sum()
  fn = matrix[1:, 0].sum()
  return TfpnValues(*[np.asarray(v) for v in (tp, tn, fp, fn)])


@dataclasses.dataclass
class VoxelMetrics:
  iou: np.ndarray
  precision: np.ndarray
  recall: np.ndarray


def _nan_tp_div(tp: np.ndarray, y: np.ndarray) -> np.ndarray:
  """NaN where the class has no true positives."""
  with np.errstate(divide="ignore", invalid="ignore"):
    return np.where(tp == 0, math.nan, tp / np.where(y == 0, 1, y))


def compute_voxel_metrics(tfpn: TfpnValues) -> VoxelMetrics:
  tp, fp, fn = (np.asarray(v, np.float64) for v in (tfpn.tp, tfpn.fp,
                                                    tfpn.fn))
  return VoxelMetrics(
      iou=_nan_tp_div(tp, tp + fp + fn),
      precision=_nan_tp_div(tp, tp + fp),
      recall=_nan_tp_div(tp, tp + fn))
