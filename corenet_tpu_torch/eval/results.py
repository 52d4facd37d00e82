"""Evaluation results: confusion accumulation → metrics table → CSV and
scalar summaries.

Counterpart of corenet_tpu/eval/results.py, without pandas: the
`voxel_metrics.csv` table has rows (iou, precision, recall) and columns
(class names..., `__global__`), where `__global__` holds the
class-agnostic FG/BG metrics; mean IoU averages the per-class IoUs
excluding `__void__` and `__global__`, skipping NaN (absent) classes. The
CSV text equals what pandas' `DataFrame.to_csv` writes for the same
numbers. Label extraction for FG_BG multiplies both prediction and GT by
the scene's object label.

The per-batch confusion matrix is counted on the device and accumulated
in int64 on the host; under a process group the ranks' matrices are
summed before the metrics.
"""

from __future__ import annotations

import csv
import dataclasses
import io
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from corenet_tpu_torch.data.dataset import VOID_LABEL_NAME
from corenet_tpu_torch.eval import metrics as vm
from corenet_tpu_torch.parallel import mesh
from corenet_tpu_torch.utils import fs

GLOBAL_CLASS_NAME = "__global__"
METRIC_NAMES = ("iou", "precision", "recall")


def extract_labels(pmf: torch.Tensor, gt_grid: torch.Tensor,
                   scene_fg_labels: torch.Tensor, task_type: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
  """argmax labels from a class PMF (the first maximum on ties); for FG_BG
  both prediction and GT are multiplied by the scene's (single) object
  label.

  Args:
    pmf: float32[B, D, H, W, C].
    gt_grid: int32 or uint8[B, D, H, W].
    scene_fg_labels: int32[B], the first mesh's label per scene (only
      used for FG_BG; single-object scenes).

  Returns:
    (predicted, gt), both int32[B, D, H, W].
  """
  pred = torch.argmax(pmf, dim=-1).to(torch.int32)
  # Cast before multiplying: a uint8 grid times a label above 255 must
  # not wrap.
  gt = gt_grid.to(torch.int32)
  if task_type == "FG_BG":
    lbl = scene_fg_labels.to(torch.int32)[:, None, None, None]
    pred = pred * lbl
    gt = gt * lbl
  return pred, gt


@dataclasses.dataclass
class VoxelMetricsTable:
  """float64 metrics with named rows (iou, precision, recall) and columns
  (classes..., __global__)."""
  columns: Tuple[str, ...]
  values: np.ndarray  # float64[3, len(columns)]

  def row(self, metric: str) -> np.ndarray:
    return self.values[METRIC_NAMES.index(metric)]

  def column(self, name: str) -> Dict[str, float]:
    col = self.values[:, self.columns.index(name)]
    return {m: float(v) for m, v in zip(METRIC_NAMES, col)}

  def class_means(self) -> Dict[str, float]:
    """Each metric's mean over the classes (not __void__, not
    __global__) that have it; NaN where none has."""
    out = {}
    for metric, row in zip(METRIC_NAMES, self.values[:, 1:-1]):
      present = row[~np.isnan(row)]
      out[metric] = float(present.mean()) if present.size else math.nan
    return out

  def to_csv(self) -> str:
    """The text pandas writes for this table: a header with an empty
    first field, one line per metric, NaN as an empty field, floats in
    their shortest form that reads back exactly."""
    buf = io.StringIO()
    writer = csv.writer(buf, lineterminator="\n")
    writer.writerow(("",) + tuple(self.columns))
    for metric, row in zip(METRIC_NAMES, self.values):
      text = row.astype(str).astype(object)
      text[np.isnan(row)] = ""
      writer.writerow([metric] + list(text))
    return buf.getvalue()


def compute_voxel_metrics_table(confusion_matrix: np.ndarray,
                                classes: Sequence[str]) -> VoxelMetricsTable:
  """Rows (iou, precision, recall) × columns (classes..., __global__)."""
  m = vm.compute_voxel_metrics(vm.compute_tfpn(confusion_matrix))
  m_fg = vm.compute_voxel_metrics(vm.compute_tfpn_fg(confusion_matrix))
  values = np.stack([
      np.append(per_class, fg) for per_class, fg in (
          (m.iou, m_fg.iou), (m.precision, m_fg.precision),
          (m.recall, m_fg.recall))]).astype(np.float64)
  return VoxelMetricsTable(tuple(classes) + (GLOBAL_CLASS_NAME,), values)


class QuantitativeResults:
  """Accumulates a confusion matrix over eval batches."""

  def __init__(self, classes: Sequence[str], task_type: str):
    self.classes = list(classes)
    self.task_type = task_type
    self.confusion = np.zeros([len(classes)] * 2, np.int64)
    self.voxel_metrics: Optional[VoxelMetricsTable] = None

  def add_batch(self, pmf: torch.Tensor, gt_grid: torch.Tensor,
                scene_fg_labels, valid: Optional[np.ndarray] = None):
    """pmf and gt_grid on one device; valid: optional bool[B] mask, False
    for the padded entries of a batch."""
    labels = torch.as_tensor(np.asarray(scene_fg_labels),
                             dtype=torch.int32).to(pmf.device)
    pred, gt = extract_labels(pmf, gt_grid, labels, self.task_type)
    if valid is not None and not np.asarray(valid).all():
      idx = torch.from_numpy(np.nonzero(np.asarray(valid))[0]).to(pmf.device)
      pred = pred.index_select(0, idx)
      gt = gt.index_select(0, idx)
    cm = vm.confusion_matrix(pred, gt, len(self.classes))
    self.confusion += cm.cpu().numpy()

  def reduce_across_hosts(self):
    """Sums the confusion matrices of all processes (an int64 all-reduce
    over the host group of parallel/mesh.py; nothing to do without a
    group). Every rank calls it, each with the confusion of its shard."""
    if mesh.is_initialized():
      self.confusion = mesh.host_all_reduce_sum(
          torch.from_numpy(self.confusion)).numpy()

  def compute_metrics(self) -> VoxelMetricsTable:
    self.reduce_across_hosts()
    self.voxel_metrics = compute_voxel_metrics_table(self.confusion,
                                                     self.classes)
    return self.voxel_metrics

  def _table(self) -> VoxelMetricsTable:
    if self.voxel_metrics is None:
      raise RuntimeError("call compute_metrics() first")
    if (self.voxel_metrics.columns[0] != VOID_LABEL_NAME
        or self.voxel_metrics.columns[-1] != GLOBAL_CLASS_NAME):
      raise ValueError("the classes must start with " + VOID_LABEL_NAME)
    return self.voxel_metrics

  def get_mean_iou(self) -> float:
    return self._table().class_means()["iou"]

  def write_csv(self, path: str):
    fs.makedirs(fs.dirname(path))
    fs.write_text(path, self._table().to_csv())

  def scalar_summaries(self) -> Dict[str, float]:
    """General/* and per-class scalars with the reference's tensorboard
    names."""
    table = self._table()
    means = table.class_means()
    fgbg = table.column(GLOBAL_CLASS_NAME)
    out = {
        "General/mIoU": means["iou"],
        "General/mPrecision": means["precision"],
        "General/mRecall": means["recall"],
        "General/fgbgIoU": fgbg["iou"],
        "General/fgbgPrecision": fgbg["precision"],
        "General/fgbgRecall": fgbg["recall"],
    }
    for cls in table.columns[:-1]:
      col = table.column(cls)
      out[f"IoU/{cls}"] = col["iou"]
      out[f"Precision/{cls}"] = col["precision"]
      out[f"Recall/{cls}"] = col["recall"]
    return out
