"""Evaluation pipeline: dataset → GT voxelize → inference → metrics → CSV.

Counterpart of corenet_tpu/eval/pipeline.py: a pluggable
`inference_fn(image, camera, v2x, grid_offsets, output_resolution) → PMF`
runs over an (optionally per-step reshuffled) eval dataset; the GT grids
are voxelized on the device at the eval resolution (train/gt.py); a
confusion matrix accumulates, `voxel_metrics.csv` and the scalar
summaries are written, and `run_eval` returns the mean IoU.

Batches are padded to the configured batch size, with a validity mask for
the last one. The first `num_qualitative_results` scenes are also rendered
(eval/qualitative.py) into `img_*.png` tiles beside the CSV: only those
scenes' PMFs and grids are copied to the host. One process evaluates the
whole dataset for now.
"""

from __future__ import annotations

import functools
import logging
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from corenet_tpu_torch.config import config as cfg
from corenet_tpu_torch.data.batching import VOXELIZE_WINDOW_PIXELS
from corenet_tpu_torch.data.loader import DataLoader
from corenet_tpu_torch.data.manager import DatasetManager
from corenet_tpu_torch.eval.qualitative import QualitativeResults
from corenet_tpu_torch.eval.results import QuantitativeResults
from corenet_tpu_torch.train import gt as gt_lib
from corenet_tpu_torch.utils import fs
from corenet_tpu_torch.utils.device import checked_device

log = logging.getLogger(__name__)

# InferenceFn: (image u8[B,H,W,3], camera f32[B,4,4], v2x f32[B,4,4],
#   grid_offsets f32[B,3], output_resolution (d,h,w)) → pmf [B,D,H,W,C].
# The arguments are tensors on the pipeline's device; the PMF may be a
# tensor or an array, and is moved there.
InferenceFn = Callable

GT_KEYS = ("triangles", "tri_mesh_slot", "tri_valid", "mesh_labels",
           "grid_offset")


def shard_range(n: int, num_shards: int, shard: int) -> Tuple[int, int]:
  """Contiguous per-process shard (no padding: eval must not duplicate)."""
  per = (n + num_shards - 1) // num_shards
  lo = min(shard * per, n)
  return lo, min(lo + per, n)


class EvalPipeline:

  def __init__(self,
               eval_config: cfg.EvalConfig,
               output_dir: str,
               inference_fn: InferenceFn,
               write_results: bool = True,
               write_qualitative: bool = True,
               summary_writer=None,
               device="cuda"):
    self.device = checked_device(device)
    self.config = eval_config
    self.output_dir = output_dir
    self.inference_fn = inference_fn
    self.write_results = write_results
    self.write_qualitative = write_qualitative
    self.summary_writer = summary_writer
    self.dataset_manager = DatasetManager(eval_config.data)
    self.classes = self.dataset_manager.classes
    self._cached_gt_fn = self._gt_fn(eval_config.data.voxelization_config)

  def _gt_fn(self, vc: cfg.VoxelizationConfig):
    return functools.partial(
        gt_lib.voxelize_batch,
        resolution=vc.resolution.as_tuple(),
        sub_grid_sampling=vc.sub_grid_sampling,
        image_resolution_multiplier=vc.voxelization_image_resolution_multiplier,
        conservative_rasterization=vc.conservative_rasterization,
        projection_depth_multiplier=vc.voxelization_projection_depth_multiplier,
        max_bbox_pixels=VOXELIZE_WINDOW_PIXELS,
        num_label_values=len(self.classes))

  def run_eval(self, global_step: int,
               max_scenes: Optional[int] = None) -> Optional[float]:
    vc = self.config.data.voxelization_config
    task_type = vc.task_type.value
    resolution = vc.resolution.as_tuple()
    dataset = self.dataset_manager.create_dataset(local_seed=global_step)
    if max_scenes is not None:
      dataset = dataset[:max_scenes]
    lo, hi = shard_range(len(dataset), 1, 0)
    shard = dataset[lo:hi]
    log.info("Eval '%s' @ step %d: %d scenes (shard %d-%d of %d)",
             self.config.name, global_step, len(shard), lo, hi, len(dataset))

    quantitative = QuantitativeResults(self.classes, task_type)
    out_dir = fs.join(self.output_dir, self.config.name, str(global_step))
    qualitative = None
    if self.write_qualitative and self.config.num_qualitative_results > 0:
      qualitative = QualitativeResults(
          out_dir, self.config.num_qualitative_results,
          self.config.num_qualitative_results_in_tensor_board,
          self.summary_writer, device=self.device)
    # Subdivide so that every triangle fits the voxelizer's sampling window.
    irm = vc.voxelization_image_resolution_multiplier
    max_edge_view = (VOXELIZE_WINDOW_PIXELS - 4) / irm / max(resolution)

    dl_cfg = self.config.data.data_loader
    loader = DataLoader(
        shard, batch_size=dl_cfg.batch_size,
        num_workers=dl_cfg.num_data_workers,
        prefetch_factor=dl_cfg.prefetch_factor,
        max_edge_view=max_edge_view,
        worker_processes=None if dl_cfg.worker_processes else False)
    self._run_batches(loader, self._cached_gt_fn, task_type, resolution,
                      quantitative, qualitative)

    if qualitative is not None:
      qualitative.write_summaries(global_step)
    quantitative.compute_metrics()
    if self.write_results:
      quantitative.write_csv(fs.join(out_dir, "voxel_metrics.csv"))
      log.info("Eval '%s' mIoU=%.4f", self.config.name,
               quantitative.get_mean_iou())
    if self.summary_writer is not None:
      for name, value in quantitative.scalar_summaries().items():
        self.summary_writer.add_scalar(name, value, global_step)
      self.summary_writer.flush()
    return quantitative.get_mean_iou()

  def _run_batches(self, loader, gt_fn, task_type, resolution, quantitative,
                   qualitative=None):
    for hb, valid in loader:
      inputs = {k: torch.from_numpy(v).to(self.device)
                for k, v in hb.step_inputs(task_type).items()}
      grid, v2x = gt_fn(*(inputs[k] for k in GT_KEYS))
      pmf = self.inference_fn(inputs["image"], inputs["camera"], v2x,
                              inputs["grid_offset"], resolution)
      pmf = torch.as_tensor(pmf, device=self.device)
      quantitative.add_batch(pmf, grid, hb.mesh_labels[:, 0], valid)
      if qualitative is not None and qualitative.want_more():
        self._add_qualitative(qualitative, hb, valid, pmf, grid, resolution)

  @staticmethod
  def _add_qualitative(qualitative, hb, valid, pmf, grid, resolution):
    m = float(max(resolution))
    for i in range(len(valid)):
      if not valid[i] or not qualitative.want_more():
        continue
      # Voxel centres: grid → view is inv(scale(m) with the offset − 0.5).
      w2x = np.eye(4, dtype=np.float32)
      w2x[:3, :3] *= m
      w2x[:3, 3] = hb.grid_offset[i] - 0.5
      meshes = [hb.triangles[i][hb.tri_valid[i] & (hb.tri_mesh_slot[i] == j)]
                for j in range(int(hb.mesh_valid[i].sum()))]
      qualitative.add_scene(
          hb.scene_ids[i], hb.image[i], pmf[i].cpu().numpy(),
          grid[i].cpu().numpy(), meshes, list(hb.mesh_labels[i]),
          np.linalg.inv(w2x))
