"""The training step and the eval forward.

Counterpart of corenet_tpu/train/step.py: the voxel → screen matrix, the
loss per task, the training step, and the eval forward. The step takes
its ground truth from the batch (`grid`, the JAX step's host-GT branch)
or voxelizes the batch's triangles on its device (train/gt.py), and with
a `phase_output` model trains on phase-major logits and labels (the
phase loss): factor 8 for the fine decoder, 64 for the packed one.

Under a process group (parallel/mesh.py) each rank steps on its shard of
the global batch, as the JAX step does on a 'data' mesh: BatchRenorm's
statistics and the loss are the global batch's, the gradients are
averaged over ranks after the backward (one all-reduce), and every rank
takes the same Adam step and counts the global batch.

Under the 'space' axis (parallel/mesh.py::create_mesh) the space ranks of
a data group step on the same batch with a depth-sharded model
(`CoreNet(depth_shard=...)`): each trains on its slab of the logits and
of the labels, which the blocked GT routes share over the space group
where the batch divides by the space count (each rank voxelizes its
share of the scenes, then an all-to-all: train/gt.py::space_shared), and
which are otherwise made whole and cut (train/gt.py::depth_slab). The
loss sums each scene's IoU terms over the group (models/losses.py). The
gradient all-reduce stays over the whole world, and the global batch is
B · data_count().
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from corenet_tpu_torch.models import losses
from corenet_tpu_torch.models.corenet import CoreNet
from corenet_tpu_torch.ops.phased_gt import phase_permute, phased_gt
from corenet_tpu_torch.parallel import mesh
from corenet_tpu_torch.train import gt
from corenet_tpu_torch.train.state import TrainState
from corenet_tpu_torch.utils import tracing
from corenet_tpu_torch.voxel.parity import parity_voxelize_batch

Batch = Dict[str, torch.Tensor]


def loss_fn_for_task(task_type: str) -> Callable[..., torch.Tensor]:
  if task_type == "FG_BG":
    return losses.iou_fgbg
  if task_type == "SEMANTIC":
    return losses.xent_times_iou_agnostic
  raise ValueError(f"Unknown task type {task_type!r}")


def compute_v2s(camera_transform: torch.Tensor,
                v2x_transform: torch.Tensor) -> torch.Tensor:
  """voxel → screen matrix: camera @ v2x⁻¹. The v2x used everywhere is a
  pure diagonal scale, so it is inverted analytically; multiplying by a
  diagonal is a column scaling, which is exact whatever the matmul
  precision settings."""
  inv_diag = torch.cat(
      [1.0 / torch.diagonal(v2x_transform[..., :3, :3], dim1=-2, dim2=-1),
       torch.ones_like(v2x_transform[..., :1, 0])], dim=-1)
  return camera_transform * inv_diag[..., None, :]


def make_train_step(model: CoreNet, optimizer: torch.optim.Optimizer,
                    task_type: str, resolution: Tuple[int, int, int],
                    voxelization_kwargs: Optional[Dict[str, Any]] = None
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
  """Builds the training step, (state, batch) → (state, metrics).

  `model` and `optimizer` are the state's. The batch is a dict of
  channel-last tensors on the model's device, leading dim = batch:
    image          uint8[B, H, W, 3]
    camera         float32[B, 4, 4]
    triangles      float32[B, T, 3, 3]   view space, subdivided
    tri_mesh_slot  int32[B, T]
    tri_valid      bool[B, T]
    mesh_labels    int32[B, M]           voxel value per mesh slot
    grid_offset    float32[B, 3]
  or, in place of the triangles, a precomputed `grid` (int32 or uint8
  [B, D, H, W]) with its `v2x` (float32[B, 4, 4], a diagonal scale).
  voxelization_kwargs go to train/gt.py (resolution defaults to the
  step's); `algorithm` picks "raster" (rasterize + flood fill, the
  default) or "parity" (exact centre sampling by ray crossings,
  voxel/parity.py: closed meshes only).

  The ground truth, in the JAX step's order: the batch's grid; else the
  parity grid; else, for FG_BG with a `phase_output` model and a
  configuration the blocked rasterizer serves, bit-packed grids straight
  to phase-major labels (ops/phased_gt.py); else the labeled grid. The step
  runs the model in train mode (BatchRenorm on batch statistics, updating
  its running statistics), the task's loss, the backward pass and one
  Adam update, all in place, each in its span (train.gt, train.forward,
  train.loss, train.backward, train.optimizer; utils/tracing.py), and
  returns the state with global_step advanced by B and {"loss": the loss
  before the update}.

  Under a process group the batch is this rank's shard, of the same B on
  every rank (checked each step); statistics and loss are the global
  batch's, the update is the global gradient's, and global_step advances
  by the global batch, B · data_count() (the world size without a
  'space' axis). With a depth-sharded model the batch is the data
  group's, and the labels are cut to the model's slab: the blocked GT
  routes share their voxelization over the space group when B divides by
  the space count (train/gt.py::labels_slab, which counts each route
  taken as `gt.route.*` in utils/tracing.py).
  """
  loss_fn = loss_fn_for_task(task_type)
  resolution = tuple(resolution)
  vox_kwargs = dict(voxelization_kwargs or {})
  vox_kwargs.setdefault("resolution", resolution)
  gt_algorithm = vox_kwargs.pop("algorithm", "raster")
  if gt_algorithm not in ("raster", "parity"):
    raise ValueError(f"unknown GT algorithm {gt_algorithm!r}")
  phase_loss = model.phase_output
  # Phase factor per axis: the packed decoder's deep-phase output is
  # factor 4³ = 64, the fine decoder's phased last stage 2³ = 8.
  phase_s = 4 if model.packed_decoder else 2
  depth_shard = model.depth_shard

  def phased_labels(*scenes):
    packed, v2x = gt.voxelize_batch_packed_fgbg(*scenes, **vox_kwargs)
    return phased_gt(packed, phase_s), v2x

  def ground_truth(batch: Batch):
    """(labels, whether they are phase-major, v2x), the labels cut to the
    model's depth slab by one call (train/gt.py::labels_slab)."""
    phased = False
    if "grid" in batch:
      grid = batch["grid"]
      expected = (batch["image"].shape[0],) + resolution
      if tuple(grid.shape) != expected:
        raise ValueError(f"grid {tuple(grid.shape)} does not match batch "
                         f"{expected[0]} at resolution {resolution}")
      produce, args, shareable = lambda: (grid, batch["v2x"]), (), False
    else:
      args = (batch["triangles"], batch["tri_mesh_slot"],
              batch["tri_valid"], batch["mesh_labels"], batch["grid_offset"])
      if gt_algorithm == "parity":
        produce = functools.partial(
            parity_voxelize_batch,
            num_mesh_slots=batch["mesh_labels"].shape[1],
            resolution=vox_kwargs["resolution"])
        shareable = False
      elif (phase_loss and task_type == "FG_BG"
            and gt.packed_fgbg_eligible(**vox_kwargs)):
        produce, shareable, phased = phased_labels, True, True
      else:
        produce = functools.partial(gt.voxelize_batch, **vox_kwargs)
        shareable = gt.blocked_grid_eligible(**vox_kwargs)
    labels, v2x = gt.labels_slab(produce, args, depth_shard, shareable)
    return labels, phased, v2x

  def step(state: TrainState, batch: Batch):
    with tracing.span("train.gt"):
      labels, phased, v2x = ground_truth(batch)
    with tracing.span("train.forward"):
      batch_size = batch["image"].shape[0]
      mesh.assert_equal_across_ranks(batch_size, "the batch size")
      v2s = compute_v2s(batch["camera"], v2x)
      model.train()
      optimizer.zero_grad(set_to_none=True)
      logits = model(batch["image"], v2s, batch["grid_offset"])
    with tracing.span("train.loss"):
      if phase_loss:
        # The loss does not depend on voxel order: phase-major logits are
        # paired with labels in the same order.
        b, dq, hq = logits.shape[:3]
        nc = model.config.decoder.num_output_channels
        factor = logits.shape[-1] // nc
        if factor != phase_s ** 3:
          raise ValueError(f"phase-major logits of factor {factor}, "
                           f"expected {phase_s ** 3}")
        if not phased:
          labels = phase_permute(labels.to(torch.uint8), phase_s)
        loss = loss_fn(labels, logits.reshape(b, dq, hq, -1, nc))
      else:
        loss = loss_fn(labels, logits)
    with tracing.span("train.backward"):
      loss.backward()
      mesh.all_reduce_gradients(model.parameters())
    with tracing.span("train.optimizer"):
      optimizer.step()
    new_state = dataclasses.replace(
        state,
        global_step=state.global_step + batch_size * mesh.data_count())
    return new_state, {"loss": loss.detach()}

  return step


def make_eval_forward(model: CoreNet) -> Callable[..., torch.Tensor]:
  """Inference: (image, camera, v2x, grid_offset) → class PMF
  [B, D, H, W, C], the softmax of the logits over channels. The model
  must be in eval mode on the device of the inputs."""

  @torch.inference_mode()
  def forward(image, camera, v2x, grid_offset):
    logits = model(image, compute_v2s(camera, v2x), grid_offset)
    return torch.softmax(logits, dim=-1)

  return forward
