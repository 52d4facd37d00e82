"""The training step and the eval forward.

Counterpart of corenet_tpu/train/step.py: the voxel → screen matrix, the
loss per task, the training step on batches that carry their ground-truth
grid (the JAX step's host-GT branch), and the eval forward. On-device
ground truth (the JAX step's voxelization of the batch's triangles) is
not ported yet; a batch without `grid` is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from corenet_tpu_torch.models import losses
from corenet_tpu_torch.models.corenet import CoreNet
from corenet_tpu_torch.train.state import TrainState

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
                    task_type: str, resolution: Tuple[int, int, int]
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
  """Builds the training step, (state, batch) → (state, metrics).

  `model` and `optimizer` are the state's. The batch is a dict of
  channel-last tensors on the model's device, leading dim = batch:
    image        uint8[B, H, W, 3]
    camera       float32[B, 4, 4]
    v2x          float32[B, 4, 4]   view → voxel (a diagonal scale)
    grid         int32 or uint8[B, D, H, W]   ground-truth labels
    grid_offset  float32[B, 3]
  The step runs the model in train mode (BatchRenorm on batch statistics,
  updating its running statistics), the task's loss, the backward pass
  and one Adam update, all in place, and returns the state with
  global_step advanced by B and {"loss": the loss before the update}.
  """
  loss_fn = loss_fn_for_task(task_type)
  resolution = tuple(resolution)

  def step(state: TrainState, batch: Batch):
    if "grid" not in batch:
      raise NotImplementedError(
          "on-device ground truth (voxelizing the batch's triangles) comes "
          "with the on-device GT slice of the port; pass a batch with a "
          "precomputed 'grid' and its 'v2x'")
    grid = batch["grid"]
    batch_size = batch["image"].shape[0]
    if tuple(grid.shape) != (batch_size,) + resolution:
      raise ValueError(f"grid {tuple(grid.shape)} does not match batch "
                       f"{batch_size} at resolution {resolution}")
    v2s = compute_v2s(batch["camera"], batch["v2x"])
    model.train()
    optimizer.zero_grad(set_to_none=True)
    logits = model(batch["image"], v2s, batch["grid_offset"])
    loss = loss_fn(grid, logits)
    loss.backward()
    optimizer.step()
    new_state = dataclasses.replace(
        state, global_step=state.global_step + batch_size)
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
