"""Inference-side pieces of the JAX package's train/step.py: the
voxel → screen matrix and the eval forward. The training step itself is
not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from corenet_tpu_torch.models.corenet import CoreNet


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


def make_eval_forward(model: CoreNet) -> Callable[..., torch.Tensor]:
  """Inference: (image, camera, v2x, grid_offset) → class PMF
  [B, D, H, W, C], the softmax of the logits over channels. The model
  must be in eval mode on the device of the inputs."""

  @torch.inference_mode()
  def forward(image, camera, v2x, grid_offset):
    logits = model(image, compute_v2s(camera, v2x), grid_offset)
    return torch.softmax(logits, dim=-1)

  return forward
