"""Composition of per-mesh binary grids into labeled batch grids.

Counterpart of corenet_tpu/voxel/compose.py: one scatter-max,
out[b] = max over the meshes of batch element b of label(mesh) · grid(mesh).
"""

from __future__ import annotations

import torch


def compose_batch_grid(mesh_grids: torch.Tensor,
                       mesh_batch_index: torch.Tensor,
                       mesh_labels: torch.Tensor,
                       batch_size: int) -> torch.Tensor:
  """Composes per-mesh grids into per-batch labeled grids.

  Args:
    mesh_grids: float32[M, D, H, W], binary occupancy per mesh.
    mesh_batch_index: int[M], the batch element each mesh belongs to. A
      padded mesh may use an out-of-range index (e.g. batch_size) and is
      dropped; a negative index counts from the end.
    mesh_labels: int[M] or float32[M], the voxel value of each mesh (mesh
      index + 1, semantic class, or 1).
    batch_size: number of batch elements.

  Returns:
    int32[batch_size, D, H, W].
  """
  if mesh_grids.dim() != 4:
    raise ValueError(f"mesh_grids must be [M, D, H, W], got "
                     f"{tuple(mesh_grids.shape)}")
  labeled = mesh_grids * mesh_labels.to(torch.float32)[:, None, None, None]
  index = mesh_batch_index.long()
  index = torch.where(index < 0, index + batch_size, index)
  # Dropped meshes go to one dump row past the batch, sliced off after.
  index = torch.where((index >= 0) & (index < batch_size), index, batch_size)
  out = torch.zeros((batch_size + 1,) + tuple(mesh_grids.shape[1:]),
                    dtype=torch.float32, device=mesh_grids.device)
  out.scatter_reduce_(0, index[:, None, None, None].expand_as(labeled),
                      labeled, "amax")
  return out[:batch_size].to(torch.int32)
