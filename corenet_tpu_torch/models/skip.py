"""Ray-traced skip connection: project voxel centers into a 2D feature map
and gather per-voxel features.

Counterpart of corenet_tpu/models/skip.py (fine layout), with the same
quirks of the reference model:

* pixel indices truncate toward zero (`.to(torch.int32)`), not floor, so a
  projected x in (−1, 0) reads pixel 0;
* nearest-pixel gather, no filtering;
* a 1-pixel pad holding `outside_value` catches voxels that project
  outside the image;
* voxels behind the camera (pre-division z < 0) index pixel (0, 0) of the
  padded map, a pad cell, so they read `outside_value` too.

Every gather goes through ops/skip_gather.py, differentiable in the map:
its CUDA kernels (gather, and scatter-add for the gradient) for CUDA
tensors, its plain versions for CPU tensors. The JAX package skipped its
Pallas kernel below 32768 voxels, a TPU launch-cost threshold that does
not carry over, so on the card all four skips of a decode launch it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from corenet_tpu_torch.models import layers
from corenet_tpu_torch.ops import skip_gather as skip_gather_op


def voxel_pixel_indices(voxel_projection_matrix: torch.Tensor,
                        voxel_sample_location: torch.Tensor,
                        grid_resolution: Tuple[int, int, int],
                        height: int, width: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Pixel indices into the 1-px padded [height + 2, width + 2] map of
  every voxel of a (depth, height, width) grid, voxels in (z, y, x) order.

  Args:
    voxel_projection_matrix: float32[B, 4, 4], voxel → screen (NDC).
    voxel_sample_location: float32[B, 3], in-voxel sample offset (x, y, z).

  Returns:
    (px, py), each int32[B, D·H·W].
  """
  gd, gh, gw = grid_resolution
  m = voxel_projection_matrix
  device = m.device
  b = m.shape[0]
  # Voxel centers in (x, y, z) order plus the sample offset, kept as three
  # broadcastable axes instead of a materialized [B, D, H, W, 3] grid.
  loc = voxel_sample_location
  xs = (torch.arange(gw, dtype=torch.float32, device=device)[None]
        + loc[:, 0:1]).view(b, 1, 1, gw)
  ys = (torch.arange(gh, dtype=torch.float32, device=device)[None]
        + loc[:, 1:2]).view(b, 1, gh, 1)
  zs = (torch.arange(gd, dtype=torch.float32, device=device)[None]
        + loc[:, 2:3]).view(b, gd, 1, 1)

  def project(i):  # row i of M[:, :, :3] · c + M[:, :, 3]
    r = m[:, i].view(b, 4, 1, 1, 1)
    return r[:, 0] * xs + r[:, 1] * ys + r[:, 2] * zs + r[:, 3]

  hom_x, hom_y, hom_z, hom_w = (project(i) for i in range(4))
  pc_x = (hom_x / hom_w) / 2.0 + 0.5  # [0, 1] across the image
  pc_y = (hom_y / hom_w) / 2.0 + 0.5
  # Truncation toward zero. Clamping to [−1, size + 1] first changes no
  # index (both ends land in the pad either way) but keeps far-off or
  # infinite projections inside int32.
  pix_x = (pc_x * width).clamp(-1.0, width + 1.0).to(torch.int32)
  pix_y = (pc_y * height).clamp(-1.0, height + 1.0).to(torch.int32)
  px = (pix_x + 1).clamp(0, width + 1)
  py = (pix_y + 1).clamp(0, height + 1)
  behind = hom_z < 0
  px = torch.where(behind, 0, px)
  py = torch.where(behind, 0, py)
  return px.reshape(b, -1), py.reshape(b, -1)


def sample_grid2d(grid2d: torch.Tensor,
                  voxel_projection_matrix: torch.Tensor,
                  voxel_sample_location: torch.Tensor,
                  grid_resolution: Tuple[int, int, int],
                  outside_value: float = 0.0) -> torch.Tensor:
  """Samples a 2D grid at the projected centers of a 3D voxel grid.

  Args:
    grid2d: float[B, H, W, C] (already channel-compressed).
    voxel_projection_matrix: float32[B, 4, 4], voxel → screen (NDC).
    voxel_sample_location: float32[B, 3], in-voxel sample offset (x, y, z).
    grid_resolution: (depth, height, width) of the output 3D grid.
    outside_value: fill value for out-of-image / behind-camera voxels.

  Returns:
    [B, depth, height, width, C] in grid2d's dtype.
  """
  b, h, w, c = grid2d.shape
  px, py = voxel_pixel_indices(voxel_projection_matrix,
                               voxel_sample_location, grid_resolution, h, w)
  padded = F.pad(grid2d, (0, 0, 1, 1, 1, 1), value=outside_value)
  gathered = skip_gather_op.skip_gather(padded.contiguous(), px, py,
                                        tuple(grid_resolution))
  return gathered.reshape((b,) + tuple(grid_resolution) + (c,))


class SampleGrid2d(nn.Module):
  """1×1 channel compression + projected gather (ray-traced skip), in the
  port's inner layout: grid2d [B, C, H, W] → [B, out, D, H, W]."""

  def __init__(self, in_channels: int, out_channels: int,
               grid_resolution: Tuple[int, int, int],
               device: Optional[torch.device] = None):
    super().__init__()
    self.grid_resolution = tuple(grid_resolution)
    self.compress_channels = layers.Conv(in_channels, out_channels, 1,
                                         ndim=2, device=device)

  def forward(self, grid2d: torch.Tensor,
              voxel_projection_matrix: torch.Tensor,
              voxel_sample_location: torch.Tensor) -> torch.Tensor:
    compressed = self.compress_channels(grid2d).permute(0, 2, 3, 1)
    sampled = sample_grid2d(compressed, voxel_projection_matrix,
                            voxel_sample_location, self.grid_resolution)
    return sampled.permute(0, 4, 1, 2, 3)
