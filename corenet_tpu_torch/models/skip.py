"""Ray-traced skip connection: project voxel centers into a 2D feature map
and gather per-voxel features.

Counterpart of corenet_tpu/models/skip.py, with the same quirks of the
reference model:

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

Packed (space-to-depth) execution takes the voxels phase by phase: 8
grids of D/2 × H/2 × W/2, phase p = (pz·2 + py)·2 + px holding the fine
voxels (2Z + pz, 2Y + py, 2X + px). The gather then gives
[B, 8, D/2·H/2·W/2, C], which the packed decoder concatenates per phase
with no reshuffle, and whose gradient comes back in a layout the
backward kernel walks in place (csrc/skip_gather.cu). The JAX package
takes the phase as the innermost index instead, for its channel-last
block concatenation; each voxel reads the same pixel either way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from corenet_tpu_torch.models import layers
from corenet_tpu_torch.ops import skip_gather as skip_gather_op


def _coordinates(size: int, offset: torch.Tensor, packed: bool
                 ) -> torch.Tensor:
  """[B, size] voxel coordinates + offset along one axis; packed: [B, 2,
  size/2], phase r and cell M holding 2M + r."""
  c = torch.arange(size, dtype=torch.float32, device=offset.device)
  if packed:
    c = c.view(size // 2, 2).t()
  return c[None] + offset.view((-1,) + (1,) * c.dim())


def voxel_pixel_indices(voxel_projection_matrix: torch.Tensor,
                        voxel_sample_location: torch.Tensor,
                        grid_resolution: Tuple[int, int, int],
                        height: int, width: int, packed: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Pixel indices into the 1-px padded [height + 2, width + 2] map of
  every voxel of a (depth, height, width) grid, voxels in (z, y, x) order;
  packed: in (pz, py, px, z, y, x) order, the packed decoder's 8 phase
  grids of half the resolution, one after another.

  Args:
    voxel_projection_matrix: float32[B, 4, 4], voxel → screen (NDC).
    voxel_sample_location: float32[B, 3], in-voxel sample offset (x, y, z).

  Returns:
    (px, py), each int32[B, D·H·W].
  """
  gd, gh, gw = grid_resolution
  if packed and (gd % 2 or gh % 2 or gw % 2):
    raise ValueError(f"packed skips need an even grid, got "
                     f"{tuple(grid_resolution)}")
  m = voxel_projection_matrix
  b = m.shape[0]
  # Voxel centers in (x, y, z) order plus the sample offset, kept as
  # broadcastable axes instead of a materialized [B, D, H, W, 3] grid;
  # packed: (pz, py, px, z, y, x) axes.
  loc = voxel_sample_location
  xs, ys, zs = (_coordinates(size, loc[:, axis], packed)
                for axis, size in ((0, gw), (1, gh), (2, gd)))
  if packed:
    xs = xs.view(b, 1, 1, 2, 1, 1, gw // 2)
    ys = ys.view(b, 1, 2, 1, 1, gh // 2, 1)
    zs = zs.view(b, 2, 1, 1, gd // 2, 1, 1)
  else:
    xs = xs.view(b, 1, 1, gw)
    ys = ys.view(b, 1, gh, 1)
    zs = zs.view(b, gd, 1, 1)
  lead = (b, 4) + (1,) * (xs.dim() - 1)

  def project(i):  # row i of M[:, :, :3] · c + M[:, :, 3]
    r = m[:, i].view(lead)
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
                  outside_value: float = 0.0,
                  packed: bool = False) -> torch.Tensor:
  """Samples a 2D grid at the projected centers of a 3D voxel grid.

  Args:
    grid2d: float[B, H, W, C] (already channel-compressed).
    voxel_projection_matrix: float32[B, 4, 4], voxel → screen (NDC).
    voxel_sample_location: float32[B, 3], in-voxel sample offset (x, y, z).
    grid_resolution: (depth, height, width) of the output 3D grid.
    outside_value: fill value for out-of-image / behind-camera voxels.
    packed: the packed decoder's voxel order (see the module's note).

  Returns:
    [B, depth, height, width, C] in grid2d's dtype; packed:
    [B, 8, depth/2, height/2, width/2, C], phase p holding the fine voxels
    (2z + pz, 2y + py, 2x + px).
  """
  b, h, w, c = grid2d.shape
  px, py = voxel_pixel_indices(voxel_projection_matrix,
                               voxel_sample_location, grid_resolution, h, w,
                               packed=packed)
  padded = F.pad(grid2d, (0, 0, 1, 1, 1, 1), value=outside_value)
  if not packed:
    gathered = skip_gather_op.skip_gather(padded.contiguous(), px, py,
                                          tuple(grid_resolution))
    return gathered.reshape((b,) + tuple(grid_resolution) + (c,))
  half = tuple(v // 2 for v in grid_resolution)
  gathered = skip_gather_op.skip_gather(padded.contiguous(), px, py, half,
                                        phases=8)
  return gathered.view((b, 8) + half + (c,))


class SampleGrid2d(nn.Module):
  """1×1 channel compression + projected gather (ray-traced skip), in the
  port's inner layout: grid2d [B, C, H, W] → [B, out, D, H, W], in the
  compression's compute dtype (the gather copies rows of that dtype);
  packed: [B, 8, out, D/2, H/2, W/2], phase-major, a view of the
  gather's output."""

  def __init__(self, in_channels: int, out_channels: int,
               grid_resolution: Tuple[int, int, int],
               packed: bool = False,
               compute_dtype: Optional[torch.dtype] = None,
               device: Optional[torch.device] = None):
    super().__init__()
    self.grid_resolution = tuple(grid_resolution)
    self.packed = packed
    self.compress_channels = layers.Conv(in_channels, out_channels, 1,
                                         ndim=2, compute_dtype=compute_dtype,
                                         device=device)

  def forward(self, grid2d: torch.Tensor,
              voxel_projection_matrix: torch.Tensor,
              voxel_sample_location: torch.Tensor) -> torch.Tensor:
    compressed = self.compress_channels(grid2d).permute(0, 2, 3, 1)
    sampled = sample_grid2d(compressed, voxel_projection_matrix,
                            voxel_sample_location, self.grid_resolution,
                            packed=self.packed)
    if self.packed:
      return sampled.permute(0, 1, 5, 2, 3, 4)
    return sampled.permute(0, 4, 1, 2, 3)
