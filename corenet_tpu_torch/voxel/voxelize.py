"""Triangle-projection helpers shared with the general rasterizer.

Counterpart of corenet_tpu/voxel/voxelize.py:50-64, the parts the blocked
rasterizer (voxel/raster_fast.py) needs: each triangle is rasterized by
orthographic projection onto the axis-aligned plane that maximizes its
projected area, with the reference's GLSL comparison rules
(voxelize.geom:44-56). The general rasterizer itself is not ported yet.
"""

from __future__ import annotations

import torch

# Plane (u, v) coordinate axes for each dominant axis k (x=0, y=1, z=2):
# k=0 → (y, z); k=1 → (z, x); k=2 → (x, y), the GLSL swizzles yzxw, zxyw
# and the identity.
_PLANE_AXES = ((1, 2), (2, 0), (0, 1))


def _dominant_axis(normals: torch.Tensor) -> torch.Tensor:
  """int32 index of the largest |normal| component; ties go to z, then
  y, as GLSL's strict comparisons do."""
  a = normals.abs()
  ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
  is_x = (ax > ay) & (ax > az)
  is_y = (ay > ax) & (ay > az)
  two = torch.full_like(ax, 2, dtype=torch.int32)
  return torch.where(is_x, 0, torch.where(is_y, 1, two))


def _edge(pu, pv, au, av, bu, bv):
  """2D edge function e(P; A→B) = (B − A) × (P − A)."""
  return (bu - au) * (pv - av) - (bv - av) * (pu - au)
