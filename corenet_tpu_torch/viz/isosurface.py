"""Isosurface mesh extraction: vectorized marching tetrahedra (numpy, host).

A copy of corenet_tpu/viz/isosurface.py, so that its triangles equal the
JAX package's bit for bit. It covers the mesh-extraction role of the
reference's MarchingCubesArtifact: each cell splits into 6 tetrahedra
around the main diagonal, which gives a watertight, ambiguity-free surface
from a 16-case table built programmatically below, and the per-case work
vectorizes over all active cells at once.

The extraction runs on the host: it feeds the qualitative-result
renderer, runs on a handful of scenes per eval, and its output is a
variable-length triangle soup.

Also provides the reference's pre-extraction box-filter smoothing as
`box_filter3d`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Tetrahedral decomposition of the unit cube around the 0-7 diagonal.
# Cube corners are indexed by bits (z, y, x): corner i is at
# (x=i&1, y=(i>>1)&1, z=(i>>2)&1). Every tet contains corners 0 and 7, so
# adjacent cells' shared faces triangulate consistently (watertight).
_CUBE_CORNERS = np.array(
    [[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.float32)
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
    [0, 5, 1, 7],
], np.int32)

# Tet edges (pairs of local tet-vertex indices 0..3).
_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32)
_E01, _E02, _E03, _E12, _E13, _E23 = range(6)


def _build_tri_table() -> np.ndarray:
  """TRI_TABLE[case, tri, corner] = edge id or -1.

  case = 4-bit mask, bit v set when tet vertex v is above the level.
  One vertex above → the triangle of its 3 incident edges; two above →
  the quad of the 4 cut edges, split into 2 triangles; complements share
  the same cut edges. Windings are not normalized — the software
  renderer shades double-sided (viz/renderer.py)."""
  table = np.full((16, 2, 3), -1, np.int32)
  single = {
      0b0001: (_E01, _E02, _E03),  # vertex 0
      0b0010: (_E01, _E12, _E13),  # vertex 1
      0b0100: (_E02, _E12, _E23),  # vertex 2
      0b1000: (_E03, _E13, _E23),  # vertex 3
  }
  # Quad edge rings for the two-above cases: consecutive edges share a
  # tet face, so the fan split (0,1,2)+(0,2,3) is planar-consistent.
  double = {
      0b0011: (_E02, _E12, _E13, _E03),  # vertices 0, 1
      0b0101: (_E01, _E12, _E23, _E03),  # vertices 0, 2
      0b1001: (_E01, _E13, _E23, _E02),  # vertices 0, 3
  }
  for mask, tri in single.items():
    table[mask, 0] = tri
    table[mask ^ 0b1111, 0] = tri
  for mask, (a, b, c, d) in double.items():
    for m in (mask, mask ^ 0b1111):
      table[m, 0] = (a, b, c)
      table[m, 1] = (a, c, d)
  return table


_TRI_TABLE = _build_tri_table()


def box_filter3d(volume: np.ndarray, size: int) -> np.ndarray:
  """Box-filters a 3D volume with a size³ mean kernel, zero padding —
  the smoothing the reference applies before marching cubes
  (artifacts.py:225-229: pad (k-1)//2 / k-1-(k-1)//2, mean conv)."""
  if size <= 1:
    return np.asarray(volume, np.float32)
  v = np.asarray(volume, np.float32)
  lo = (size - 1) // 2
  hi = size - 1 - lo
  out = v
  for axis in range(3):
    pads = [(0, 0)] * 3
    pads[axis] = (lo + 1, hi)  # +1 leading zero for the cumsum diff
    c = np.cumsum(np.pad(out, pads), axis=axis)
    n = out.shape[axis]
    idx_hi = np.arange(n) + size
    idx_lo = np.arange(n)
    out = (np.take(c, idx_hi, axis=axis) -
           np.take(c, idx_lo, axis=axis)) / size
  return out


def count_active_cells(volume: np.ndarray, level: float = 0.5,
                       pad: bool = True) -> int:
  """Number of sign-change cells `marching_tetrahedra` would visit.

  An O(voxels) boolean pass with no per-triangle allocation: each active
  cell emits ~2-6 triangles (at most 12), so callers can bound the
  extraction size BEFORE paying for it — a near-noise PMF at 128³ can
  otherwise transiently allocate tens of millions of sliver triangles
  just to be discarded by a post-hoc cap."""
  v = np.asarray(volume, np.float32)
  assert v.ndim == 3
  if pad:
    fill = min(level - 1.0, float(v.min()) - 1.0)
    v = np.pad(v, 1, constant_values=fill)
  if min(v.shape) < 2:
    return 0
  above = v > level
  c_any = np.zeros(tuple(s - 1 for s in v.shape), bool)
  c_all = np.ones_like(c_any)
  for dz in (0, 1):
    for dy in (0, 1):
      for dx in (0, 1):
        corner = above[dz:dz + c_any.shape[0], dy:dy + c_any.shape[1],
                       dx:dx + c_any.shape[2]]
        c_any |= corner
        c_all &= corner
  return int((c_any & ~c_all).sum())


def marching_tetrahedra(volume: np.ndarray, level: float = 0.5,
                        pad: bool = True) -> np.ndarray:
  """Extracts the `level` isosurface of float[D, H, W] as triangles.

  Returns float32[T, 3, 3] vertices in (x, y, z) grid coordinates, where
  lattice point (x, y, z) sits at the value volume[z, y, x] (vertex
  coordinates therefore span [0, W-1] etc., or [-1, dim] with pad).
  pad=True surrounds the volume with below-level values so grids that are
  "above" at the boundary still produce a closed surface (the reference
  pads with zeros, artifacts.py:270)."""
  v = np.asarray(volume, np.float32)
  assert v.ndim == 3
  offset = 0.0
  if pad:
    fill = min(level - 1.0, float(v.min()) - 1.0)
    v = np.pad(v, 1, constant_values=fill)
    offset = -1.0
  d, h, w = v.shape
  if min(d, h, w) < 2:
    return np.zeros((0, 3, 3), np.float32)

  # Corner value stencil per cell: [D-1, H-1, W-1, 8].
  corner_vals = np.empty((d - 1, h - 1, w - 1, 8), np.float32)
  for i in range(8):
    x, y, z = int(_CUBE_CORNERS[i, 0]), int(_CUBE_CORNERS[i, 1]), \
        int(_CUBE_CORNERS[i, 2])
    corner_vals[..., i] = v[z:z + d - 1, y:y + h - 1, x:x + w - 1]

  above = corner_vals > level
  active = above.any(-1) & ~above.all(-1)
  cz, cy, cx = np.nonzero(active)
  if cz.size == 0:
    return np.zeros((0, 3, 3), np.float32)
  vals = corner_vals[cz, cy, cx]        # [N, 8]
  base = np.stack([cx, cy, cz], -1).astype(np.float32)  # [N, 3] (x, y, z)

  tris = []
  for tet in _TETS:
    tvals = vals[:, tet]                              # [N, 4]
    tpos = _CUBE_CORNERS[tet][None] + base[:, None]   # [N, 4, 3]
    case = ((tvals > level) << np.arange(4)).sum(-1)  # [N]
    edges = _TRI_TABLE[case]                          # [N, 2, 3]
    for k in range(2):
      ek = edges[:, k]                                # [N, 3] edge ids
      keep = ek[:, 0] >= 0
      if not keep.any():
        continue
      ek = ek[keep]
      va = _EDGES[ek, 0]                              # [M, 3] tet verts
      vb = _EDGES[ek, 1]
      fa = np.take_along_axis(tvals[keep], va, axis=1)
      fb = np.take_along_axis(tvals[keep], vb, axis=1)
      pa = np.take_along_axis(tpos[keep], va[..., None], axis=1)
      pb = np.take_along_axis(tpos[keep], vb[..., None], axis=1)
      t = (level - fa) / np.where(fb == fa, 1.0, fb - fa)
      tris.append(pa + t[..., None] * (pb - pa))
  if not tris:
    return np.zeros((0, 3, 3), np.float32)
  return (np.concatenate(tris, 0) + offset).astype(np.float32)


def extract_class_meshes(grid: np.ndarray, num_classes: int,
                         level: float = 0.5,
                         filter_kernel: int = 1) -> Tuple[np.ndarray, ...]:
  """Per-class isosurfaces of a labeled/probability grid.

  grid: either int[D, H, W] labels or float[C, D, H, W] per-class
  occupancy. Returns a tuple of float32[T_c, 3, 3] triangle soups for
  classes 1..num_classes-1 (class 0 = void, like artifacts.py:232's
  grid[1:])."""
  grid = np.asarray(grid)
  meshes = []
  for c in range(1, num_classes):
    vol = (grid == c).astype(np.float32) if grid.ndim == 3 else grid[c]
    vol = box_filter3d(vol, filter_kernel)
    meshes.append(marching_tetrahedra(vol, level=level))
  return tuple(meshes)
