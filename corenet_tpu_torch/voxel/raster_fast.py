"""Blocked triangle rasterization for subdivided meshes: the on-device
ground truth's fast path.

Counterpart of corenet_tpu/voxel/raster_fast.py. Triangles come
subdivided (data/batching.py) so that each one's projected bbox spans at
most ~2.5 voxels; then each touches at most an 8×8×8-voxel block, and the
rasterizer, `ops/blocked_raster.py` (one CUDA kernel on the card), does
for each triangle what two phases spell out as tensor code here, its
plain version on the CPU:

  Phase A (`_phase_a`, tensor code over [B, T]): samples a cell-aligned
    window of 4·irm pixels per triangle on its dominant plane, ORs the
    fragments' depth bits into a 4×4-cell mask, orients it into grid
    (y, x, z) and packs it into the z-words of an 8 × 8 block with an
    origin (voxel/packed.py layout).
  Phase B (`ops/block_scatter.py::block_scatter_or_reference`): ORs every
    block into the bit-packed grid.

Then the packed interior fill (voxel/packed.py). The sampling follows the
reference's GL voxelizer (voxelize.geom:44-56, voxelize.frag:29-58); a
sample's in-plane cell is exact (cell = pixel // irm on the cell-aligned
window), its depth the barycentric interpolation.

Everything here is integer and comparison work on float32 inputs, run
under `torch.no_grad()`; the view → voxel transform is applied
elementwise, never through a matmul (so no TF32 rounding on the card).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from corenet_tpu_torch.ops.blocked_raster import blocked_raster_or
from corenet_tpu_torch.voxel.packed import (
    fill_inside_packed, shift_along, shift_right)
from corenet_tpu_torch.voxel.voxelize import (
    _PLANE_AXES, _dominant_axis, _edge)

DEPTH_CELLS = 8
UV_CELLS = 4


def blocked_eligible(*, resolution, sub_grid_sampling,
                     image_resolution_multiplier,
                     projection_depth_multiplier,
                     max_bbox_pixels) -> bool:
  """Whether the blocked rasterizer serves this configuration: a cubic
  grid whose depth is a multiple of 32, an integer image resolution
  multiplier irm, no sub-grid sampling, projection depth multiplier 1,
  and a sampling window with (max_bbox_pixels − 4) ≤ 2.5·irm (the
  subdivision contract)."""
  d, h, w = resolution
  irm = image_resolution_multiplier
  return (d == h == w and d % 32 == 0 and d >= 32
          and not sub_grid_sampling
          and projection_depth_multiplier == 1
          and float(irm) == int(irm) and int(irm) >= 1
          and max_bbox_pixels is not None
          and (max_bbox_pixels - 4) <= 2.5 * int(irm))


def _project(triangles: torch.Tensor, view2voxel: torch.Tensor, *, m: int,
             irm: int):
  """Per-triangle projection geometry. triangles f32[B, T, 3, 3] (vertex,
  coordinate); view2voxel f32[B, M, 4, 4], the same matrix for every mesh
  slot of a scene (slot 0's is used)."""
  wp = UV_CELLS * irm  # window size in pixels
  image_res = m * irm
  # The sample spacing 1/irm as float32; divisions go through a tensor on
  # the device (a CUDA division by a host scalar multiplies by its
  # reciprocal, which rounds differently).
  s = torch.full((), m / image_res, dtype=torch.float32,
                 device=triangles.device)

  mat = view2voxel[:, 0, None, None]  # [B, 1, 1, 4, 4]
  v = (triangles[..., 0:1] * mat[..., :3, 0]
       + triangles[..., 1:2] * mat[..., :3, 1]
       + triangles[..., 2:3] * mat[..., :3, 2]) + mat[..., :3, 3]

  normal = torch.linalg.cross(v[..., 1, :] - v[..., 0, :],
                              v[..., 2, :] - v[..., 0, :], dim=-1)
  k = _dominant_axis(normal)  # [B, T]

  vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]  # [B, T, 3 vertices]
  k_ = k[..., None]
  vu = torch.where(k_ == 0, vy, torch.where(k_ == 1, vz, vx))
  vv = torch.where(k_ == 0, vz, torch.where(k_ == 1, vx, vy))
  vd = torch.where(k_ == 0, vx, torch.where(k_ == 1, vy, vz))
  (u0, v0), (u1, v1), (u2, v2) = _PLANE_AXES
  u_ax = torch.where(k == 0, u0, torch.where(k == 1, u1, u2))
  v_ax = torch.where(k == 0, v0, torch.where(k == 1, v1, v2))

  # Cell-aligned, clipped pixel window (a multiple of irm, so that sample
  # column a belongs to cell a // irm exactly). The floor division must
  # floor: the start can be negative before the clip.
  def window_start(vmin):
    i0 = torch.floor(vmin / s).to(torch.int32) - 2
    i0 = torch.div(i0, irm, rounding_mode="floor") * irm
    return i0.clamp(0, image_res - wp)

  iu0 = window_start(vu.amin(dim=-1))
  iv0 = window_start(vv.amin(dim=-1))
  ou = iu0 // irm  # first covered cell along u, in [0, m − 4]
  ov = iv0 // irm
  bu = torch.clamp(ou // 4 * 4, max=m - 8)
  bv = torch.clamp(ov // 4 * 4, max=m - 8)
  return dict(s=s, k=k, u_ax=u_ax, v_ax=v_ax, vu=vu, vv=vv, vd=vd,
              iu0=iu0, iv0=iv0, ou=ou, ov=ov, bu=bu, bv=bv)


def _place(u_ax, v_ax, axis, u_val, v_val, d_val):
  return torch.where(u_ax == axis, u_val,
                     torch.where(v_ax == axis, v_val, d_val))


def _or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
  """Bitwise OR over dim (kept, size 1), by halving."""
  while x.shape[dim] > 1:
    n = x.shape[dim]
    half = n // 2
    y = x.narrow(dim, 0, half) | x.narrow(dim, n - half, half)
    if n % 2:
      y = torch.cat([y, x.narrow(dim, half, 1)], dim=dim)
    x = y
  return x


def _pad8(x: torch.Tensor) -> torch.Tensor:
  """Zero-pads the last two dims to 8 × 8."""
  return F.pad(x, (0, 8 - x.shape[-1], 0, 8 - x.shape[-2]))


def _phase_a(triangles: torch.Tensor,      # f32[B, T, 3, 3]
             tri_mesh_slot: torch.Tensor,  # i32[B, T]
             view2voxel: torch.Tensor,     # f32[B, M, 4, 4]
             tri_valid: torch.Tensor,      # bool[B, T]
             *,
             m: int,                       # cubic grid extent
             irm: int,
             conservative: bool) -> Tuple[torch.Tensor, torch.Tensor]:
  """Per-triangle packed blocks: (origins int32[B, T], pw int32[B, T, 8,
  8·NW]). origins = (slot·m + oy)·m + ox, or −1 for a triangle that
  covers nothing (its pw is all zero)."""
  dev = triangles.device
  wp = UV_CELLS * irm
  nw = m // 32
  g = _project(triangles, view2voxel, m=m, irm=irm)
  s, k, u_ax, v_ax = g["s"], g["k"], g["u_ax"], g["v_ax"]
  vu, vv, vd = g["vu"], g["vv"], g["vd"]

  a = torch.arange(wp, dtype=torch.int32, device=dev)
  pu = (g["iu0"][..., None] + a).to(torch.float32) * s + 0.5 * s  # [B,T,WP]
  pv = (g["iv0"][..., None] + a).to(torch.float32) * s + 0.5 * s
  pu2 = pu[..., :, None]  # [B, T, WP, 1]
  pv2 = pv[..., None, :]  # [B, T, 1, WP]
  u0, u1, u2 = (vu[..., i, None, None] for i in range(3))
  v0, v1, v2 = (vv[..., i, None, None] for i in range(3))

  w0 = _edge(pu2, pv2, u1, v1, u2, v2)
  w1 = _edge(pu2, pv2, u2, v2, u0, v0)
  w2 = _edge(pu2, pv2, u0, v0, u1, v1)
  area2 = w0 + w1 + w2

  if conservative:
    sgn = torch.sign(area2)
    half = s * 0.5

    def edge_ok(w, a_u, a_v, b_u, b_v):
      du = -(b_v - a_v)
      dv = b_u - a_u
      slack = (du.abs() + dv.abs()) * half
      return sgn * w + slack >= 0

    cov = (edge_ok(w0, u1, v1, u2, v2) & edge_ok(w1, u2, v2, u0, v0)
           & edge_ok(w2, u0, v0, u1, v1))
    cov &= ((pu2 + half >= torch.minimum(torch.minimum(u0, u1), u2))
            & (pu2 - half <= torch.maximum(torch.maximum(u0, u1), u2))
            & (pv2 + half >= torch.minimum(torch.minimum(v0, v1), v2))
            & (pv2 - half <= torch.maximum(torch.maximum(v0, v1), v2)))
  else:
    eps = 1e-4 * area2.abs()
    cov = (((w0 >= -eps) & (w1 >= -eps) & (w2 >= -eps))
           | ((w0 <= eps) & (w1 <= eps) & (w2 <= eps)))
    del eps

  # The `del`s free each [B, T, WP, WP] temporary once it is used (268 MB
  # in float32 at h7).
  nz_area = area2.abs() > 0
  inv_area = torch.where(nz_area, 1.0 / torch.where(nz_area, area2, 1.0),
                         0.0)
  del area2
  depth = ((w0 * inv_area) * vd[..., 0, None, None]
           + (w1 * inv_area) * vd[..., 1, None, None]
           + (w2 * inv_area) * vd[..., 2, None, None])
  del w0, w1, w2, inv_area
  cov &= nz_area & tri_valid[..., None, None] & (depth >= 0) & (depth < m)
  cd = torch.floor(depth).to(torch.int32)
  del depth, nz_area

  big = 1 << 20
  dmin = torch.where(cov, cd, big).amin(dim=(-2, -1))  # [B, T]
  od = dmin.clamp(0, m - DEPTH_CELLS)
  dz = cd - od[..., None, None]
  cov &= (dz >= 0) & (dz < DEPTH_CELLS)
  bitz = torch.where(cov, torch.ones_like(dz) << dz.clamp(0, 31), 0)
  del cov, cd, dz
  # OR the samples of each (cu, cv) cell: its irm × irm sub-block.
  bitz = bitz.reshape(bitz.shape[:2] + (UV_CELLS, irm, UV_CELLS, irm))
  b3 = _or_reduce(_or_reduce(bitz, -1), -3)[..., 0, :, 0]  # [B, T, 4, 4]
  del bitz

  # Orient (cu, cv, d) into grid (y, x, z): unpack the d bits, permute per
  # dominant axis, repack the z bits.
  dvals = torch.arange(DEPTH_CELLS, dtype=torch.int32, device=dev)
  uvals = dvals[:UV_CELLS]
  dbits = (b3[..., None] >> dvals) & 1  # [B, T, cu, cv, d]

  def pack_last(x, vals):
    return (x << vals).sum(dim=-1, dtype=torch.int32)

  # k=2: (u, v, d) = (x, y, z): cube[y=cv, x=cu], bits z=d.
  c2 = _pad8(pack_last(dbits.transpose(-3, -2), dvals))
  # k=0: (u, v, d) = (y, z, x): cube[y=cu, x=d], bits z=cv.
  c0 = _pad8(pack_last(dbits.transpose(-2, -1), uvals))
  # k=1: (u, v, d) = (z, x, y): cube[y=d, x=cv], bits z=cu.
  c1 = _pad8(pack_last(dbits.permute(0, 1, 4, 3, 2), uvals))
  k4 = k[..., None, None]
  cube = torch.where(k4 == 0, c0, torch.where(k4 == 1, c1, c2))  # [B,T,8,8]

  # The u/v block origins are snapped to multiples of 4 (_project; content
  # ≤ 4 cells + a shift ≤ 4 = 8), the depth role keeps its exact origin.
  ou, ov, bu, bv = g["ou"], g["ov"], g["bu"], g["bv"]
  su, sv = ou - bu, ov - bv  # in [0, 4]
  zero = torch.zeros_like(su)
  bx, by, bz = (_place(u_ax, v_ax, i, bu, bv, od) for i in range(3))
  sx, sy, sz = (_place(u_ax, v_ax, i, su, sv, zero) for i in range(3))

  cube = cube << sz[..., None, None]

  def shift8(x, sh, dim):
    """Rows (dim −2) or columns (dim −1) moved by sh ∈ [0, 4] per
    triangle; the content is never pushed out."""
    res = torch.where((sh == 0)[..., None, None], x, 0)
    for cand in range(1, 5):
      res |= torch.where((sh == cand)[..., None, None],
                         shift_along(x, dim, cand, down=True), 0)
    return res

  cube = shift8(shift8(cube, sy, -2), sx, -1)

  # Pack into z-words: bit bz + the bit's index in the cube, spread over
  # word bz // 32 (lo) and the next (hi).
  shift = (bz % 32)[..., None, None]
  wd = (bz // 32)[..., None, None, None]
  lo = cube << shift
  hi = shift_right(cube, 1) >> (31 - shift)
  wds = torch.arange(nw, dtype=torch.int32, device=dev)
  pw = torch.where(wds == wd, lo[..., None],
                   torch.where(wds == wd + 1, hi[..., None], 0))
  pw = pw.reshape(pw.shape[:2] + (8, 8 * nw))  # [B, T, 8, 8·NW]

  nonzero = (b3 != 0).any(dim=-1).any(dim=-1)
  origins = torch.where(nonzero & tri_valid,
                        (tri_mesh_slot * m + by) * m + bx, -1)
  return origins.to(torch.int32), pw


@torch.no_grad()
def voxelize_blocked_packed(
    triangles: torch.Tensor,          # f32[B, T, 3, 3]
    tri_mesh_slot: torch.Tensor,      # i32[B, T]
    view2voxel: torch.Tensor,         # f32[B, M, 4, 4]
    tri_valid: torch.Tensor,          # bool[B, T]
    *,
    num_meshes: int,
    resolution: Tuple[int, int, int],
    image_resolution_multiplier: int = 8,
    conservative_rasterization: bool = False,
    fill_inside: bool = True,
    fill_rounds: Optional[int] = None,
) -> torch.Tensor:
  """Batched blocked voxelization → packed int32[B, M, H, W, NW].

  Every mesh slot of a scene shares that scene's view → voxel matrix
  (slot 0's), as the ground truth's scale-and-shift does. fill_rounds as
  in voxel/packed.py::fill_inside_packed."""
  d, h, w = resolution
  if not (d == h == w and d % 32 == 0):
    raise ValueError(f"the blocked rasterizer needs a cubic grid whose "
                     f"extent is a multiple of 32, got {resolution}")
  m = d
  packed = blocked_raster_or(triangles, tri_mesh_slot, view2voxel, tri_valid,
                             meshes=num_meshes, m=m,
                             irm=int(image_resolution_multiplier),
                             conservative=conservative_rasterization)
  packed = packed.reshape(packed.shape[:-1] + (m, m // 32))
  if fill_inside:
    packed = fill_inside_packed(packed, fill_rounds=fill_rounds)
  return packed
