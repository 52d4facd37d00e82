"""Triangle-mesh voxelization: the general rasterizer, as tensor code.

Counterpart of corenet_tpu/voxel/voxelize.py, with the semantics of the
reference's OpenGL voxelizer (voxelize.geom:44-56, voxelize.frag:29-58):

* Each triangle is transformed into voxel space by its mesh's `view2voxel`
  matrix, then rasterized by orthographic projection onto the axis-aligned
  plane that maximizes its projected area (dominant normal axis, with the
  GLSL comparison and tie rules).
* The projection plane is sampled at the centres of an R × R pixel grid,
  R = round(max(w, h, d · projection_depth_multiplier) ·
  image_resolution_multiplier); the sample spacing per axis is
  full_range / R with full_range = (w, h, d · pdm).
* Each covered sample interpolates its 3D voxel-space position
  barycentrically and marks the voxel `floor(position)` or, with sub-grid
  sampling, the cell of the irregular (2D+1, 2H+1, 2W+1) grid.
* `conservative_rasterization` marks every pixel whose square overlaps the
  projected triangle (exact separating-axis test), the position
  extrapolated at the pixel centre on the triangle's plane.

Triangles carry a mesh index and a validity flag (static shapes: pad
freely). They are processed in chunks, each storing ones into the output
grid; memory is bounded by chunk_size · window² whatever the triangle
count. The per-triangle sampling window (`max_bbox_pixels`) must cover the
triangle's projected bbox; it defaults to the full image (always right).
For large scenes, subdivide the triangles first (data/batching.py) and
use a small window.

Every float32 expression is the JAX function's, operation for operation,
so the grids are equal bit for bit on the CPU and on the card: the 3 × 3
vertex transform is an explicit sum of products (never a matmul, which
may run in TF32 on the card), and divisors are tensors on the device (a
CUDA division by a host scalar multiplies by its reciprocal, which rounds
differently).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from corenet_tpu_torch.utils import misc
from corenet_tpu_torch.utils.device import checked_device

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


def _rasterize_chunk(flat_grid, tris, mesh_idx, valid, view2voxel, *,
                     out_shape, spacing, dims, image_res, window,
                     conservative, sub_grid_s):
  """Stores 1.0 into flat_grid (the output grid flattened, plus one dump
  cell at its end) for every fragment of the chunk's triangles
  (tris f32[C, 3, 3], mesh_idx int[C], valid bool[C])."""
  dev = tris.device
  num_meshes = out_shape[0]
  # A mesh index outside the grid drops the triangle.
  valid = valid & (mesh_idx >= 0) & (mesh_idx < num_meshes)
  mesh_idx = mesh_idx.clamp(0, num_meshes - 1)
  mats = view2voxel[mesh_idx.long()]  # [C, 4, 4]
  # Vertices to voxel space (w = 1; affine matrices).
  r = mats[:, None, :3, :3]  # [C, 1, 3, 3]
  v = ((r[..., 0] * tris[..., 0:1] + r[..., 1] * tris[..., 1:2])
       + r[..., 2] * tris[..., 2:3]) + mats[:, None, :3, 3]  # [C, 3, 3]

  normal = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], dim=-1)
  k = _dominant_axis(normal)  # [C]
  (u0_ax, v0_ax), (u1_ax, v1_ax), (u2_ax, v2_ax) = _PLANE_AXES
  pu_axis = torch.where(k == 0, u0_ax, torch.where(k == 1, u1_ax, u2_ax))
  pv_axis = torch.where(k == 0, v0_ax, torch.where(k == 1, v1_ax, v2_ax))
  su = spacing[pu_axis]  # [C], the sample spacing along u
  sv = spacing[pv_axis]
  # The vertices' plane coordinates, [C, 3].
  vu = torch.gather(v, 2, pu_axis[:, None, None].expand(-1, 3, 1))[..., 0]
  vv = torch.gather(v, 2, pv_axis[:, None, None].expand(-1, 3, 1))[..., 0]

  # The pixel window starts below the projected bbox, clamped to pixel −1:
  # pixels below 0 do not exist, so a bbox hanging off the image's low
  # side must not drag the window away from the pixels that do.
  iu0 = (torch.floor(vu.amin(dim=1) / su).to(torch.int32) - 1).clamp(min=-1)
  iv0 = (torch.floor(vv.amin(dim=1) / sv).to(torch.int32) - 1).clamp(min=-1)
  steps = torch.arange(window, dtype=torch.int32, device=dev)
  iu = iu0[:, None] + steps  # [C, W]
  iv = iv0[:, None] + steps
  in_image = (((iu >= 0) & (iu < image_res))[:, :, None]
              & ((iv >= 0) & (iv < image_res))[:, None, :])

  # Sample points (pixel centres) in plane coordinates.
  pu2 = ((iu.to(torch.float32) + 0.5) * su[:, None])[:, :, None]
  pv2 = ((iv.to(torch.float32) + 0.5) * sv[:, None])[:, None, :]
  u0, u1, u2 = (vu[:, i, None, None] for i in range(3))
  v0, v1, v2 = (vv[:, i, None, None] for i in range(3))

  w0 = _edge(pu2, pv2, u1, v1, u2, v2)  # [C, W, W]
  w1 = _edge(pu2, pv2, u2, v2, u0, v0)
  w2 = _edge(pu2, pv2, u0, v0, u1, v1)
  area2 = w0 + w1 + w2  # the signed double area, constant per triangle

  if conservative:
    # Exact separating-axis test of triangle against pixel square. Edges:
    # an affine edge function's maximum over the square is its centre
    # value plus |∂e/∂u|·su/2 + |∂e/∂v|·sv/2. Axes: bbox overlap.
    sgn = torch.sign(area2)
    half_u = su[:, None, None] * 0.5
    half_v = sv[:, None, None] * 0.5

    def edge_ok(w, a_u, a_v, b_u, b_v):
      du = -(b_v - a_v)
      dv = b_u - a_u
      slack = du.abs() * half_u + dv.abs() * half_v
      return sgn * w + slack >= 0

    cov = (edge_ok(w0, u1, v1, u2, v2) & edge_ok(w1, u2, v2, u0, v0)
           & edge_ok(w2, u0, v0, u1, v1))
    cov &= ((pu2 + half_u >= torch.minimum(torch.minimum(u0, u1), u2))
            & (pu2 - half_u <= torch.maximum(torch.maximum(u0, u1), u2))
            & (pv2 + half_v >= torch.minimum(torch.minimum(v0, v1), v2))
            & (pv2 - half_v <= torch.maximum(torch.maximum(v0, v1), v2)))
  else:
    # Watertightness: adjacent triangles compute their edge functions
    # independently in float32, so a sample exactly on a shared edge can
    # test (barely) outside both, a crack through which the interior fill
    # leaks. An area-relative epsilon closes cracks.
    eps = 1e-4 * area2.abs()
    cov = (((w0 >= -eps) & (w1 >= -eps) & (w2 >= -eps))
           | ((w0 <= eps) & (w1 <= eps) & (w2 <= eps)))
    del eps

  nz_area = area2.abs() > 0
  cov &= in_image & nz_area & valid[:, None, None]

  # Barycentric position (extrapolated on the triangle's plane for
  # conservative pixels outside the triangle).
  inv_area = torch.where(nz_area, 1.0 / torch.where(nz_area, area2, 1.0),
                         0.0)
  del area2, nz_area, in_image
  b0 = (w0 * inv_area)[..., None]
  b1 = (w1 * inv_area)[..., None]
  b2 = (w2 * inv_area)[..., None]
  del w0, w1, w2, inv_area
  pos = ((b0 * v[:, None, None, 0] + b1 * v[:, None, None, 1])
         + b2 * v[:, None, None, 2])  # [C, W, W, 3]
  del b0, b1, b2
  cov &= ((pos >= 0) & (pos < dims)).all(dim=-1)  # inside the voxel box

  if sub_grid_s:
    s = sub_grid_s
    vvx = torch.floor(pos * s).to(torch.int32) + s // 2
    # The cell in the (2·dim + 1) grid: at most 2·dim, since the last
    # sub-sample of a voxel (remainder s − 1) lies below dim·s + s // 2.
    cell = 2 * (vvx // s) + (vvx % s == s - 1).to(torch.int32)
    del vvx
  else:
    cell = torch.floor(pos).to(torch.int32)
  del pos

  # Uncovered fragments hold garbage cells: they are sent to the dump cell
  # before anything is indexed. A store of 1.0 gives the same grid in any
  # order, as a scatter-max of 1.0 into a 0/1 grid does.
  _, gd, gh, gw = out_shape
  flat = ((mesh_idx[:, None, None] * gd + cell[..., 2]) * gh
          + cell[..., 1]) * gw + cell[..., 0]
  flat = torch.where(cov, flat, flat_grid.numel() - 1)
  flat_grid.index_fill_(0, flat.reshape(-1).long(), 1.0)


@torch.no_grad()
def voxelize_triangles(
    triangles: torch.Tensor,          # float32[T, 3, 3]
    tri_mesh_index: torch.Tensor,     # int32[T]
    view2voxel: torch.Tensor,         # float32[num_meshes, 4, 4]
    tri_valid: torch.Tensor,          # bool[T]
    *,
    num_meshes: int,
    resolution: Tuple[int, int, int],
    sub_grid_sampling: bool = False,
    image_resolution_multiplier: float = 4,
    conservative_rasterization: bool = False,
    projection_depth_multiplier: int = 1,
    max_bbox_pixels: Optional[int] = None,
    chunk_size: Optional[int] = None,
) -> torch.Tensor:
  """The voxelization core. Returns float32[num_meshes, D', H', W'] of
  0/1 on the triangles' device: (D, H, W), or (2D+1, 2H+1, 2W+1) with
  sub_grid_sampling."""
  depth, height, width = resolution
  irm = image_resolution_multiplier
  pdm = projection_depth_multiplier
  if sub_grid_sampling and int(irm) % 2 == 0:
    raise ValueError("image_resolution_multiplier must be odd with "
                     "sub_grid_sampling")
  if sub_grid_sampling and pdm != 1:
    raise ValueError("projection_depth_multiplier must be 1 with "
                     "sub_grid_sampling")
  dev = triangles.device

  image_res = int(round(max(width, height, depth * pdm) * irm))
  # Voxel-space full ranges per coordinate axis (x, y, z): the orthographic
  # projection maps [0, w] × [0, h] × [0, d·pdm] onto the image.
  full_range = torch.tensor([width, height, depth * pdm],
                            dtype=torch.float32, device=dev)
  spacing = full_range / torch.full((), image_res, dtype=torch.float32,
                                    device=dev)
  dims = torch.tensor([width, height, depth], dtype=torch.float32,
                      device=dev)
  if sub_grid_sampling:
    out_shape = (num_meshes, 2 * depth + 1, 2 * height + 1, 2 * width + 1)
  else:
    out_shape = (num_meshes, depth, height, width)
  numel = int(np.prod(out_shape))
  if numel + 1 >= 2 ** 31:
    raise ValueError(f"a grid of {out_shape} is too large for int32 cell "
                     "indices")

  t_total = triangles.shape[0]
  window = max_bbox_pixels if max_bbox_pixels is not None else image_res + 2
  window = min(window, image_res + 2)
  if chunk_size is None:
    chunk_size = max(1, min(t_total, (1 << 22) // max(window * window, 1)))
  num_chunks = misc.round_up(t_total, chunk_size) // chunk_size

  flat_grid = torch.zeros(numel + 1, dtype=torch.float32, device=dev)
  for i in range(num_chunks):
    sl = slice(i * chunk_size, (i + 1) * chunk_size)
    _rasterize_chunk(
        flat_grid, triangles[sl], tri_mesh_index[sl], tri_valid[sl],
        view2voxel, out_shape=out_shape, spacing=spacing, dims=dims,
        image_res=image_res, window=window,
        conservative=conservative_rasterization,
        sub_grid_s=int(irm) if sub_grid_sampling else 0)
  return flat_grid[:numel].reshape(out_shape)


def voxelize_mesh(triangles,
                  mesh_num_tri,
                  resolution: Tuple[int, int, int],
                  view2voxel,
                  sub_grid_sampling: bool = False,
                  image_resolution_multiplier: float = 4,
                  conservative_rasterization: bool = False,
                  projection_depth_multiplier: int = 1,
                  max_bbox_pixels: Optional[int] = None,
                  device="cuda") -> torch.Tensor:
  """Voxelizes meshes given as one triangle array and a count per mesh.

  Args:
    triangles: float32[total_triangles, 3, 3].
    mesh_num_tri: int sequence [num_meshes]; triangles per mesh, in order.
    resolution: (depth, height, width).
    view2voxel: float32[4, 4] or float32[num_meshes, 4, 4].
    device: where to voxelize; inputs are moved there.

  Returns:
    float32[num_meshes, D, H, W], or the (2D+1, 2H+1, 2W+1) irregular grid
    with sub_grid_sampling.
  """
  device = checked_device(device)
  mesh_num_tri = np.asarray(mesh_num_tri, np.int64)
  num_meshes = int(mesh_num_tri.shape[0])
  tri_mesh_index = torch.from_numpy(misc.dynamic_tile_np(mesh_num_tri)).to(
      device)
  triangles = torch.as_tensor(triangles, dtype=torch.float32, device=device)
  if triangles.shape[0] != int(mesh_num_tri.sum()):
    raise ValueError(f"{triangles.shape[0]} triangles, but mesh_num_tri "
                     f"sums to {int(mesh_num_tri.sum())}")
  view2voxel = torch.as_tensor(view2voxel, dtype=torch.float32,
                               device=device)
  if view2voxel.dim() == 2:
    view2voxel = view2voxel.expand(num_meshes, 4, 4)
  tri_valid = torch.ones(triangles.shape[0], dtype=torch.bool, device=device)
  return voxelize_triangles(
      triangles, tri_mesh_index, view2voxel, tri_valid,
      num_meshes=num_meshes, resolution=tuple(resolution),
      sub_grid_sampling=sub_grid_sampling,
      image_resolution_multiplier=image_resolution_multiplier,
      conservative_rasterization=conservative_rasterization,
      projection_depth_multiplier=projection_depth_multiplier,
      max_bbox_pixels=max_bbox_pixels)


def get_sub_grid_centers(grid: torch.Tensor) -> torch.Tensor:
  """Occupancy at sub-grid centres: [B, 2D+1, 2H+1, 2W+1] → [B, D, H, W],
  the odd-index cells, which hold the centres of the regular grid's
  voxels."""
  return grid[:, 1::2, 1::2, 1::2]
