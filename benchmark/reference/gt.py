"""Plain reference of the training data path and its ground truth: scene
files → view-space triangles → longest-edge subdivision → FG_BG voxel
labels, and the order in which an epoch visits the scenes.

The labels follow the sampling rule of the GL voxelizer of the CoreNet
paper's code: each triangle is sampled on its dominant plane at `irm`
pixels per voxel over a window of 4·irm pixels that starts two pixels
before its lowest coordinate (snapped down to a voxel, clipped to the
image); a sample covers when its three edge functions agree in sign
within 1e-4 of twice the area; its depth is the barycentric
interpolation, floored to a voxel. Covered voxels are set in a dense
grid; then every empty voxel that is not 6-connected through empty
voxels to the grid's boundary is filled. Written densely and without bit
packing, blocks or kernels.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

WINDOW_PIXELS = 24  # the sampling window that subdivision is sized for
UV_CELLS = 4
DEPTH_CELLS = 8
PLANE_AXES = ((1, 2), (2, 0), (0, 1))


def max_edge_view(irm: int, m: int) -> float:
  """The subdivision's longest edge in view units."""
  return (WINDOW_PIXELS - 4) / irm / m


def read_scene(path: str, meshes_dir: str):
  """A scene file → (image uint8 [H, W, 3], camera [4, 4], list of
  (label id, view-space triangles float32 [T, 3, 3]))."""
  with np.load(path, allow_pickle=True) as z:
    labels = [str(v) for v in z["mesh_labels"]]
    names = [str(v) for v in z["mesh_filenames"]]
    view = z["view_transform"].astype(np.float32)
    o2w = z["mesh_object_to_world_transforms"].astype(np.float32)
    camera = z["camera_transform"].astype(np.float32)
    image = np.asarray(z["pbrt_image"][()], np.uint8)
  meshes = []
  for i, (label, name) in enumerate(zip(labels, names)):
    with np.load(os.path.join(meshes_dir, label, name + ".npz")) as mz:
      verts = mz["vertices"].astype(np.float32)
    o2v = view @ o2w[i]
    v = verts.reshape(-1, 3) @ o2v[:3, :3].T + o2v[:3, 3]
    meshes.append((label, v.reshape(verts.shape).astype(np.float32)))
  return image, camera, meshes


def subdivide(tris: np.ndarray, max_edge: float) -> np.ndarray:
  """Longest-edge bisection, every triangle with an edge over `max_edge`
  split at once per round, until none is left."""
  tris = tris.astype(np.float32)
  while True:
    edges = np.stack([tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 1],
                      tris[:, 0] - tris[:, 2]], axis=1)
    lengths = np.linalg.norm(edges, axis=2)
    big = lengths.max(axis=1) > max_edge
    if not big.any():
      return tris
    split = tris[big]
    which = lengths[big].argmax(axis=1)
    rows = np.arange(len(split))
    a = split[rows, which]
    b = split[rows, (which + 1) % 3]
    c = split[rows, (which + 2) % 3]
    mid = (a + b) / 2
    tris = np.concatenate([tris[~big], np.stack([a, mid, c], 1),
                           np.stack([mid, b, c], 1)], axis=0)


def epoch_order(num_scenes: int, epoch: int = 0) -> np.ndarray:
  """The scenes' order in an epoch of a one-dataset pipeline shuffled per
  epoch: the dataset's permutation, then the pipeline's, both seeded
  epoch · 19 + 317."""
  seed = epoch * 19 + 317
  order = np.arange(num_scenes)
  for _ in range(2):
    order = order[np.random.default_rng(seed).permutation(num_scenes)]
  return order


def _edge(pu, pv, au, av, bu, bv):
  return (bu - au) * (pv - av) - (bv - av) * (pu - au)


@torch.no_grad()
def surface_voxels(tris: torch.Tensor, m: int, irm: int,
                   grid_offset: torch.Tensor) -> torch.Tensor:
  """bool [m, m, m] in (z, y, x) order: the voxels that the samples of
  view-space triangles float32 [T, 3, 3] cover, for a grid of extent m
  over the unit cube shifted by grid_offset − 0.5 voxels."""
  dev = tris.device
  grid = torch.zeros(m * m * m, dtype=torch.bool, device=dev)
  wp = UV_CELLS * irm
  image_res = m * irm
  s = torch.full((), m / image_res, dtype=torch.float32, device=dev)
  mat = float(m) * torch.eye(3, device=dev)  # view → voxel, columns
  shift = (grid_offset - 0.5).to(dev)
  for chunk in torch.split(tris, 8192):
    v = (chunk[..., 0:1] * mat[:, 0] + chunk[..., 1:2] * mat[:, 1]
         + chunk[..., 2:3] * mat[:, 2]) + shift
    normal = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], dim=-1)
    a = normal.abs()
    k = torch.where((a[:, 0] > a[:, 1]) & (a[:, 0] > a[:, 2]), 0,
                    torch.where((a[:, 1] > a[:, 0]) & (a[:, 1] > a[:, 2]),
                                1, 2))
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    k_ = k[:, None]
    vu = torch.where(k_ == 0, vy, torch.where(k_ == 1, vz, vx))
    vv = torch.where(k_ == 0, vz, torch.where(k_ == 1, vx, vy))
    vd = torch.where(k_ == 0, vx, torch.where(k_ == 1, vy, vz))

    def start(vmin):
      i0 = torch.floor(vmin / s).to(torch.int32) - 2
      i0 = torch.div(i0, irm, rounding_mode="floor") * irm
      return i0.clamp(0, image_res - wp)

    iu0, iv0 = start(vu.amin(-1)), start(vv.amin(-1))
    ar = torch.arange(wp, dtype=torch.int32, device=dev)
    iu = iu0[:, None] + ar  # [T, WP] pixel columns
    iv = iv0[:, None] + ar
    pu = (iu.to(torch.float32) * s + 0.5 * s)[:, :, None]
    pv = (iv.to(torch.float32) * s + 0.5 * s)[:, None, :]
    u0, u1, u2 = (vu[:, i, None, None] for i in range(3))
    v0, v1, v2 = (vv[:, i, None, None] for i in range(3))
    w0 = _edge(pu, pv, u1, v1, u2, v2)
    w1 = _edge(pu, pv, u2, v2, u0, v0)
    w2 = _edge(pu, pv, u0, v0, u1, v1)
    area2 = w0 + w1 + w2
    eps = 1e-4 * area2.abs()
    cov = (((w0 >= -eps) & (w1 >= -eps) & (w2 >= -eps))
           | ((w0 <= eps) & (w1 <= eps) & (w2 <= eps)))
    nz = area2.abs() > 0
    inv = torch.where(nz, 1.0 / torch.where(nz, area2, 1.0), 0.0)
    depth = ((w0 * inv) * vd[:, 0, None, None]
             + (w1 * inv) * vd[:, 1, None, None]
             + (w2 * inv) * vd[:, 2, None, None])
    cov &= nz & (depth >= 0) & (depth < m)
    cd = torch.floor(depth).to(torch.int32)
    # A triangle keeps the 8 depth cells from its nearest covered one.
    dmin = torch.where(cov, cd, 1 << 20).amin(dim=(-2, -1))
    od = dmin.clamp(0, m - DEPTH_CELLS)[:, None, None]
    cov &= (cd >= od) & (cd < od + DEPTH_CELLS)
    cu = (iu // irm)[:, :, None].expand_as(cd)
    cv = (iv // irm)[:, None, :].expand_as(cd)
    kk = k[:, None, None].expand_as(cd)
    x = torch.where(kk == 0, cd, torch.where(kk == 1, cv, cu))
    y = torch.where(kk == 0, cu, torch.where(kk == 1, cd, cv))
    z = torch.where(kk == 0, cv, torch.where(kk == 1, cu, cd))
    flat = ((z * m + y) * m + x)[cov].long()
    grid[flat] = True
  return grid.view(m, m, m)


@torch.no_grad()
def fill_enclosed(occupied: torch.Tensor) -> torch.Tensor:
  """bool [..., D, H, W]: occupied voxels and the empty ones that no path
  of 6-connected empty voxels joins to the grid's boundary."""
  empty = ~occupied
  outside = torch.zeros_like(empty)
  for axis in (-3, -2, -1):
    idx = torch.arange(empty.shape[axis], device=empty.device)
    edge = (idx == 0) | (idx == empty.shape[axis] - 1)
    shape = [1, 1, 1]
    shape[axis] = -1
    outside |= empty & edge.view(shape)
  while True:
    grown = outside.clone()
    for axis in (-3, -2, -1):
      n = empty.shape[axis]
      grown.narrow(axis, 1, n - 1).__ior__(outside.narrow(axis, 0, n - 1))
      grown.narrow(axis, 0, n - 1).__ior__(outside.narrow(axis, 1, n - 1))
    grown &= empty
    if torch.equal(grown, outside):
      return ~outside
    outside = grown


def fgbg_labels(scene_meshes: Sequence[List[Tuple[str, np.ndarray]]],
                m: int, irm: int, device) -> torch.Tensor:
  """uint8 [B, m, m, m] (z, y, x): 1 where a scene's mesh occupies or
  encloses the voxel, each scene's meshes subdivided for the sampling
  window, grid offsets 0.5."""
  edge = max_edge_view(irm, m)
  offset = torch.full((3,), 0.5, device=device)
  out = []
  for meshes in scene_meshes:
    occ = torch.zeros((m, m, m), dtype=torch.bool, device=device)
    for _, tris in meshes:
      t = torch.from_numpy(subdivide(tris, edge)).to(device)
      occ |= fill_enclosed(surface_voxels(t, m, irm, offset))
    out.append(occ)
  return torch.stack(out).to(torch.uint8)
