"""Software renderers for qualitative results, as torch tensor code on the
caller's device.

Counterpart of corenet_tpu/viz/renderer.py, with its float expressions
kept one for one (so pixels agree with the JAX package's except where an
edge or a depth test ties within rounding):

* `render_mesh`: a chunked z-buffered triangle rasterizer. Per chunk of
  triangles the three edge functions are dense [chunk, H, W] affine maps,
  depths interpolate barycentrically, and a running (z-buffer, colour)
  pair folds the chunks. Eye-light diffuse shading (|n·l| + ambient);
  optional perspective-correct, bilinearly sampled textures.
* `render_voxel_grid`: an Amanatides–Woo DDA raycaster over a label grid:
  every pixel's ray marches voxel by voxel in lockstep (w + h + d + 3
  masked steps), shading the first non-transparent voxel by its entry
  face.

Cameras are world → clip 4×4 matrices (viz/camera.py); inputs are numpy
arrays or tensors, images come back as numpy uint8[H, W, 3]. The work runs
on `device`, which defaults to the card and raises without one unless the
caller asks for the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from corenet_tpu_torch.utils.device import checked_device
from corenet_tpu_torch.viz.colors import DEFAULT_COLOR_PALETTE

_BG = (1.0, 1.0, 1.0)  # white background
_AMBIENT = 0.36
_DIFFUSE = 0.64
_FACE_SHADE = (0.92, 0.78, 0.62)  # per entry axis (x, y, z)


def _f32(x, device) -> torch.Tensor:
  return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _to_uint8(rgb: torch.Tensor) -> np.ndarray:
  return (rgb * 255).to(torch.uint8).cpu().numpy()


def _rasterize_chunk(tri, col, valid, camera, xs, ys, zbuf, color,
                     textured=None):
  """Folds one chunk of triangles into (zbuf [H, W], color [H, W, 3])."""
  h, w = zbuf.shape
  # World-space normal for shading (double-sided).
  n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
  n = n / torch.clamp_min(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                          1e-12)

  # Project to clip space.
  hom = torch.einsum("ij,ctj->cti", camera[:3, :3], tri) + camera[:3, 3]
  ww = torch.einsum("j,ctj->ct", camera[3, :3], tri) + camera[3, 3]
  in_front = torch.all(ww > 1e-6, dim=1)
  ww = torch.where(ww == 0, 1e-6, ww)
  ndc = hom / ww[..., None]
  px = (ndc[..., 0] * 0.5 + 0.5) * w  # [C, 3]
  py = (ndc[..., 1] * 0.5 + 0.5) * h
  pz = ndc[..., 2]

  def edge(ax, ay, bx, by):
    # e(x, y) = (bx-ax)(y-ay) - (by-ay)(x-ax) as affine coefficients.
    a = -(by - ay)
    b = (bx - ax)
    c = (by - ay) * ax - (bx - ax) * ay
    return (a[:, None, None] * xs[None] + b[:, None, None] * ys[None] +
            c[:, None, None])

  e0 = edge(px[:, 1], py[:, 1], px[:, 2], py[:, 2])
  e1 = edge(px[:, 2], py[:, 2], px[:, 0], py[:, 0])
  e2 = edge(px[:, 0], py[:, 0], px[:, 1], py[:, 1])
  area = e0 + e1 + e2  # [C, H, W], constant per triangle
  pos = (e0 >= 0) & (e1 >= 0) & (e2 >= 0)
  neg = (e0 <= 0) & (e1 <= 0) & (e2 <= 0)
  nz = torch.abs(area) > 1e-12
  cover = (pos | neg) & nz & valid[:, None, None] & in_front[:, None, None]

  inv_area = torch.where(nz, 1.0 / torch.where(nz, area, 1.0), 0.0)
  depth = (e0 * pz[:, 0, None, None] + e1 * pz[:, 1, None, None] +
           e2 * pz[:, 2, None, None]) * inv_area
  depth = torch.where(cover & (depth > -1.0) & (depth < 1.0), depth,
                      torch.inf)

  best = torch.argmin(depth, dim=0)  # [H, W]; the first on ties

  def at_best(e):  # [C, H, W] → [H, W]
    return torch.gather(e, 0, best[None])[0]

  best_z = at_best(depth)

  # Eye-light diffuse shading per triangle.
  eye_dir = camera[2, :3] / torch.clamp_min(
      torch.linalg.vector_norm(camera[2, :3]), 1e-12)
  lum = _AMBIENT + _DIFFUSE * torch.abs(n @ eye_dir)

  base = col[best]  # [H, W, 3]
  if textured is not None:
    # Perspective-correct UV at the winning triangle: interpolate
    # (u/w, v/w, 1/w) with the screen-space barycentrics of `best`, then
    # divide.
    uvs, tex, textures = textured
    b0, b1, b2 = at_best(e0), at_best(e1), at_best(e2)
    area_b = at_best(area)
    inv_area_b = torch.where(torch.abs(area_b) > 1e-12, 1.0 / area_b, 0.0)
    b0, b1, b2 = b0 * inv_area_b, b1 * inv_area_b, b2 * inv_area_b
    uv_b = uvs[best]                          # [H, W, 3, 2]
    w_b = torch.clamp_min(ww[best], 1e-6)     # [H, W, 3]
    inv_w = (b0 / w_b[..., 0] + b1 / w_b[..., 1] + b2 / w_b[..., 2])
    num = (b0[..., None] * uv_b[..., 0, :] / w_b[..., 0, None] +
           b1[..., None] * uv_b[..., 1, :] / w_b[..., 1, None] +
           b2[..., None] * uv_b[..., 2, :] / w_b[..., 2, None])
    uv = num / torch.where(torch.abs(inv_w[..., None]) > 1e-12,
                           inv_w[..., None], 1.0)
    # Bilinear sample from the (Y-flipped at load) texture array.
    th, tw = textures.shape[1], textures.shape[2]
    fx = uv[..., 0] * tw - 0.5
    fy = uv[..., 1] * th - 0.5
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]
    layer = torch.clamp(tex[best], 0, textures.shape[0] - 1).long()

    def fetch(yy, xx):
      yy = torch.clamp(yy, 0, th - 1).long()
      xx = torch.clamp(xx, 0, tw - 1).long()
      return textures[layer, yy, xx].to(torch.float32) / 255.0

    texel = ((1 - ay) * ((1 - ax) * fetch(y0, x0) + ax * fetch(y0, x0 + 1))
             + ay * ((1 - ax) * fetch(y0 + 1, x0)
                     + ax * fetch(y0 + 1, x0 + 1)))
    base = torch.where((tex[best] >= 0)[..., None], texel, base)
  best_color = torch.clamp(base * lum[best][..., None], 0.0, 1.0)

  closer = best_z < zbuf
  zbuf = torch.where(closer, best_z, zbuf)
  color = torch.where(closer[..., None], best_color, color)
  return zbuf, color


def render_mesh(triangles, tri_colors, camera,
                image_size: Tuple[int, int] = (256, 256),
                chunk: int = 512,
                tri_uvs=None, tri_tex=None, textures=None,
                device="cuda") -> np.ndarray:
  """Renders triangles with per-triangle colors and optional textures.

  Args:
    triangles: float32[T, 3, 3] world-space vertices.
    tri_colors: float32[T, 3] RGB in [0, 1].
    camera: float32[4, 4] world → clip.
    chunk: triangles per rasterizer pass; memory grows with chunk · H · W.
    tri_uvs: optional float32[T, 3, 2] per-vertex texcoords.
    tri_tex: optional int32[T] texture layer per triangle; -1 = use
      tri_colors.
    textures: optional uint8[K, TH, TW, 3] texture array (Y-flipped at
      load, see scene_renderer.load_textures).
    device: where the rasterizer runs.
  Returns: uint8[H, W, 3].
  """
  device = checked_device(device)
  t = triangles.shape[0]
  if t == 0:
    return np.full(tuple(image_size) + (3,), 255, np.uint8)
  # The triangle count padded to a power of two, as the JAX package pads it
  # (there, to bound the distinct compiled shapes).
  bucket = 1 << max(t - 1, 7).bit_length()
  chunk = min(chunk, bucket)
  tris = torch.zeros((bucket, 3, 3), dtype=torch.float32, device=device)
  tris[:t] = _f32(triangles, device)
  cols = torch.zeros((bucket, 3), dtype=torch.float32, device=device)
  cols[:t] = _f32(tri_colors, device)
  valid = torch.arange(bucket, device=device) < t
  textured = None
  if textures is not None and tri_uvs is not None:
    uvs = torch.zeros((bucket, 3, 2), dtype=torch.float32, device=device)
    uvs[:t] = _f32(tri_uvs, device)
    tex = torch.full((bucket,), -1, dtype=torch.int32, device=device)
    if tri_tex is None:
      tex[:t] = 0
    else:
      tex[:t] = torch.as_tensor(np.asarray(tri_tex, np.int32), device=device)
    textured = (uvs, tex, torch.as_tensor(np.asarray(textures, np.uint8),
                                          device=device))
  camera = _f32(camera, device)
  h, w = image_size
  ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5)[:, None]
  xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5)[None, :]
  zbuf = torch.full((h, w), torch.inf, dtype=torch.float32, device=device)
  color = torch.tensor(_BG, dtype=torch.float32, device=device).expand(
      h, w, 3)
  for i in range(0, bucket, chunk):
    part = slice(i, i + chunk)
    zbuf, color = _rasterize_chunk(
        tris[part], cols[part], valid[part], camera, xs, ys, zbuf, color,
        None if textured is None else (
            textured[0][part], textured[1][part], textured[2]))
  return _to_uint8(torch.clamp(color, 0, 1))


def _render_voxels(grid, palette, camera, grid_to_world,
                   image_size: Tuple[int, int]) -> torch.Tensor:
  h, w = image_size
  d_, h_, w_ = grid.shape
  device = grid.device
  dims = torch.tensor([w_, h_, d_], dtype=torch.float32, device=device)

  # Rays in grid space: unproject pixel centers at near/far NDC planes
  # through inv(camera @ grid_to_world).
  m = camera @ grid_to_world
  inv = torch.linalg.inv(m)
  ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h * 2 - 1
  xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w * 2 - 1
  gy, gx = torch.meshgrid(ys, xs, indexing="ij")

  def unproject(z):
    p = torch.stack([gx, gy, torch.full_like(gx, z), torch.ones_like(gx)],
                    -1)
    q = p @ inv.T
    return q[..., :3] / q[..., 3:4]

  p0 = unproject(-0.9999)
  p1 = unproject(0.9999)
  dirs = p1 - p0
  dirs = dirs / torch.clamp_min(
      torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), 1e-12)

  # Slab test against the grid AABB [0, dims].
  inv_dir = 1.0 / torch.where(torch.abs(dirs) < 1e-9,
                              torch.where(dirs >= 0, 1e-9, -1e-9), dirs)
  t0 = (0.0 - p0) * inv_dir
  t1 = (dims - p0) * inv_dir
  t_near = torch.minimum(t0, t1)
  t_enter = torch.amax(t_near, dim=-1)
  t_exit = torch.amin(torch.maximum(t0, t1), dim=-1)
  t_enter = torch.clamp_min(t_enter, 0.0)
  hit_box = t_enter < t_exit

  eps = 1e-4
  start = p0 + dirs * (t_enter + eps)[..., None]
  upper = torch.tensor([w_ - 1, h_ - 1, d_ - 1], device=device)
  iv = torch.minimum(torch.clamp_min(torch.floor(start).long(), 0), upper)
  step = torch.where(dirs >= 0, 1, -1)
  next_bound = iv.to(torch.float32) + (step > 0)
  tmax = (next_bound - p0) * inv_dir
  tdelta = torch.abs(inv_dir)

  label = torch.zeros((h, w), dtype=grid.dtype, device=device)
  # The entry axis (0 = x, 1 = y, 2 = z) of rays that hit the box.
  face = torch.argmax((t_near == t_enter[..., None]).to(torch.int32), dim=-1)
  active = hit_box

  for _ in range(w_ + h_ + d_ + 3):
    x, y, z = iv[..., 0], iv[..., 1], iv[..., 2]
    inb = ((x >= 0) & (x < w_) & (y >= 0) & (y < h_) & (z >= 0) & (z < d_))
    lbl = grid[z.clamp(0, d_ - 1), y.clamp(0, h_ - 1), x.clamp(0, w_ - 1)]
    lbl = torch.where(inb, lbl, 0)
    hit = active & inb & (lbl > 0)
    label = torch.where(hit, lbl, label)
    active = active & ~hit & inb
    axis = torch.argmin(tmax, dim=-1)  # the next crossing's axis
    onehot = F.one_hot(axis, 3)
    face = torch.where(active, axis, face)
    iv = iv + onehot * step * active[..., None]
    tmax = tmax + onehot * tdelta * active[..., None]

  lum = torch.tensor(_FACE_SHADE, dtype=torch.float32, device=device)[face]
  col = palette[torch.clamp(label, 0, palette.shape[0] - 1).long()]
  visible = (label > 0) & (col[..., 0] >= 0)
  bg = torch.tensor(_BG, dtype=torch.float32, device=device)
  return torch.where(visible[..., None],
                     torch.clamp(col, 0, 1) * lum[..., None], bg)


def render_voxel_grid(grid,
                      camera: Optional[np.ndarray] = None,
                      palette: Optional[np.ndarray] = None,
                      grid_to_world: Optional[np.ndarray] = None,
                      image_size: Tuple[int, int] = (256, 256),
                      device="cuda") -> np.ndarray:
  """Renders a labeled voxel grid int[D, H, W] by raycasting on `device`.

  A voxel with label L > 0 renders with palette[L] (palette entries with a
  negative first component are transparent). The default camera frames the
  grid box.
  """
  device = checked_device(device)
  grid = torch.as_tensor(grid, device=device).to(torch.int32)
  d_, h_, w_ = grid.shape
  if grid_to_world is None:
    grid_to_world = np.eye(4, dtype=np.float32)
  if camera is None:
    from corenet_tpu_torch.viz import camera as camera_util
    box = np.asarray(grid_to_world[:3, :3] @ [w_, h_, d_] +
                     grid_to_world[:3, 3])
    camera = camera_util.default_camera(
        np.minimum(grid_to_world[:3, 3], box), np.maximum(
            grid_to_world[:3, 3], box))
  if palette is None:
    palette = DEFAULT_COLOR_PALETTE
  return _to_uint8(_render_voxels(
      grid, _f32(palette, device), _f32(camera, device),
      _f32(grid_to_world, device), tuple(image_size)))
