"""4x4 homogeneous transform algebra, in numpy on the host.

Counterpart of corenet_tpu/geom/transforms.py (jnp there); in the port only
the host uses it (viz/camera.py, viz/scene_renderer.py), so it is numpy.
Row-major 4x4 matrices act on column vectors and compose left-to-right as
``chain([A, B]) == A @ B`` (B is applied to points first). Functions take
sequences or arrays and return float32 arrays; the batched variants
broadcast over leading dimensions.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _as_f32(v) -> np.ndarray:
  return np.asarray(v, dtype=np.float32)


def scale(v) -> np.ndarray:
  """Scale matrix from a scale vector float32[N] → float32[N+1, N+1]."""
  v = _as_f32(v)
  assert v.ndim == 1
  return np.diag(np.concatenate([v, np.ones([1], np.float32)]))


def translate(v) -> np.ndarray:
  """Translation matrix float32[..., N] → float32[..., N+1, N+1]."""
  v = _as_f32(v)
  assert v.ndim >= 1
  n = v.shape[-1]
  eye = np.eye(n + 1, dtype=np.float32)
  eye = np.broadcast_to(eye, v.shape[:-1] + (n + 1, n + 1))
  # Place v into the last column of the top N rows.
  col = np.concatenate(
      [v, np.zeros(v.shape[:-1] + (1,), np.float32)], axis=-1)
  pad = np.zeros(v.shape[:-1] + (n + 1, n), np.float32)
  add = np.concatenate([pad, col[..., None]], axis=-1)
  return eye + add


def rotate(angle, axis) -> np.ndarray:
  """Axis-angle rotation → float32[4, 4].

  Uses the standard axis–angle conversion (Wikipedia: "Rotation matrix",
  conversion from and to axis-angle), identical to the reference
  (transformations.py:61-105).
  """
  axis = _as_f32(axis)
  angle = _as_f32(angle)
  assert axis.shape == (3,)
  assert angle.shape == ()

  axis = axis / np.linalg.norm(axis)
  s = np.sin(angle)
  c = np.cos(angle)
  x, y, z = axis[0], axis[1], axis[2]
  omc = 1.0 - c
  m = np.array([
      [c + x * x * omc, x * y * omc - z * s, x * z * omc + y * s, 0.0],
      [y * x * omc + z * s, c + y * y * omc, y * z * omc - x * s, 0.0],
      [z * x * omc - y * s, z * y * omc + x * s, c + z * z * omc, 0.0],
      [0.0, 0.0, 0.0, 1.0],
  ], dtype=np.float32)
  return m


def transform_points_homogeneous(points, matrix, w: float) -> np.ndarray:
  """Transforms points float32[..., P, 3] by matrices float32[..., 4, 4].

  Returns homogeneous points float32[..., P, 4]. ``w`` is 1 for affine
  points, 0 for vectors.
  """
  points = _as_f32(points)
  matrix = _as_f32(matrix)
  assert points.shape[-1] == 3
  assert matrix.shape[-2:] == (4, 4)
  assert points.shape[:-2] == matrix.shape[:-2]

  ones = np.full(points.shape[:-1] + (1,), w, np.float32)
  pts4 = np.concatenate([points, ones], axis=-1)
  # result[..., p, i] = sum_j matrix[..., i, j] * pts4[..., p, j]
  return np.einsum("...ij,...pj->...pi", matrix, pts4)


def transform_points(points, matrix) -> np.ndarray:
  """Affine point transform with perspective division, float32[..., P, 3]."""
  r = transform_points_homogeneous(points, matrix, w=1)
  return r[..., :3] / r[..., 3:4]


def transform_mesh(mesh, matrix, vertices_are_points: bool = True
                   ) -> np.ndarray:
  """Transforms triangle vertices float32[..., T, 3, 3] by float32[..., 4, 4]."""
  mesh = _as_f32(mesh)
  matrix = _as_f32(matrix)
  assert mesh.shape[-2:] == (3, 3)
  assert matrix.shape[-2:] == (4, 4)
  assert mesh.shape[:-3] == matrix.shape[:-2]

  original_shape = mesh.shape
  flat = mesh.reshape(mesh.shape[:-3] + (-1, 3))
  w = 1 if vertices_are_points else 0
  out = transform_points_homogeneous(flat, matrix, w=w)
  if vertices_are_points:
    out = out[..., :3] / out[..., 3:4]
  else:
    out = out[..., :3]
  return out.reshape(original_shape)


def _normalize(v: np.ndarray) -> np.ndarray:
  return v / np.linalg.norm(v)


def look_at_lh(eye, center, up) -> np.ndarray:
  """Left-handed 4x4 look-at camera matrix (transformations.py:179-198)."""
  eye, center, up = _as_f32(eye), _as_f32(center), _as_f32(up)
  f = _normalize(center - eye)
  s = _normalize(np.cross(up, f))
  u = np.cross(f, s)
  return np.array([
      [s[0], s[1], s[2], -np.dot(s, eye)],
      [u[0], u[1], u[2], -np.dot(u, eye)],
      [f[0], f[1], f[2], -np.dot(f, eye)],
      [0, 0, 0, 1],
  ], dtype=np.float32)


def look_at_rh(eye, center, up) -> np.ndarray:
  """Right-handed 4x4 look-at camera matrix (transformations.py:201-220)."""
  eye, center, up = _as_f32(eye), _as_f32(center), _as_f32(up)
  f = _normalize(center - eye)
  s = _normalize(np.cross(f, up))
  u = np.cross(s, f)
  return np.array([
      [s[0], s[1], s[2], -np.dot(s, eye)],
      [u[0], u[1], u[2], -np.dot(u, eye)],
      [-f[0], -f[1], -f[2], np.dot(f, eye)],
      [0, 0, 0, 1],
  ], dtype=np.float32)


def perspective_lh(fov_y, aspect, z_near, z_far) -> np.ndarray:
  fov_y, aspect = _as_f32(fov_y), _as_f32(aspect)
  z_near, z_far = _as_f32(z_near), _as_f32(z_far)
  t = np.tan(fov_y / 2)
  zero = np.zeros((), np.float32)
  one = np.ones((), np.float32)
  return np.array([
      [1.0 / (aspect * t), 0, 0, 0],
      [0, 1.0 / t, 0, 0],
      [0, 0, (z_far + z_near) / (z_far - z_near),
       -(2 * z_far * z_near) / (z_far - z_near)],
      [zero, zero, one, zero],
  ], dtype=np.float32)


def perspective_rh(fov_y, aspect, z_near, z_far) -> np.ndarray:
  fov_y, aspect = _as_f32(fov_y), _as_f32(aspect)
  z_near, z_far = _as_f32(z_near), _as_f32(z_far)
  t = np.tan(fov_y / 2)
  return np.array([
      [1.0 / (aspect * t), 0, 0, 0],
      [0, 1.0 / t, 0, 0],
      [0, 0, -(z_far + z_near) / (z_far - z_near),
       -(2 * z_far * z_near) / (z_far - z_near)],
      [0, 0, -1, 0],
  ], dtype=np.float32)


def ortho_lh(left, right, bottom, top, z_near, z_far) -> np.ndarray:
  left, right = _as_f32(left), _as_f32(right)
  bottom, top = _as_f32(bottom), _as_f32(top)
  z_near, z_far = _as_f32(z_near), _as_f32(z_far)
  return np.array([
      [2 / (right - left), 0, 0, -(right + left) / (right - left)],
      [0, 2 / (top - bottom), 0, -(top + bottom) / (top - bottom)],
      [0, 0, 2 / (z_far - z_near), -(z_far + z_near) / (z_far - z_near)],
      [0, 0, 0, 1],
  ], dtype=np.float32)


def chain(transforms: Sequence[np.ndarray]) -> np.ndarray:
  """Composes transforms left-to-right: chain([A, B, C]) = A @ B @ C."""
  assert len(transforms) > 0
  result = _as_f32(transforms[0])
  for m in transforms[1:]:
    result = result @ _as_f32(m)
  return result
