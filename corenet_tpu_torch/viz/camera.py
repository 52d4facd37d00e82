"""Cameras for qualitative rendering (numpy, host side).

A near-copy of corenet_tpu/viz/camera.py: four tetrahedron-vertex look-at
cameras framing a 3D box, a frontal camera, and a default object-framing
camera; all right-handed with a perspective projection whose Y axis is
flipped so image rows run top-down.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from corenet_tpu_torch import geom

# Vertices of a regular tetrahedron (unit directions from the center).
_TETRA_DIRS = np.array([
    [1, 1, 1],
    [1, -1, -1],
    [-1, 1, -1],
    [-1, -1, 1],
], np.float32) / math.sqrt(3.0)


def perspective_flipped_y(fov_y: float, aspect: float, z_near: float,
                          z_far: float) -> np.ndarray:
  """Right-handed perspective with Y flipped (rows grow downward)."""
  p = geom.perspective_rh(fov_y, aspect, z_near, z_far)
  return np.diag([1.0, -1.0, 1.0, 1.0]).astype(np.float32) @ p


def _framing(box_min: np.ndarray, box_max: np.ndarray,
             direction: np.ndarray, up=(0.0, 1.0, 0.0),
             distance_factor: float = 2.6,
             fov_slack: float = 1.15) -> np.ndarray:
  """A camera looking at the box center from `direction`, framed so the
  whole box is visible."""
  box_min = np.asarray(box_min, np.float32)
  box_max = np.asarray(box_max, np.float32)
  center = (box_min + box_max) / 2
  radius = float(np.linalg.norm(box_max - box_min) / 2) or 1.0
  d = np.asarray(direction, np.float32)
  d = d / (np.linalg.norm(d) or 1.0)
  eye = center + d * radius * distance_factor
  # Avoid a degenerate up vector.
  up = np.asarray(up, np.float32)
  if abs(float(np.dot(d, up))) > 0.99:
    up = np.array([0.0, 0.0, 1.0], np.float32)
  view = geom.look_at_rh(eye, center, up)
  fov = 2.0 * math.asin(min(1.0, 1.0 / distance_factor)) * fov_slack
  proj = perspective_flipped_y(fov, 1.0, radius * 0.05, radius * 10.0)
  return proj @ view


def tetrahedron_cameras(box_min, box_max) -> List[np.ndarray]:
  """Four cameras at the vertices of a tetrahedron around the box."""
  return [_framing(box_min, box_max, d) for d in _TETRA_DIRS]


def frontal_camera(box_min, box_max) -> np.ndarray:
  """Camera looking along -z at the box (the render-view direction)."""
  return _framing(box_min, box_max, np.array([0.0, 0.0, 1.0], np.float32))


def default_camera(box_min, box_max) -> np.ndarray:
  """Slightly elevated three-quarter view framing the box."""
  return _framing(box_min, box_max, np.array([0.6, 0.45, 1.0], np.float32))
