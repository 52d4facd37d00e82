"""Host-side triangle preparation for the on-device ground truth (numpy).

The port's own copy of the parts of corenet_tpu/data/batching.py that the
blocked rasterizer relies on: longest-edge subdivision (every triangle's
extent capped, so that a small fixed sampling window covers it), the
Morton order of its output, and the power-of-two padding of triangle
counts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# The rasterizer's sampling window in pixels when triangles are subdivided
# (corenet_tpu/eval/pipeline.py:40). A triangle's longest edge is then
# capped at max_edge_view = (VOXELIZE_WINDOW_PIXELS − 4) / irm / m in view
# units, m the grid's extent and irm the image resolution multiplier.
VOXELIZE_WINDOW_PIXELS = 24


def subdivide_triangles(triangles: np.ndarray,
                        max_edge: float) -> np.ndarray:
  """Longest-edge bisection of float32[T, 3, 3] until every edge is
  ≤ max_edge, all offending triangles split at once per round; returns
  the triangles in Morton order of their centroids."""
  tris = triangles.astype(np.float32)
  while True:
    e = np.stack([
        tris[:, 1] - tris[:, 0],
        tris[:, 2] - tris[:, 1],
        tris[:, 0] - tris[:, 2],
    ], axis=1)  # [T, 3 edges, 3]
    lengths = np.linalg.norm(e, axis=2)  # [T, 3]
    too_big = lengths.max(axis=1) > max_edge
    if not too_big.any():
      return tris[_morton_order(tris)] if len(tris) else tris
    keep = tris[~too_big]
    split = tris[too_big]
    which = lengths[too_big].argmax(axis=1)  # the longest edge
    rows = np.arange(len(split))
    a = split[rows, which]
    b = split[rows, (which + 1) % 3]
    c = split[rows, (which + 2) % 3]
    mid = (a + b) / 2
    tris = np.concatenate([keep, np.stack([a, mid, c], axis=1),
                           np.stack([mid, b, c], axis=1)], axis=0)


def _morton_order(tris: np.ndarray) -> np.ndarray:
  """Indices that sort triangles along the Z-curve of their centroids
  (10 bits per axis). The voxelization does not depend on the order."""
  c = tris.mean(axis=1)  # [T, 3]
  lo = c.min(axis=0)
  span = np.maximum(c.max(axis=0) - lo, 1e-9)
  q = np.clip((c - lo) / span * 1023, 0, 1023).astype(np.uint64)
  code = np.zeros(len(tris), np.uint64)
  for b in range(10):
    for a in range(3):
      code |= ((q[:, a] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
          3 * b + a)
  return np.argsort(code, kind="stable")


def _pad_to_bucket(n: int, buckets: Optional[Sequence[int]] = None) -> int:
  """The padded size for n triangles: the first bucket ≥ n (past the last,
  a multiple of it), else the next power of two ≥ 8."""
  if n == 0:
    return 8
  if buckets:
    for b in buckets:
      if n <= b:
        return b
    return -(-n // buckets[-1]) * buckets[-1]
  p = 8
  while p < n:
    p *= 2
  return p
