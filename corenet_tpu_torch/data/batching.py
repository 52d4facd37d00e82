"""Host-side batch assembly → padded, static-shape buffers (numpy).

The port's own copy of corenet_tpu/data/batching.py, a near-copy with its
imports renamed; `host_voxelize` is not here (it needs the C++ ops of
corenet_tpu/cc/, which are not ported yet). Everything is [batch, ...] with
fixed padded sizes, so a batch feeds the step (which voxelizes the ground
truth on its device; train/gt.py) without any ragged structure.

* Mesh vertices are transformed object → view on the host (w2v @ o2w per
  mesh): tiny matmuls.
* Triangle buffers are padded to size buckets (powers of two by default)
  to bound the number of distinct shapes.
* Optional longest-edge subdivision caps every triangle's extent, so that
  a small fixed sampling window (max_bbox_pixels) covers it; its output is
  in Morton order, which the blocked rasterizer's merges rely on.
* grid_offset defaults to 0.5 (voxel centres); training can randomize it
  per scene.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from corenet_tpu_torch.data.dataset import DatasetElement
from corenet_tpu_torch.utils import misc

# The rasterizer's sampling window in pixels when triangles are subdivided
# (corenet_tpu/eval/pipeline.py:40). A triangle's longest edge is then
# capped at max_edge_view = (VOXELIZE_WINDOW_PIXELS − 4) / irm / m in view
# units, m the grid's extent and irm the image resolution multiplier.
VOXELIZE_WINDOW_PIXELS = 24


@dataclasses.dataclass
class HostBatch:
  """Device-ready host batch (numpy, channel-last)."""
  image: np.ndarray          # uint8[B, H, W, 3]
  camera: np.ndarray         # float32[B, 4, 4]
  view_transform: np.ndarray  # float32[B, 4, 4]
  triangles: np.ndarray      # float32[B, T, 3, 3] (view space)
  tri_mesh_slot: np.ndarray  # int32[B, T]
  tri_valid: np.ndarray      # bool[B, T]
  mesh_labels: np.ndarray    # int32[B, M] semantic class ints; 0 = padding
  mesh_valid: np.ndarray     # bool[B, M]
  grid_offset: np.ndarray    # float32[B, 3]
  scene_ids: List[str]
  # Optional precomputed step inputs (e.g. host-GT 'grid'/'v2x'), merged
  # into step_inputs() output.
  extra: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

  def step_inputs(self, task_type: str) -> Dict[str, np.ndarray]:
    """The arrays fed to the train/eval step. Voxel content values per
    task: FG_BG → 1, SEMANTIC → class, MESH_INDEX → slot + 1."""
    if task_type == "FG_BG":
      labels = self.mesh_valid.astype(np.int32)
    elif task_type == "SEMANTIC":
      labels = self.mesh_labels * self.mesh_valid
    elif task_type == "MESH_INDEX":
      labels = ((np.arange(self.mesh_labels.shape[1], dtype=np.int32)[None]
                 + 1) * self.mesh_valid)
    else:
      raise ValueError(task_type)
    return {
        "image": self.image,
        "camera": self.camera,
        "triangles": self.triangles,
        "tri_mesh_slot": self.tri_mesh_slot,
        "tri_valid": self.tri_valid,
        "mesh_labels": labels,
        "grid_offset": self.grid_offset,
        **self.extra,
    }


def _transform_mesh_np(vertices: np.ndarray, matrix: np.ndarray) -> np.ndarray:
  """Affine-transforms float32[T, 3, 3] vertices by float32[4, 4]."""
  v = vertices.reshape(-1, 3)
  v = v @ matrix[:3, :3].T + matrix[:3, 3]
  return v.reshape(vertices.shape).astype(np.float32)


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
    return misc.round_up(n, buckets[-1])
  p = 8
  while p < n:
    p *= 2
  return p


def batch(elements: Sequence[DatasetElement],
          max_edge_view: Optional[float] = None,
          triangle_buckets: Optional[Sequence[int]] = None,
          max_meshes: Optional[int] = None,
          grid_offsets: Optional[np.ndarray] = None) -> HostBatch:
  """Batches dataset elements into padded device-ready buffers.

  Args:
    elements: The scenes to batch.
    max_edge_view: If set, subdivide triangles (in view space) so no edge
      exceeds this length. With the world→voxel transform scale(m), a
      voxel-space cap E maps to max_edge_view = E / m.
    triangle_buckets: Pad the per-scene triangle count to the first bucket
      that fits (default: powers of two).
    max_meshes: Pad/assert the per-scene mesh-slot count.
    grid_offsets: Optional float32[B, 3] sampling offsets (default 0.5).
  """
  b = len(elements)
  per_scene_tris: List[np.ndarray] = []
  per_scene_slot: List[np.ndarray] = []
  num_meshes = []
  for ex in elements:
    w2v = ex.view_transform
    tris, slots = [], []
    offset = 0
    for mesh_idx, num_tri in enumerate(np.asarray(ex.mesh_num_tri)):
      num_tri = int(num_tri)
      mesh = ex.mesh_vertices[offset:offset + num_tri]
      offset += num_tri
      o2v = w2v @ ex.o2w_transforms[mesh_idx]
      mesh = _transform_mesh_np(mesh, o2v)
      if max_edge_view is not None:
        mesh = subdivide_triangles(mesh, max_edge_view)
      tris.append(mesh)
      slots.append(np.full([mesh.shape[0]], mesh_idx, np.int32))
    num_meshes.append(len(tris))
    per_scene_tris.append(
        np.concatenate(tris, 0) if tris else np.zeros([0, 3, 3], np.float32))
    per_scene_slot.append(
        np.concatenate(slots, 0) if slots else np.zeros([0], np.int32))

  t_max = _pad_to_bucket(max(t.shape[0] for t in per_scene_tris),
                         triangle_buckets)
  m_max = max_meshes or max(max(num_meshes), 1)
  assert max(num_meshes) <= m_max

  triangles = np.zeros([b, t_max, 3, 3], np.float32)
  tri_mesh_slot = np.zeros([b, t_max], np.int32)
  tri_valid = np.zeros([b, t_max], bool)
  mesh_labels = np.zeros([b, m_max], np.int32)
  mesh_valid = np.zeros([b, m_max], bool)
  for i, (tris, slots) in enumerate(zip(per_scene_tris, per_scene_slot)):
    n = tris.shape[0]
    triangles[i, :n] = tris
    tri_mesh_slot[i, :n] = slots
    tri_valid[i, :n] = True
    labels = np.asarray(elements[i].mesh_labels, np.int32)
    mesh_labels[i, :len(labels)] = labels
    mesh_valid[i, :num_meshes[i]] = True

  if grid_offsets is None:
    grid_offsets = np.full([b, 3], 0.5, np.float32)

  return HostBatch(
      image=np.stack([e.input_image for e in elements], 0),
      camera=np.stack([e.camera_transform for e in elements], 0),
      view_transform=np.stack([e.view_transform for e in elements], 0),
      triangles=triangles,
      tri_mesh_slot=tri_mesh_slot,
      tri_valid=tri_valid,
      mesh_labels=mesh_labels,
      mesh_valid=mesh_valid,
      grid_offset=np.asarray(grid_offsets, np.float32),
      scene_ids=[e.scene_id for e in elements])
