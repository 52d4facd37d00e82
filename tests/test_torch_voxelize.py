"""The port's general rasterizer (corenet_tpu_torch/voxel/voxelize.py) and
the general ground-truth path built on it (train/gt.py) against the JAX
package's, on the CPU, bit for bit.

Meshes: a cube shell in slot 0 and a seeded closed sphere in slot 1, each
with its own view → voxel matrix (a rotation with a scale; an anisotropic
scale with a shift), one invalid and one zero-area triangle among them.
The port computes every float32 expression of the JAX function operation
for operation, so the grids are equal wherever no sample lies exactly on
a decision boundary (an edge through a pixel centre, a face on a
sub-sample boundary): there XLA's CPU code and eager PyTorch may round a
product-plus-sum differently. The meshes here are in general position
(shifted by odd fractions of a voxel), and the tolerance is 0 voxels.
"""

import jax.numpy as jnp
import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu.train import gt as jax_gt
from corenet_tpu.voxel import voxelize as jax_voxelize
from corenet_tpu_torch.data import batching
from corenet_tpu_torch.train import gt
from corenet_tpu_torch.voxel import voxelize
from helpers import cube_mesh
from test_torch_raster_fast import _scenes, _sphere

torch.set_num_threads(2)

SHIFT = np.array([0.0113, 0.0071, 0.0057], np.float32)


def _rotation(angle):
  c, s = np.cos(angle), np.sin(angle)
  return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                  np.float32)


def _meshes(m, max_edge=None):
  """(triangles, mesh index, matrices, valid) of the two meshes at grid
  extent m; with max_edge the triangles are subdivided."""
  rng = np.random.default_rng(m)
  cube = cube_mesh(0.3, 0.7) + SHIFT
  sphere = _sphere(rng, np.array([0.5, 0.45, 0.55]), 0.2)
  if max_edge is not None:
    cube = batching.subdivide_triangles(cube, max_edge)
    sphere = batching.subdivide_triangles(sphere, max_edge)
  triangles = np.concatenate([cube, sphere]).astype(np.float32)
  index = np.concatenate([np.zeros(len(cube), np.int32),
                          np.ones(len(sphere), np.int32)])
  valid = np.ones(len(triangles), bool)
  valid[5] = False
  triangles[len(cube) + 8] = triangles[len(cube) + 8][[0, 0, 1]]  # no area
  scale = np.diag([m, m, m, 1.0]).astype(np.float32)
  around = np.eye(4, dtype=np.float32)
  around[:3, 3] = 0.5
  back = np.eye(4, dtype=np.float32)
  back[:3, 3] = -0.5
  mats = np.stack([
      scale @ around @ _rotation(0.3) @ back,
      np.diag([0.9 * m, 0.95 * m, m, 1.0]).astype(np.float32)])
  mats[1, :3, 3] = [0.3, -0.2, 0.1]
  return triangles, index, mats.astype(np.float32), valid


CASES = {
    "plain": ((16, 16, 16), {}),
    "sub_grid": ((16, 16, 16), dict(sub_grid_sampling=True,
                                    image_resolution_multiplier=5)),
    "conservative": ((16, 16, 16), dict(conservative_rasterization=True)),
    "depth_multiplier_2": ((16, 16, 16),
                           dict(projection_depth_multiplier=2)),
    "non_cubic": ((16, 32, 24), {}),
    "non_cubic_conservative_sub_grid": (
        (16, 32, 24), dict(conservative_rasterization=True,
                           sub_grid_sampling=True,
                           image_resolution_multiplier=3)),
    "chunks_of_7": ((16, 16, 16), dict(chunk_size=7)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_voxelize_triangles_matches_jax(case):
  resolution, kwargs = CASES[case]
  triangles, index, mats, valid = _meshes(max(resolution))
  want = np.asarray(jax_voxelize.voxelize_triangles(
      *map(jnp.asarray, (triangles, index, mats, valid)), num_meshes=2,
      resolution=resolution, **kwargs))
  got = voxelize.voxelize_triangles(
      *map(torch.from_numpy, (triangles, index, mats, valid)), num_meshes=2,
      resolution=resolution, **kwargs)
  assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
  tt.assert_array_equal(got.numpy(), want)
  # Both meshes left a shell, of ones.
  assert set(np.unique(want)) == {0.0, 1.0}
  assert want[0].sum() > 100 and want[1].sum() > 100


@pytest.mark.parametrize("window", [None, 24])
def test_voxelize_subdivided_triangles_matches_jax(window):
  """Triangles subdivided to the window contract: the full window and the
  24-pixel window give the JAX grid, and each other's."""
  m, irm = 32, 8
  triangles, index, mats, valid = _meshes(m, max_edge=(24 - 4) / irm / m / 2)
  mats = np.stack([np.diag([m, m, m, 1.0]).astype(np.float32)] * 2)
  mats[1, :3, 3] = [0.3, -0.2, 0.1]
  kwargs = dict(num_meshes=2, resolution=(m, m, m),
                image_resolution_multiplier=irm, max_bbox_pixels=window,
                chunk_size=256 if window is None else None)
  if window is None:  # the full window is 258² samples per triangle
    triangles, index, valid = triangles[::9], index[::9], valid[::9]
  want = np.asarray(jax_voxelize.voxelize_triangles(
      *map(jnp.asarray, (triangles, index, mats, valid)), **kwargs))
  got = voxelize.voxelize_triangles(
      *map(torch.from_numpy, (triangles, index, mats, valid)), **kwargs)
  tt.assert_array_equal(got.numpy(), want)
  assert want.sum() > 500
  if window is None:
    small = voxelize.voxelize_triangles(
        *map(torch.from_numpy, (triangles, index, mats, valid)),
        **dict(kwargs, max_bbox_pixels=24, chunk_size=None))
    assert torch.equal(small, got)


def test_voxelize_at_y1_settings_matches_jax():
  """y1's training voxelization: 32³, sub-grid sampling, irm 31, a
  24-pixel window on triangles subdivided at 20 / 31 / 32."""
  m, irm = 32, 31
  triangles, index, _, valid = _meshes(m, max_edge=(24 - 4) / irm / m)
  mats = np.stack([np.diag([m, m, m, 1.0]).astype(np.float32)] * 2)
  mats[:, :3, 3] = [[0.2, -0.35, 0.45], [-0.1, 0.3, 0.0]]
  kwargs = dict(num_meshes=2, resolution=(m, m, m), sub_grid_sampling=True,
                image_resolution_multiplier=irm, max_bbox_pixels=24)
  want = np.asarray(jax_voxelize.voxelize_triangles(
      *map(jnp.asarray, (triangles, index, mats, valid)), **kwargs))
  got = voxelize.voxelize_triangles(
      *map(torch.from_numpy, (triangles, index, mats, valid)), **kwargs)
  assert got.shape == (2, 65, 65, 65)
  tt.assert_array_equal(got.numpy(), want)
  tt.assert_array_equal(
      voxelize.get_sub_grid_centers(got).numpy(),
      np.asarray(jax_voxelize.get_sub_grid_centers(jnp.asarray(want))))
  assert want.sum() > 5000


def test_voxelize_mesh_matches_jax_and_checks_its_inputs(monkeypatch):
  rng = np.random.default_rng(3)
  cube = cube_mesh(0.3, 0.7) + SHIFT
  sphere = _sphere(rng, np.array([0.5, 0.5, 0.5]), 0.25)
  triangles = np.concatenate([cube, sphere])
  counts = [len(cube), len(sphere)]
  v2x = np.diag([16.0, 16.0, 16.0, 1.0]).astype(np.float32)
  want = np.asarray(jax_voxelize.voxelize_mesh(
      triangles, counts, (16, 16, 16), v2x, image_resolution_multiplier=5))
  got = voxelize.voxelize_mesh(triangles, counts, (16, 16, 16), v2x,
                               image_resolution_multiplier=5, device="cpu")
  tt.assert_array_equal(got.numpy(), want)
  with pytest.raises(ValueError, match="sums to"):
    voxelize.voxelize_mesh(triangles, [3, 4], (16, 16, 16), v2x,
                           device="cpu")
  with pytest.raises(ValueError, match="odd"):
    voxelize.voxelize_mesh(triangles, counts, (16, 16, 16), v2x,
                           sub_grid_sampling=True,
                           image_resolution_multiplier=4, device="cpu")
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    voxelize.voxelize_mesh(triangles, counts, (16, 16, 16), v2x)


def _general_scenes():
  """The two scenes of test_torch_raster_fast.py, moved off the sample
  boundaries."""
  triangles, slot, valid, offsets = _scenes(32)
  return triangles + SHIFT, slot, valid, offsets


GENERAL = {
    "sub_grid": (dict(sub_grid_sampling=True, image_resolution_multiplier=5,
                      conservative_rasterization=False, max_bbox_pixels=24),
                 1),
    "labels_above_255": (dict(image_resolution_multiplier=8,
                              conservative_rasterization=False,
                              max_bbox_pixels=24, num_label_values=300), 150),
    "wide_window_static_fill": (dict(image_resolution_multiplier=4,
                                     conservative_rasterization=True,
                                     max_bbox_pixels=64, fill_rounds=3,
                                     num_label_values=3), 1),
    "no_fill": (dict(image_resolution_multiplier=4, fill_inside=False,
                     projection_depth_multiplier=2, max_bbox_pixels=30), 1),
}


@pytest.mark.parametrize("case", sorted(GENERAL))
def test_voxelize_batch_general_path_matches_jax(case):
  """The configurations the blocked rasterizer does not serve take the
  general one, and return int32 whatever num_label_values says."""
  kwargs, label_scale = GENERAL[case]
  kwargs = dict(kwargs, resolution=(32, 32, 32))
  triangles, slot, valid, offsets = _general_scenes()
  labels = np.array([[2, 1], [1, 0]], np.int32) * label_scale
  inputs = (triangles, slot, valid, labels, offsets)
  want, want_v2x = jax_gt.voxelize_batch(*map(jnp.asarray, inputs),
                                         **dict(kwargs))
  got, got_v2x = gt.voxelize_batch(*map(torch.from_numpy, inputs), **kwargs)
  assert got.dtype == torch.int32 and np.asarray(want).dtype == np.int32
  tt.assert_array_equal(got.numpy(), np.asarray(want))
  tt.assert_array_equal(got_v2x.numpy(), np.asarray(want_v2x))
  assert set(np.unique(got.numpy())) == {0, label_scale, 2 * label_scale}


def test_voxelize_scene_matches_jax_and_drops_foreign_slots():
  triangles, slot, valid, offsets = _general_scenes()
  kwargs = dict(resolution=(32, 32, 32), sub_grid_sampling=True,
                image_resolution_multiplier=3,
                conservative_rasterization=False)
  labels = np.array([3, 7], np.int32)
  slot = slot.copy()
  slot[1, ::5] = 2  # no such slot: dropped, not moved to another scene
  want = np.asarray(jax_gt.voxelize_scene(
      *map(jnp.asarray, (triangles[1], slot[1], valid[1], labels,
                         offsets[1])), **kwargs))
  got = gt.voxelize_scene(
      *map(torch.from_numpy, (triangles[1], slot[1], valid[1], labels,
                              offsets[1])), **kwargs)
  assert got.shape == (32, 32, 32) and got.dtype == torch.int32
  tt.assert_array_equal(got.numpy(), want)
  batch, _ = gt.voxelize_batch(
      *map(torch.from_numpy, (triangles, slot, valid,
                              np.stack([labels, labels]), offsets)),
      **kwargs)
  assert torch.equal(batch[1], got)
