"""The port's on-device ground truth on the CPU against the JAX package's:
triangle subdivision (data/batching.py), the blocked rasterizer's phase A
and whole pipeline (voxel/raster_fast.py, the JAX scatter kernel in
interpret mode) and the GT functions of the training step (train/gt.py).

Scenes: a cube shell subdivided to the rasterizer's window contract in
slot 0 and a seeded closed sphere in slot 1, at 32³ and 64³, with
conservative rasterization on and off. Everything is compared bit for
bit: the port samples, projects and interpolates in the same float32
operations, and applies the view → voxel scale-and-shift elementwise,
which is exact where JAX's einsum adds exact zeros.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu.data import batching as jax_batching
from corenet_tpu.train import gt as jax_gt
from corenet_tpu.voxel import raster_fast as jax_raster
from corenet_tpu_torch.data import batching
from corenet_tpu_torch.train import gt
from corenet_tpu_torch.voxel import raster_fast
from corenet_tpu_torch.voxel.packed import unpack_grid
from helpers import cube_mesh

IRM = 8
WINDOW = batching.VOXELIZE_WINDOW_PIXELS


def _sphere(rng, centre, radius, n_lat=8, n_lon=12):
  """A closed latitude-longitude sphere with seeded per-vertex radii,
  float32[T, 3, 3]."""
  theta = np.linspace(0, np.pi, n_lat + 1)[1:-1]
  phi = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
  ring = np.stack([np.outer(np.sin(theta), np.cos(phi)),
                   np.outer(np.sin(theta), np.sin(phi)),
                   np.repeat(np.cos(theta)[:, None], n_lon, 1)], axis=-1)
  verts = np.concatenate([[[0, 0, 1]], ring.reshape(-1, 3), [[0, 0, -1]]])
  verts = centre + verts * radius * rng.uniform(0.9, 1.1, (len(verts), 1))
  idx = lambda i, j: 1 + i * n_lon + j % n_lon  # noqa: E731
  tris = []
  for j in range(n_lon):
    tris.append((0, idx(0, j), idx(0, j + 1)))
    tris.append((len(verts) - 1, idx(n_lat - 2, j + 1), idx(n_lat - 2, j)))
    for i in range(n_lat - 2):
      tris.append((idx(i, j), idx(i + 1, j), idx(i + 1, j + 1)))
      tris.append((idx(i, j), idx(i + 1, j + 1), idx(i, j + 1)))
  return verts[np.array(tris)].astype(np.float32)


@functools.lru_cache(maxsize=None)
def _scenes(m):
  """Two scenes of two mesh slots: the subdivided cube (shifted per
  scene) and a subdivided seeded sphere, padded to a power of two."""
  rng = np.random.default_rng(m)
  max_edge = (WINDOW - 4) / IRM / m
  tri = []
  for i in range(2):
    cube = cube_mesh(0.3, 0.7) + np.float32(0.03 * i)
    sphere = _sphere(rng, rng.uniform(0.35, 0.65, 3), 0.12)
    tri.append([batching.subdivide_triangles(cube, max_edge),
                batching.subdivide_triangles(sphere, max_edge)])
  t = batching._pad_to_bucket(max(len(a) + len(b) for a, b in tri))
  triangles = np.zeros((2, t, 3, 3), np.float32)
  slot = np.zeros((2, t), np.int32)
  valid = np.zeros((2, t), bool)
  for i, (a, b) in enumerate(tri):
    n = len(a) + len(b)
    triangles[i, :n] = np.concatenate([a, b])
    slot[i, len(a):n] = 1
    valid[i, :n] = True
  offsets = np.array([[0.5, 0.5, 0.5], [0.15, 0.6, 0.95]], np.float32)
  return triangles, slot, valid, offsets


def _kwargs(m, conservative):
  return dict(resolution=(m, m, m), image_resolution_multiplier=IRM,
              conservative_rasterization=conservative,
              max_bbox_pixels=WINDOW)


def _torch(*arrays):
  return [torch.from_numpy(a) for a in arrays]


def _u32(t):
  return t.numpy().view(np.uint32)


def test_subdivision_and_padding_match_jax():
  rng = np.random.default_rng(0)
  for tris, max_edge in ((cube_mesh(0.3, 0.7), 0.02),
                         (_sphere(rng, np.array([0.5] * 3), 0.2), 0.03),
                         (np.zeros((0, 3, 3), np.float32), 0.1)):
    want = jax_batching.subdivide_triangles(tris, max_edge)
    got = batching.subdivide_triangles(tris, max_edge)
    assert got.dtype == np.float32
    tt.assert_array_equal(got, want)
  assert (batching.subdivide_triangles(cube_mesh(0.3, 0.7), 20 / 8 / 128)
          .shape[0]) == 12288  # the production load of bench.py
  for n in (0, 1, 8, 9, 1000, 12288 + 1600):
    assert batching._pad_to_bucket(n) == jax_batching._pad_to_bucket(n)
    assert (batching._pad_to_bucket(n, (64, 4096)) ==
            jax_batching._pad_to_bucket(n, (64, 4096)))


@pytest.mark.parametrize("conservative", [False, True])
@pytest.mark.parametrize("m", [32, 64])
def test_phase_a_matches_jax(m, conservative):
  triangles, slot, valid, offsets = _scenes(m)
  v2v = np.asarray(jax_gt._view2voxel_uniform(jnp.asarray(offsets),
                                              float(m), 2))
  want_o, want_pw = jax.vmap(functools.partial(
      jax_raster._phase_a, m=m, irm=IRM, conservative=conservative,
      uniform_mats=True))(*map(jnp.asarray, (triangles, slot, v2v, valid)))
  port_v2v = gt._view2voxel_uniform(torch.from_numpy(offsets), float(m), 2)
  tt.assert_array_equal(port_v2v.numpy(), v2v)
  got_o, got_pw = raster_fast._phase_a(
      *_torch(triangles, slot), port_v2v, torch.from_numpy(valid), m=m,
      irm=IRM, conservative=conservative)
  tt.assert_array_equal(got_o.numpy(), np.asarray(want_o))
  tt.assert_array_equal(_u32(got_pw), np.asarray(want_pw))
  assert (got_o.numpy() >= 0).sum() > 0.9 * valid.sum()


@pytest.mark.parametrize("conservative", [False, True])
@pytest.mark.parametrize("m", [32, 64])
def test_blocked_voxelization_and_fgbg_gt_match_jax(m, conservative):
  triangles, slot, valid, offsets = _scenes(m)
  kwargs = _kwargs(m, conservative)
  labels = np.array([[1, 1], [0, 1]], np.int32)  # scene 1: slot 0 off
  inputs = (triangles, slot, valid, labels, offsets)

  v2v = jax_gt._view2voxel_uniform(jnp.asarray(offsets), float(m), 2)
  want = np.asarray(jax_raster.voxelize_blocked_packed(
      jnp.asarray(triangles), jnp.asarray(slot), v2v, jnp.asarray(valid),
      num_meshes=2, resolution=(m, m, m), image_resolution_multiplier=IRM,
      conservative_rasterization=conservative, uniform_mats=True))
  got = raster_fast.voxelize_blocked_packed(
      *_torch(triangles, slot),
      gt._view2voxel_uniform(torch.from_numpy(offsets), float(m), 2),
      torch.from_numpy(valid), num_meshes=2, resolution=(m, m, m),
      image_resolution_multiplier=IRM,
      conservative_rasterization=conservative)
  assert got.shape == (2, 2, m, m, m // 32)
  tt.assert_array_equal(_u32(got), want)

  want_or, want_v2x = jax_gt.voxelize_batch_packed_fgbg(
      *map(jnp.asarray, inputs), **kwargs)
  assert gt.packed_fgbg_eligible(**kwargs)
  got_or, got_v2x = gt.voxelize_batch_packed_fgbg(*_torch(*inputs),
                                                  **kwargs)
  tt.assert_array_equal(_u32(got_or), np.asarray(want_or))
  tt.assert_array_equal(got_v2x.numpy(), np.asarray(want_v2x))
  # The slot mask: scene 1 holds the sphere alone, scene 0 both meshes.
  tt.assert_array_equal(_u32(got_or)[1], _u32(got)[1, 1])
  tt.assert_array_equal(_u32(got_or)[0], _u32(got[0, 0] | got[0, 1]))
  # The cube is closed and filled: its centre is inside.
  grid = unpack_grid(got_or, dtype=torch.uint8)
  assert grid[0, m // 2, m // 2, m // 2] == 1
  assert 0.03 < float(grid[0].float().mean()) < 0.2


@pytest.mark.parametrize("num_label_values", [None, 3])
def test_voxelize_batch_matches_jax(num_label_values):
  m = 32
  triangles, slot, valid, offsets = _scenes(m)
  labels = np.array([[2, 1], [1, 0]], np.int32)
  kwargs = dict(_kwargs(m, False), fill_rounds=None)
  if num_label_values is not None:
    kwargs["num_label_values"] = num_label_values
  inputs = (triangles, slot, valid, labels, offsets)
  want, want_v2x = jax_gt.voxelize_batch(*map(jnp.asarray, inputs),
                                         **dict(kwargs))
  got, got_v2x = gt.voxelize_batch(*_torch(*inputs), **kwargs)
  want = np.asarray(want)
  assert got.dtype == (torch.int32 if num_label_values is None
                       else torch.uint8)
  assert str(want.dtype) == str(got.dtype).replace("torch.", "")
  tt.assert_array_equal(got.numpy(), want)
  tt.assert_array_equal(got_v2x.numpy(), np.asarray(want_v2x))
  assert set(np.unique(want)) == {0, 1, 2}


def test_blocked_eligibility_matches_jax_and_the_rest_raises():
  configs = [dict(resolution=(m, m, m), sub_grid_sampling=sub,
                  image_resolution_multiplier=irm,
                  projection_depth_multiplier=pdm, max_bbox_pixels=mbp)
             for m in (32, 48, 128) for sub in (False, True)
             for irm in (4, 8, 2.5) for pdm in (1, 2)
             for mbp in (None, 14, 24)]
  configs.append(dict(configs[0], resolution=(64, 64, 32)))
  for config in configs:
    assert (raster_fast.blocked_eligible(**config) ==
            jax_raster.blocked_eligible(**config)), config
  triangles, slot, valid, offsets = _scenes(32)
  inputs = _torch(triangles, slot, valid, np.ones((2, 2), np.int32),
                  offsets)
  # What the blocked rasterizer does not serve takes the general one
  # (tests/test_torch_voxelize.py holds it against JAX): int32 grids,
  # without a launch of the block scatter. An even multiplier cannot sample
  # the sub-grid, so that configuration raises.
  general, _ = gt.voxelize_batch(*inputs, **dict(_kwargs(32, False),
                                                 num_label_values=300))
  blocked, _ = gt.voxelize_batch(*inputs, **dict(_kwargs(32, False),
                                                 num_label_values=3))
  assert general.dtype == torch.int32 and blocked.dtype == torch.uint8
  assert 0.95 < float(general.sum()) / float(blocked.sum()) < 1.05
  with pytest.raises(ValueError, match="odd"):
    gt.voxelize_batch(*inputs, **dict(_kwargs(32, False),
                                      sub_grid_sampling=True))
  assert not gt.packed_fgbg_eligible(**dict(_kwargs(32, False),
                                            max_bbox_pixels=None))
