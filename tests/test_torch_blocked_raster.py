"""The port's blocked rasterizer in one step (corenet_tpu_torch/ops/
blocked_raster.py: its plain version on the CPU, phase A and the
scatter's plain version) against the JAX package's phase A and Pallas
scatter (`_voxelize_blocked_packed` without the fill, the scatter in
interpret mode), bit for bit on the words; and the wrapper's refusals.

Scenes, two per batch at 32³ and 64³, for irm 1, 2 and 8, with
conservative rasterization on and off: a cube shell and a seeded sphere
subdivided to the window contract of that irm in mesh slots 0 and 1;
zero-area triangles (three equal vertices, and collinear ones on dyadic
coordinates, whose normal is exactly zero in every implementation);
triangles clipped at and beyond the grid's six faces; rows whose
tri_valid is false but which hold triangles. The card's kernel is held
to the same plain version in tests/test_torch_cuda.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu.voxel import raster_fast as jax_raster
from corenet_tpu_torch.data import batching
from corenet_tpu_torch.ops import blocked_raster
from corenet_tpu_torch.train import gt
from helpers import cube_mesh
from test_torch_raster_fast import _sphere

# Dyadic grid offsets: the view → voxel shift (offset − 0.5) is exact.
OFFSETS = np.array([[0.5, 0.5, 0.5], [0.25, 0.625, 0.875]], np.float32)


def _window(irm):
  """The largest sampling window blocked_eligible admits at this irm."""
  return int(4 + 2.5 * irm)


@functools.lru_cache(maxsize=None)
def _scenes(m, irm):
  """Two scenes of two mesh slots, padded with invalid rows that hold
  triangles: (triangles, slot, valid)."""
  rng = np.random.default_rng(100 * m + irm)
  max_edge = (_window(irm) - 4) / irm / m
  scenes = []
  for i in range(2):
    cube = batching.subdivide_triangles(
        cube_mesh(0.3, 0.7) + np.float32(0.03 * i), max_edge)
    sphere = batching.subdivide_triangles(
        _sphere(rng, rng.uniform(0.35, 0.65, 3), 0.12), max_edge)
    # Zero area: three equal vertices; collinear on a 1/1024 grid (exact
    # products, so the normal is exactly zero).
    point = rng.integers(0, 1024, (24, 1, 3)) / 1024
    step = rng.integers(-4, 5, (24, 1, 3)) / 1024
    flat = np.concatenate([np.repeat(point[:12], 3, axis=1),
                           np.concatenate([point, point + step,
                                           point + 2 * step], axis=1)[12:]])
    # Clipped: a small triangle on each face of the unit cube and beyond
    # it, and near the edges and corners.
    corner = rng.uniform(-0.03, 1.03, (96, 1, 3))
    corner[:48, 0, rng.integers(0, 3, 48)] = rng.choice(
        [-0.01, 0.0, 0.995, 1.0, 1.01], 48)
    clipped = corner + rng.uniform(-1, 1, (96, 3, 3)) * max_edge * 0.6
    scenes.append((cube, np.concatenate([sphere, flat, clipped])))
  t = max(len(a) + len(b) for a, b in scenes) + 16
  triangles = rng.uniform(0, 1, (2, t, 3, 3)).astype(np.float32)
  slot = np.zeros((2, t), np.int32)
  valid = np.zeros((2, t), bool)
  for i, (a, b) in enumerate(scenes):
    n = len(a) + len(b)
    triangles[i, :n] = np.concatenate([a, b])
    slot[i, len(a):n] = 1
    valid[i, :n] = rng.random(n) > 0.03
  return triangles, slot, valid


def _v2v(m):
  return gt._view2voxel_uniform(torch.from_numpy(OFFSETS), float(m), 2)


@pytest.mark.parametrize("conservative", [False, True])
@pytest.mark.parametrize("irm", [1, 2, 8])
@pytest.mark.parametrize("m", [32, 64])
def test_plain_version_matches_jax(m, irm, conservative):
  triangles, slot, valid = _scenes(m, irm)
  v2v = _v2v(m)
  want = np.asarray(jax_raster._voxelize_blocked_packed(
      jnp.asarray(triangles), jnp.asarray(slot), jnp.asarray(v2v.numpy()),
      jnp.asarray(valid), num_meshes=2, resolution=(m, m, m),
      image_resolution_multiplier=irm,
      conservative_rasterization=conservative, fill_inside=False,
      uniform_mats=True))
  got = blocked_raster.blocked_raster_or(
      *map(torch.from_numpy, (triangles, slot)), v2v,
      torch.from_numpy(valid), meshes=2, m=m, irm=irm,
      conservative=conservative)
  assert got.shape == (2, 2, m, m * (m // 32)) and got.dtype == torch.int32
  tt.assert_array_equal(got.numpy().view(np.uint32).reshape(want.shape),
                        want)
  # Both slots of both scenes are drawn.
  assert (want.reshape(4, -1) != 0).sum(axis=1).min() > 50


def test_invalid_and_zero_area_triangles_write_nothing():
  m, irm = 32, 8
  triangles, slot, valid = _scenes(m, irm)
  args = dict(meshes=2, m=m, irm=irm, conservative=True)
  tri = torch.from_numpy(triangles)
  none = blocked_raster.blocked_raster_or(
      tri, torch.from_numpy(slot), _v2v(m), torch.zeros(valid.shape,
                                                        dtype=torch.bool),
      **args)
  assert not none.any()
  point = torch.rand((2, 8, 1, 3), generator=torch.Generator().manual_seed(0))
  same = blocked_raster.blocked_raster_or(
      point.expand(2, 8, 3, 3).contiguous(),
      torch.zeros((2, 8), dtype=torch.int32), _v2v(m),
      torch.ones((2, 8), dtype=torch.bool), **args)
  assert not same.any()


def test_wrapper_refuses_what_the_kernel_does_not_take():
  m = 32
  triangles, slot, valid = (torch.from_numpy(a) for a in _scenes(m, 8))
  v2v = _v2v(m)
  args = dict(meshes=2, m=m, irm=8, conservative=False)
  with pytest.raises(TypeError, match="float32, int32, float32 and bool"):
    blocked_raster.blocked_raster_or(triangles, slot.long(), v2v, valid,
                                     **args)
  with pytest.raises(TypeError):
    blocked_raster.blocked_raster_or(triangles.double(), slot, v2v, valid,
                                     **args)
  with pytest.raises(ValueError, match=r"\[B, T, 3, 3\]"):
    blocked_raster.blocked_raster_or(triangles[..., :2], slot, v2v, valid,
                                     **args)
  with pytest.raises(ValueError, match="tri_valid"):
    blocked_raster.blocked_raster_or(triangles, slot, v2v, valid[:, 1:],
                                     **args)
  with pytest.raises(ValueError, match="view2voxel"):
    blocked_raster.blocked_raster_or(triangles, slot, v2v[:1], valid, **args)
  with pytest.raises(ValueError, match="bad grid"):
    blocked_raster.blocked_raster_or(triangles, slot, v2v, valid,
                                     **dict(args, m=48))
  with pytest.raises(ValueError, match="bad grid"):
    blocked_raster.blocked_raster_or(triangles, slot, v2v, valid,
                                     **dict(args, irm=0))
  with pytest.raises(ValueError, match="contiguous"):
    blocked_raster.blocked_raster_or(triangles.transpose(2, 3), slot, v2v,
                                     valid, **args)
  with pytest.raises(ValueError, match="CPU or CUDA"):
    blocked_raster.blocked_raster_or(
        *(x.to("meta") for x in (triangles, slot, v2v, valid)), **args)


class _OnCard(torch.Tensor):
  """A CPU tensor that reports a CUDA device, to drive the wrapper's CUDA
  route on a machine without a card."""

  @property
  def device(self):
    return torch.device("cuda", 0)


def test_cuda_input_without_a_card_raises_and_never_takes_the_plain_version(
    monkeypatch):
  m = 32
  inputs = [x.as_subclass(_OnCard) for x in (
      *(torch.from_numpy(a) for a in _scenes(m, 8)), _v2v(m).contiguous())]
  triangles, slot, valid, v2v = inputs

  def plain(*_, **__):
    raise AssertionError("the plain version was taken for a CUDA input")

  monkeypatch.setattr(blocked_raster, "blocked_raster_reference", plain)
  before = blocked_raster.launch_count
  with pytest.raises((RuntimeError, AssertionError),
                     match="CUDA|nvcc|cuda") as caught:
    blocked_raster.blocked_raster_or(triangles, slot, v2v, valid, meshes=2,
                                     m=m, irm=8, conservative=False)
  assert "plain version" not in str(caught.value)
  assert blocked_raster.launch_count == before
