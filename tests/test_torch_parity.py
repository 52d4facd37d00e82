"""The port's ray-parity voxelization (corenet_tpu_torch/voxel/parity.py)
against the JAX package's, on the CPU.

Scenes: the closed cube shell and the seeded closed sphere of
tests/test_torch_raster_fast.py in two mesh slots, with seeded grid
offsets. The port keeps the JAX function's float32 expressions (the edge
functions, the ray perturbation, z* and its bin) operation for operation
and reduces the same 32-bit masks by XOR, so the grids are equal: the
tolerance is 0 voxels.
"""

import jax.numpy as jnp
import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu.voxel import parity as jax_parity
from corenet_tpu_torch.train import gt
from corenet_tpu_torch.voxel import parity
from test_torch_raster_fast import _scenes

LABELS = np.array([[2, 1], [1, 0]], np.int32)


@pytest.mark.parametrize("resolution,chunk_size", [
    ((32, 32, 32), None), ((64, 64, 64), None), ((40, 32, 24), None),
    ((32, 32, 32), 37), ((96, 48, 64), 1000)])
def test_parity_voxelize_batch_matches_jax(resolution, chunk_size):
  triangles, slot, valid, _ = _scenes(32)
  offsets = np.random.default_rng(sum(resolution)).uniform(
      0.0, 1.0, (2, 3)).astype(np.float32)
  inputs = (triangles, slot, valid, LABELS, offsets)
  kwargs = dict(num_mesh_slots=2, resolution=resolution,
                chunk_size=chunk_size)
  want, want_v2x = jax_parity.parity_voxelize_batch(
      *map(jnp.asarray, inputs), **kwargs)
  got, got_v2x = parity.parity_voxelize_batch(
      *map(torch.from_numpy, inputs), **kwargs)
  assert got.dtype == torch.int32 and got.shape == (2,) + resolution
  tt.assert_array_equal(got.numpy(), np.asarray(want))
  tt.assert_array_equal(got_v2x.numpy(), np.asarray(want_v2x))
  # Scene 0 holds both meshes (where the sphere lies inside the cube, the
  # cube's larger label wins), scene 1 the cube alone.
  assert {0, 2} <= set(np.unique(got[0].numpy())) <= {0, 1, 2}
  assert set(np.unique(got[1].numpy())) == {0, 1}


def test_parity_is_inside_raster_and_fill():
  """Exact centre sampling marks no voxel that rasterize + fill leaves
  empty; it leaves out the grazed shell."""
  triangles, slot, valid, offsets = _scenes(32)
  inputs = [torch.from_numpy(a) for a in (triangles, slot, valid, LABELS,
                                          offsets)]
  inside, _ = parity.parity_voxelize_batch(*inputs, num_mesh_slots=2,
                                           resolution=(32, 32, 32))
  raster, _ = gt.voxelize_batch(
      *inputs, resolution=(32, 32, 32), image_resolution_multiplier=8,
      conservative_rasterization=False, max_bbox_pixels=24)
  assert int(((inside > 0) & (raster == 0)).sum()) == 0
  grazed = int(((inside == 0) & (raster > 0)).sum())
  assert 0 < grazed < int((inside > 0).sum())
  assert inside[0, 16, 16, 16] == 2 and inside[0, 2, 2, 2] == 0
