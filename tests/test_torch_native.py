"""The port's native C++ ground-truth ops (corenet_tpu_torch/cc/) against
the JAX package's (corenet_tpu/cc/) and against the port's own tensor GT,
on the CPU.

Both libraries are built here with g++ from their own copies of the same
sources and the same flags, so they are held equal bit for bit: the flood
fill on seeded grids in uint8, int32 and float32; the voxelizer on seeded
triangle soups, conservative on and off, on the sub-grid, and on the cube
cases of tests/test_native.py. Against the port's tensor GT
(voxel/voxelize.py, voxel/fill.py) the soups are in general position, so
no sample lies on a decision boundary, where float32 and the C++ code's
doubles may round apart (tests/test_native.py holds the JAX package's
native code to XLA the same way); the tolerance is 0 voxels.
"""

import os

import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu.cc import native as jax_native
from corenet_tpu_torch.cc import native
from corenet_tpu_torch.voxel import fill, voxelize
from helpers import cube_mesh

torch.set_num_threads(2)


def _grids(dtype, seed):
  rng = np.random.default_rng(seed)
  grids = [(rng.random((3, 12, 12, 12)) > 0.72),
           (rng.random((2, 9, 17, 20)) > 0.6)]
  if dtype == np.float32:  # occupied iff > 0: negative values are empty
    return [np.where(g, rng.random(g.shape) + 0.1,
                     -rng.random(g.shape)).astype(np.float32) for g in grids]
  return [g.astype(dtype) * rng.integers(1, 7, g.shape).astype(dtype)
          for g in grids]


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float32])
def test_fill_equals_jax_native_and_the_tensor_fill(dtype):
  for seed, grid in enumerate(_grids(dtype, 0)):
    got = native.fill_inside_voxels(grid)
    assert got.dtype == grid.dtype and got.shape == grid.shape
    tt.assert_array_equal(got, jax_native.fill_inside_voxels(grid))
    tensor = fill.fill_inside_voxels(torch.from_numpy(grid))
    tt.assert_array_equal(got, tensor.numpy())
    assert 0 < got.sum() < got.size, seed
  # The input is not written.
  grid = _grids(dtype, 1)[0]
  before = grid.copy()
  native.fill_inside_voxels(grid)
  tt.assert_array_equal(grid, before)


def test_fill_takes_other_dtypes_through_float32():
  grid = np.zeros((1, 5, 5, 5), np.float64)
  grid[0, 1:4, 1:4, 1:4] = 1
  grid[0, 2, 2, 2] = 0
  got = native.fill_inside_voxels(grid)
  assert got.dtype == np.float64
  tt.assert_array_equal(got, jax_native.fill_inside_voxels(grid))
  assert got[0, 2, 2, 2] == 1 and got.sum() == 27


def _tensor_voxelize(tris, mesh_idx, num_meshes, res, **kwargs):
  return voxelize.voxelize_triangles(
      torch.from_numpy(tris), torch.from_numpy(mesh_idx),
      torch.eye(4).expand(num_meshes, 4, 4).contiguous(),
      torch.ones(len(tris), dtype=torch.bool), num_meshes=num_meshes,
      resolution=res, **kwargs).numpy()


@pytest.mark.parametrize("conservative", [False, True])
@pytest.mark.parametrize("sub_grid", [False, True])
def test_voxelizer_fuzz_equals_jax_native_and_the_tensor_voxelizer(
    conservative, sub_grid):
  rng = np.random.default_rng(42 + conservative + 2 * sub_grid)
  for trial in range(4):
    t = int(rng.integers(3, 24))
    # Odd fractions of a voxel keep the soups off the sample lattice.
    tris = (rng.random((t, 3, 3)) * 8 - 0.5 + 0.0113).astype(np.float32)
    num_meshes = 2
    mesh_idx = np.sort(rng.integers(0, num_meshes, t)).astype(np.int32)
    res = (8, 8, 8)
    irm = ([3, 5] if sub_grid else [2, 3])[trial % 2]
    kwargs = dict(image_resolution_multiplier=irm,
                  conservative_rasterization=conservative,
                  sub_grid_sampling=sub_grid)
    got = native.voxelize_triangles(tris, mesh_idx, num_meshes, res,
                                    **kwargs)
    want = jax_native.voxelize_triangles(tris, mesh_idx, num_meshes, res,
                                         **kwargs)
    assert got.dtype == np.float32
    tt.assert_array_equal(got, want)
    assert got.sum() > 0, trial
    tensor = _tensor_voxelize(tris, mesh_idx, num_meshes, res, **kwargs)
    mismatches = int((got != tensor).sum())
    assert mismatches == 0, f"trial {trial}: {mismatches} voxels differ"
    tt.assert_array_equal(native.fill_inside_voxels(got),
                          fill.fill_inside_voxels(
                              torch.from_numpy(tensor)).numpy())


def test_projection_depth_multiplier_equals_jax_native():
  rng = np.random.default_rng(7)
  tris = (rng.random((16, 3, 3)) * 12 + 0.0113).astype(np.float32)
  mesh_idx = np.zeros(16, np.int32)
  for pdm in (1, 2):
    kwargs = dict(image_resolution_multiplier=2,
                  projection_depth_multiplier=pdm)
    got = native.voxelize_triangles(tris, mesh_idx, 1, (12, 12, 12),
                                    **kwargs)
    tt.assert_array_equal(got, jax_native.voxelize_triangles(
        tris, mesh_idx, 1, (12, 12, 12), **kwargs))
    tt.assert_array_equal(got, _tensor_voxelize(tris, mesh_idx, 1,
                                                (12, 12, 12), **kwargs))


def test_cube_cases():
  """tests/test_native.py's: a conservative cube shell, and the filled
  cube on the sub-grid."""
  cube = cube_mesh(0.99, 2.01).reshape(12, 3, 3)
  grid = native.voxelize_triangles(
      cube, np.zeros(12, np.int32), 1, (3, 3, 3),
      image_resolution_multiplier=1, conservative_rasterization=True)
  want = np.ones([3, 3, 3], np.float32)
  want[1, 1, 1] = 0
  tt.assert_array_equal(grid[0], want)
  grid = native.fill_inside_voxels(native.voxelize_triangles(
      cube, np.zeros(12, np.int32), 1, (3, 3, 3),
      image_resolution_multiplier=9, conservative_rasterization=True,
      sub_grid_sampling=True))
  want = np.zeros([1, 7, 7, 7], np.float32)
  want[0, 2:5, 2:5, 2:5] = 1
  tt.assert_array_equal(grid, want)
  with pytest.raises(ValueError, match="ascend"):
    native.voxelize_triangles(cube, np.array([0] * 11 + [1], np.int32), 1,
                              (3, 3, 3))
  with pytest.raises(ValueError, match="ascend"):
    native.voxelize_triangles(cube, np.array([1] + [0] * 11, np.int32), 2,
                              (3, 3, 3))
  with pytest.raises(ValueError, match="T, 3, 3"):
    native.voxelize_triangles(cube[:, :2], np.zeros(12, np.int32), 1,
                              (3, 3, 3))
  with pytest.raises(ValueError, match="T, 3, 3"):
    native.voxelize_triangles(cube, np.zeros(11, np.int32), 1, (3, 3, 3))
  with pytest.raises(ValueError, match="odd"):
    native.voxelize_triangles(cube, np.zeros(12, np.int32), 1, (3, 3, 3),
                              image_resolution_multiplier=4,
                              sub_grid_sampling=True)


def test_the_library_builds_once_and_a_failed_build_raises(tmp_path,
                                                           monkeypatch):
  lib = native.load_library()
  assert native.load_library() is lib
  path = native.library_path()
  assert path.exists() and path.parent == native.BUILD_DIR
  assert native.build() == path  # built already: not rebuilt
  # A precompiled library named by the environment is loaded instead.
  monkeypatch.setattr(native, "_LIB", None)
  monkeypatch.setenv("CORENET_PRECOMPILED_CC_LIBRARY", str(path))
  monkeypatch.setattr(native, "build", lambda: pytest.fail("built"))
  assert native.load_library()._name == str(path)
  monkeypatch.undo()
  # A failed build raises with the compiler's words and leaves no file.
  monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
  monkeypatch.setattr(native, "GXX_FLAGS",
                      native.GXX_FLAGS + ("-DNOT_A_FLAG", "--no-such-flag"))
  with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
    native.build()
  assert os.listdir(tmp_path / "build") == []
