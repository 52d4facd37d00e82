"""The port's dense interior fill (corenet_tpu_torch/voxel/fill.py) and
label composition (voxel/compose.py) against the JAX package's, on the
CPU, bit for bit: integer and boolean work only.

Grids: the shapes of tests/test_torch_packed.py (random blobs with a
closed box whose cavity must fill, a box whose cavity a tunnel opens), a
non-cubic grid, and a serpentine corridor that needs many rounds.
"""

import jax.numpy as jnp
import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu.voxel import compose as jax_compose
from corenet_tpu.voxel import fill as jax_fill
from corenet_tpu_torch.utils import tracing
from corenet_tpu_torch.voxel import compose, fill
from test_torch_packed import _blobs_and_box, _tunnel


def _count(name: str) -> int:
  """A counter's total (corenet_tpu_torch/utils/tracing.py)."""
  return tracing.counters()[name]


def _serpentine():
  """A solid slab whose only empty cells are a corridor that snakes in
  from the boundary, row by row: each row takes one more round."""
  grid = np.ones((1, 3, 21, 21), np.float32)
  grid[0, 1, 1, 0] = 0  # the corridor's mouth
  for i, row in enumerate(range(1, 20, 2)):
    grid[0, 1, row, 1:20] = 0
    if row + 2 < 20:
      grid[0, 1, row + 1, 19 if i % 2 == 0 else 1] = 0
  return grid


GRIDS = {
    "blobs32": lambda: _blobs_and_box((1, 32, 32, 32), 4),
    "blobs_non_cubic": lambda: _blobs_and_box((2, 24, 40, 33), 5),
    "tunnel": _tunnel,
    "serpentine": _serpentine,
    "sub_grid_65": lambda: _blobs_and_box((2, 65, 65, 65), 6),
}


@pytest.mark.parametrize("case", sorted(GRIDS))
def test_fill_matches_jax_adaptive_and_static(case):
  grid = GRIDS[case]()
  want = np.asarray(jax_fill.fill_inside_voxels(jnp.asarray(grid)))
  before = _count("fill.rounds")
  adaptive = fill.fill_inside_voxels(torch.from_numpy(grid))
  rounds = _count("fill.rounds") - before
  assert rounds >= 2  # the last round is the one that changes nothing
  assert adaptive.dtype == torch.float32
  tt.assert_array_equal(adaptive.numpy(), want)
  # The static loop with as many rounds gives the fixpoint and counts none;
  # one round alone gives what JAX's one round gives.
  static = fill.fill_inside_voxels(torch.from_numpy(grid), fill_rounds=rounds)
  assert _count("fill.rounds") == before + rounds
  tt.assert_array_equal(static.numpy(), want)
  tt.assert_array_equal(
      fill.fill_inside_voxels(torch.from_numpy(grid), fill_rounds=1).numpy(),
      np.asarray(jax_fill.fill_inside_voxels(jnp.asarray(grid),
                                             fill_rounds=1)))
  for n in (1, rounds - 1, rounds):
    assert bool(fill.static_rounds_converged(torch.from_numpy(grid), n)) == (
        bool(jax_fill.static_rounds_converged(jnp.asarray(grid), n)))
  assert bool(fill.static_rounds_converged(torch.from_numpy(grid), rounds))
  if case == "blobs32":  # the cavity filled
    assert adaptive[0, 12, 12, 12] == 1 and grid[0, 12, 12, 12] == 0
  if case == "tunnel":  # it did not
    assert adaptive[0, 12, 12, 12] == 0
  if case == "serpentine":  # many turns: a few static rounds under-fill it
    assert rounds > 6 and adaptive[0, 1, 19, 10] == 0
    assert not bool(fill.static_rounds_converged(torch.from_numpy(grid), 3))


def test_fill_keeps_the_dtype_and_checks_the_rank():
  grid = (_blobs_and_box((1, 32, 32, 32), 7) * 3).astype(np.int32)
  want = np.asarray(jax_fill.fill_inside_voxels(jnp.asarray(grid)))
  got = fill.fill_inside_voxels(torch.from_numpy(grid))
  assert got.dtype == torch.int32
  tt.assert_array_equal(got.numpy(), want)
  with pytest.raises(ValueError, match=r"\[N, D, H, W\]"):
    fill.fill_inside_voxels(torch.zeros((4, 4, 4)))


def test_compose_batch_grid_matches_jax_with_a_dropped_slot():
  rng = np.random.default_rng(0)
  grids = (rng.random((5, 8, 9, 10)) < 0.3).astype(np.float32)
  # Mesh 3 is padding (index = batch size: dropped); meshes 0 and 2 share
  # batch element 1, where the larger label wins.
  index = np.array([1, 0, 1, 3, 2], np.int32)
  labels = np.array([2, 5, 4, 9, 1], np.int32)
  want = np.asarray(jax_compose.compose_batch_grid(
      jnp.asarray(grids), jnp.asarray(index), jnp.asarray(labels), 3))
  got = compose.compose_batch_grid(torch.from_numpy(grids),
                                   torch.from_numpy(index),
                                   torch.from_numpy(labels), 3)
  assert got.dtype == torch.int32 and got.shape == (3, 8, 9, 10)
  tt.assert_array_equal(got.numpy(), want)
  assert 9 not in got.numpy() and {2, 4} <= set(np.unique(got[1].numpy()))
  tt.assert_array_equal(
      compose.compose_batch_grid(torch.from_numpy(grids),
                                 torch.from_numpy(index),
                                 torch.from_numpy(labels.astype(np.float32)),
                                 3).numpy(), want)
