"""The port's bit-packed grids and packed interior fill
(corenet_tpu_torch/voxel/packed.py) against the JAX package's
(corenet_tpu/voxel/packed.py), bit for bit, on the CPU.

The port holds the uint32 words as int32; `.view(np.uint32)` of a numpy
copy gives the bit patterns the JAX functions return. The edge words 0,
0xFFFFFFFF, 1, 0x80000000 and 0x7FFFFFFF catch a sign-extending right
shift and a non-wrapping increment.
"""

import jax.numpy as jnp
import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu.voxel import packed as jax_packed
from corenet_tpu_torch.utils import tracing
from corenet_tpu_torch.voxel import packed

EDGE_WORDS = np.array([0, 0xFFFFFFFF, 1, 0x80000000, 0x7FFFFFFF, 0xFFFFFFFE,
                       0x0000FFFF, 0xFFFF0000], np.uint32)


def _count(name: str) -> int:
  """A counter's total (corenet_tpu_torch/utils/tracing.py)."""
  return tracing.counters()[name]


def _words(rng, n):
  """n random uint32 words followed by the edge words."""
  return np.concatenate([
      rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32),
      EDGE_WORDS])


def _t(words_u32):
  return torch.from_numpy(words_u32.view(np.int32).copy())


def _u32(t):
  return t.numpy().view(np.uint32)


def test_shift_right_is_logical():
  words = _words(np.random.default_rng(0), 64)
  for k in range(32):
    tt.assert_array_equal(_u32(packed.shift_right(_t(words), k)),
                          words >> np.uint32(k))


@pytest.mark.parametrize("name", ["_trailing_ones", "_leading_ones"])
def test_bit_helpers_match_jax(name):
  e = _words(np.random.default_rng(1), 256)
  want = np.asarray(getattr(jax_packed, name)(jnp.asarray(e)))
  got = _u32(getattr(packed, name)(_t(e)))
  tt.assert_array_equal(got, want)
  # The edge words by hand: the runs of ones at bit 0 and at bit 31.
  if name == "_trailing_ones":
    assert list(got[-8:-3]) == [0, 0xFFFFFFFF, 1, 0, 0x7FFFFFFF]
  else:
    assert list(got[-8:-3]) == [0, 0xFFFFFFFF, 0, 0x80000000, 0]


@pytest.mark.parametrize("name", ["_kog_up", "_kog_down"])
def test_kogge_stone_matches_jax(name):
  rng = np.random.default_rng(2)
  e = _words(rng, 256)
  r = _words(rng, 256) & e
  # Single seeds at both ends of full and broken runs.
  e = np.concatenate([e, np.full(4, 0xFFFFFFFF, np.uint32),
                      np.array([0xFFFEFFFF, 0x7FFFFFFE], np.uint32)])
  r = np.concatenate([r, np.array([1, 0x80000000, 0x00010000, 0, 1,
                                   0x40000000], np.uint32)])
  want = np.asarray(getattr(jax_packed, name)(jnp.asarray(r),
                                              jnp.asarray(e)))
  tt.assert_array_equal(_u32(getattr(packed, name)(_t(r), _t(e))), want)


def test_pack_unpack_match_jax():
  rng = np.random.default_rng(3)
  grid = (rng.random((2, 3, 64, 32, 32)) < 0.3).astype(np.float32)
  want = np.asarray(jax_packed.pack_grid(jnp.asarray(grid)))
  got = packed.pack_grid(torch.from_numpy(grid))
  assert got.shape == (2, 3, 32, 32, 2) and got.dtype == torch.int32
  tt.assert_array_equal(_u32(got), want)
  back = packed.unpack_grid(got, dtype=torch.uint8)
  assert back.dtype == torch.uint8
  tt.assert_array_equal(back.numpy(), grid)
  tt.assert_array_equal(
      packed.unpack_grid(got).numpy(),
      np.asarray(jax_packed.unpack_grid(jnp.asarray(want))))


def _blobs_and_box(shape, seed):
  """Random blobs plus a closed box with a cavity (which must fill) and a
  voxel inside the cavity."""
  rng = np.random.default_rng(seed)
  grid = (rng.random(shape) < 0.1).astype(np.float32)
  box = np.zeros(shape[1:], np.float32)
  box[4:20, 4:20, 4:20] = 1
  box[6:18, 6:18, 6:18] = 0
  box[10, 10, 10] = 1
  grid[0] = np.maximum(grid[0], box)
  return grid


def _tunnel():
  """A hollow box whose cavity a tunnel opens to the boundary: nothing
  inside it fills."""
  grid = np.zeros((1, 32, 32, 32), np.float32)
  grid[0, 8:24, 8:24, 8:24] = 1
  grid[0, 10:22, 10:22, 10:22] = 0
  grid[0, 15:17, 15:17, :10] = 0
  grid[0, 14:18, 14:18, 8:10] = 0
  return grid


@pytest.mark.parametrize("case", ["blobs32", "blobs64", "tunnel"])
def test_fill_matches_jax_static_and_adaptive(case):
  grid = {"blobs32": lambda: _blobs_and_box((1, 32, 32, 32), 4),
          "blobs64": lambda: _blobs_and_box((2, 64, 64, 64), 5),
          "tunnel": _tunnel}[case]()
  words = jax_packed.pack_grid(jnp.asarray(grid))
  want = np.asarray(jax_packed.fill_inside_packed(words))

  port_words = packed.pack_grid(torch.from_numpy(grid))
  before = _count("fill.rounds")
  adaptive = packed.fill_inside_packed(port_words)
  rounds = _count("fill.rounds") - before
  assert rounds >= 2  # the last round is the one that changes nothing
  tt.assert_array_equal(_u32(adaptive), want)
  # The static loop with as many rounds gives the fixpoint too, and
  # counts no rounds.
  static = packed.fill_inside_packed(port_words, fill_rounds=rounds)
  assert _count("fill.rounds") == before + rounds
  tt.assert_array_equal(_u32(static), want)
  tt.assert_array_equal(
      _u32(packed.fill_inside_packed(port_words, fill_rounds=1)),
      np.asarray(jax_packed.fill_inside_packed(words, fill_rounds=1)))
  if case == "blobs32":  # the cavity filled
    assert packed.unpack_grid(adaptive)[0, 12, 12, 12] == 1
  if case == "tunnel":  # it did not
    assert packed.unpack_grid(adaptive)[0, 12, 12, 12] == 0
