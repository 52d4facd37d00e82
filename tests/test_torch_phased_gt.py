"""The port's phased ground truth (corenet_tpu_torch/ops/phased_gt.py, its
plain version on the CPU) against the JAX package's Pallas kernel in
interpret mode (corenet_tpu/ops/phased_gt.py). The port emits uint8 where
the JAX kernel emits float32; the values must be the same."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu.ops.phased_gt import phased_gt as jax_phased_gt
from corenet_tpu.voxel.packed import pack_grid as jax_pack_grid
from corenet_tpu_torch.ops import phased_gt as op
from corenet_tpu_torch.voxel.packed import pack_grid


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("shape", [(2, 64, 64, 64), (1, 32, 48, 64)])
def test_plain_phased_gt_matches_jax(s, shape):
  rng = np.random.default_rng(sum(shape) + s)
  grid = (rng.random(shape) < 0.4).astype(np.uint8)
  want = np.asarray(jax_phased_gt(jax_pack_grid(jnp.asarray(grid)), s))
  got = op.phased_gt(pack_grid(torch.from_numpy(grid)), s)
  b, d, h, w = shape
  assert got.dtype == torch.uint8
  assert got.shape == (b, d // s, h // s, (w // s) * s ** 3) == want.shape
  tt.assert_array_equal(got.numpy(), want)


def test_phase_lane_layout():
  """One voxel per grid, by hand: (z, y, x) = (s·j + c) lands on lane
  jx·s³ + the in-cell digits' weights (s = 2: z 4, y 2, x 1; s = 4:
  z (32, 4), y (16, 2), x (8, 1) for c = 2·c1 + c2)."""
  for s, (z, y, x), lane in ((2, (5, 2, 7), 3 * 8 + 4 + 0 + 1),
                             (4, (6, 13, 2), 0 * 64 + 32 + 2 + 8)):
    grid = torch.zeros((1, 32, 16, 16), dtype=torch.uint8)
    grid[0, z, y, x] = 1
    out = op.phased_gt(pack_grid(grid), s)
    assert int(out.sum()) == 1
    assert int(out[0, z // s, y // s, lane]) == 1


def test_phased_gt_checks_its_inputs():
  packed = torch.zeros((1, 16, 16, 1), dtype=torch.int32)
  with pytest.raises(ValueError, match="2 or 4"):
    op.phased_gt(packed, 8)
  with pytest.raises(ValueError, match="multiples"):
    op.phased_gt(packed[:, :6], 4)
  with pytest.raises(ValueError, match="int32"):
    op.phased_gt(packed.float(), 2)
