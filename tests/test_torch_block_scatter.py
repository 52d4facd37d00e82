"""The port's block OR-scatter (corenet_tpu_torch/ops/block_scatter.py,
its plain version on the CPU) against the JAX package's Pallas kernel in
interpret mode (corenet_tpu/ops/block_scatter.py), bit for bit."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu.ops.block_scatter import block_scatter_or as jax_scatter
from corenet_tpu_torch.ops import block_scatter as op

H = W = 32


def _origins(rng, b, t, meshes):
  """Seeded origins: random positions, the grid's four corners and edges,
  runs of one origin (as Morton order makes them), repeats far apart,
  and −1 skips."""
  slot = rng.integers(0, meshes, (b, t))
  oy = rng.integers(0, H - 7, (b, t))
  ox = rng.integers(0, W - 7, (b, t))
  o = (slot * H + oy) * W + ox
  corners = [(s * H + y) * W + x for s in range(meshes)
             for y in (0, H - 8) for x in (0, W - 8)]
  o[:, :len(corners)] = corners
  o[:, 20:29] = o[:, 19:20]      # a run of ten
  o[:, 40] = o[:, 3]             # a repeat far from its first
  skip = rng.random((b, t)) < 0.2
  o[skip] = -1
  return o.astype(np.int32)


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_block_scatter_matches_jax(nw, seed):
  rng = np.random.default_rng(seed)
  b, t, meshes = 2, 200 + 37 * seed, 2
  origins = _origins(rng, b, t, meshes)
  pw = rng.integers(0, 2 ** 32, (b, t, 8, 8 * nw), dtype=np.uint64).astype(
      np.uint32)
  pw[rng.random((b, t, 8, 8 * nw)) < 0.5] = 0  # mostly-zero blocks
  pw[origins < 0] = 0  # phase A's contract; the scatter skips them anyway
  want = np.asarray(jax_scatter(jnp.asarray(origins), jnp.asarray(pw),
                                meshes=meshes, h=H, w=W, nw=nw,
                                interpret=True))
  got = op.block_scatter_or(torch.from_numpy(origins),
                            torch.from_numpy(pw.view(np.int32)),
                            meshes=meshes, h=H, w=W, nw=nw)
  assert got.shape == (b, meshes, H, W * nw) and got.dtype == torch.int32
  tt.assert_array_equal(got.numpy().view(np.uint32), want)
  assert (want != 0).mean() > 0.2


def test_block_scatter_skips_blocks_outside_the_grid():
  """-1 and origins whose block would leave the grid write nothing; the
  kernel on the card skips the same ones (tests/test_torch_cuda.py)."""
  nw, meshes = 1, 2
  pw = torch.full((1, 5, 8, 8), -1, dtype=torch.int32)
  origins = torch.tensor([[-1, W - 7, (H - 7) * W, 2 * H * W,
                           (1 * H + 3) * W + 5]], dtype=torch.int32)
  out = op.block_scatter_or(origins, pw, meshes=meshes, h=H, w=W, nw=nw)
  want = torch.zeros((1, meshes, H, W * nw), dtype=torch.int32)
  want[0, 1, 3:11, 5:13] = -1
  assert torch.equal(out, want)


def test_block_scatter_checks_its_inputs():
  origins = torch.zeros((1, 4), dtype=torch.int32)
  pw = torch.zeros((1, 4, 8, 8), dtype=torch.int32)
  with pytest.raises(TypeError):
    op.block_scatter_or(origins.long(), pw, meshes=1, h=H, w=W, nw=1)
  with pytest.raises(ValueError, match="pw"):
    op.block_scatter_or(origins, pw, meshes=1, h=H, w=W, nw=2)
  with pytest.raises(ValueError, match="contiguous"):
    op.block_scatter_or(origins, pw.transpose(2, 3), meshes=1, h=H, w=W,
                        nw=1)
