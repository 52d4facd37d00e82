"""The plan of the skip gather's backward kernel
(corenet_tpu_torch/ops/skip_gather.py: `backward_walk`, `walk_voxels`,
`walk_flushes`), which the CUDA kernel in csrc/skip_gather.cu follows
thread for thread.

In the packed decoder's voxel order (8 phase grids of half the
resolution, phase-outer) a thread walks both z phases of a fine depth
column, so the walk covers every voxel once, in fine z order within each
thread, and its runs of equal pixels and its flushes are the fine
order's on the same voxels; walking one phase per thread, as the kernel
did before, flushes more. The kernel's sums themselves are held against
the plain version on the card (tests/test_torch_cuda.py) and the plain
version against `jax.vjp` of the Pallas kernel
(tests/test_torch_packing.py).
"""

import numpy as np
import pytest
import torch

from corenet_tpu_torch.models import skip
from corenet_tpu_torch.ops import skip_gather as op
from corenet_tpu_torch.train.step import compute_v2s

# The fine grids of the h7 decoder's four skips; packed, each is 8 phase
# grids of half its resolution.
H7_SKIP_GRIDS = [8, 16, 32, 64]


def _fine_coordinates(voxel, half):
  """Fine (z, y, x) of positions in the packed order's 8 · N voxels."""
  d, h, w = half
  phase, rest = voxel // (d * h * w), voxel % (d * h * w)
  pz, py, px = phase // 4, phase // 2 % 2, phase % 2
  z, y, x = rest // (h * w), rest // w % h, rest % w
  return 2 * z + pz, 2 * y + py, 2 * x + px


@pytest.mark.parametrize("chunk", ["wrapper", 3])
@pytest.mark.parametrize("res", H7_SKIP_GRIDS)
def test_packed_walk_covers_every_voxel_once_in_fine_z_order(res, chunk):
  half = (res // 2,) * 3
  walk = op.backward_walk(8, half)
  assert walk == (2, 4, res, (res // 2) ** 2, max(1, res // 4))
  if chunk != "wrapper":
    walk = walk._replace(z_chunk=chunk)  # odd: chunks split z pairs
  voxels = op.walk_voxels(walk)
  assert voxels.shape == (walk.lanes * walk.chunks * walk.columns,
                          walk.z_chunk)
  valid = voxels >= 0
  assert torch.equal(voxels[valid].sort().values, torch.arange(res ** 3))
  # −1 only past the end of a short last chunk.
  assert bool((valid[:, 1:] <= valid[:, :-1]).all())
  z, y, x = _fine_coordinates(voxels.clamp(min=0), half)
  # Each thread stays on one fine column and steps one fine voxel at a
  # time along z, from the start of its chunk.
  for coord in (y, x):
    same = coord == coord[:, :1]
    assert bool(same[valid].all())
  chunk_index = torch.arange(voxels.shape[0]) // walk.columns % walk.chunks
  expected_z = chunk_index[:, None] * walk.z_chunk + torch.arange(
      walk.z_chunk)
  assert torch.equal(z[valid], expected_z[valid])
  # Consecutive threads take consecutive columns of one lane's phase grid.
  lane = (voxels[:, 0] // (res // 2) ** 3) % 4
  assert torch.equal(lane, torch.arange(voxels.shape[0]) // (
      walk.chunks * walk.columns))


@pytest.mark.parametrize("res", H7_SKIP_GRIDS)
def test_fine_walk_is_the_column_walk(res):
  walk = op.backward_walk(1, (res,) * 3)
  assert walk == (1, 1, res, res * res, max(1, res // 4))
  voxels = op.walk_voxels(walk)
  thread = torch.arange(voxels.shape[0])
  chunk, column = thread // (res * res), thread % (res * res)
  z = chunk[:, None] * walk.z_chunk + torch.arange(walk.z_chunk)
  assert torch.equal(voxels, z * res * res + column[:, None])


def test_walk_plans_and_refusals():
  # Any phase count other than the packed decoder's 8 walks each phase
  # alone; one phase at a time stays available for 8.
  assert op.backward_walk(4, (4, 6, 6)) == (1, 4, 4, 36, 1)
  assert op.backward_walk(8, (32,) * 3, z_phases=1) == (1, 8, 32, 1024, 8)
  with pytest.raises(ValueError):
    op.backward_walk(3, (4, 4, 4), z_phases=2)
  with pytest.raises(ValueError):
    op.backward_walk(8, (4, 4, 4), z_phases=4)


def test_walk_flushes_counts_runs_per_chunk_and_channel_group():
  # One column of 8 voxels: pixels 5 5 5 7 7 5 5 5, chunks of 2.
  walk = op.BackwardWalk(1, 1, 8, 1, 2)
  px = torch.tensor([[5, 5, 5, 7, 7, 5, 5, 5]], dtype=torch.int32)
  py = torch.zeros_like(px)
  # Runs along the whole column: 3; within chunks of 2 (5 5 | 5 7 | 7 5 |
  # 5 5): 1 + 2 + 2 + 1.
  mean_run, flushes = op.walk_flushes(px, py, 10, walk, 12)
  assert mean_run == 8 / 3
  assert flushes == 6 * 3  # 3 groups of 4 channels
  _, flushes = op.walk_flushes(px, py, 10, walk, 6)
  assert flushes == 6 * 3  # 3 groups of 2 channels
  _, flushes = op.walk_flushes(px, py, 10, walk._replace(z_chunk=3), 5)
  assert flushes == (1 + 2 + 1) * 5  # 5 5 5 | 7 7 5 | 5 5


def _seeded_camera(seed, res, batch=2):
  """voxel → screen matrices of seeded perspective cameras in front of
  the voxel box, the skip's indices at fine resolution `res`."""
  rng = np.random.default_rng(seed)
  near, far = 0.5, 3.0
  a, b = (far + near) / (far - near), -2 * far * near / (far - near)
  cams = []
  for _ in range(batch):
    f = rng.uniform(1.6, 2.2)
    dx, dy = rng.uniform(-0.1, 0.1, 2)
    cams.append([[f, 0, 0, -0.5 * f + dx], [0, f, 0, -0.5 * f + dy],
                 [0, 0, a, a + b], [0, 0, 1, 1.0]])
  camera = torch.tensor(cams, dtype=torch.float32)
  v2x = torch.diag(torch.tensor([float(res)] * 3 + [1.0])).expand(
      batch, 4, 4)
  return compute_v2s(camera, v2x)


@pytest.mark.parametrize("c", [12, 24])
@pytest.mark.parametrize("res", [32, 64])
def test_packed_walk_flushes_as_the_fine_order(res, c):
  """On a seeded camera, the packed walk's runs along z and flushes equal
  the fine order's on the same voxels; one phase per thread has shorter
  runs and more flushes."""
  matrix = _seeded_camera(res, res)
  sample = torch.full((2, 3), 0.5)
  fine, half = (res,) * 3, (res // 2,) * 3
  h2 = res + 2
  px, py = skip.voxel_pixel_indices(matrix, sample, fine, res, res,
                                    packed=True)
  fine_px, fine_py = skip.voxel_pixel_indices(matrix, sample, fine, res, res)
  packed = op.walk_flushes(px, py, h2, op.backward_walk(8, half), c)
  fine_order = op.walk_flushes(fine_px, fine_py, h2,
                               op.backward_walk(1, fine), c)
  phase_by_phase = op.walk_flushes(
      px, py, h2, op.backward_walk(8, half, z_phases=1), c)
  assert packed == fine_order
  # Perspective moves a column's pixel every few voxels along z.
  assert 2.5 < packed[0] < 8
  assert phase_by_phase[0] < 0.7 * packed[0]
  assert phase_by_phase[1] > 1.4 * packed[1]
