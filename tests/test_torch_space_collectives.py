"""The 'space' axis's exchanges (corenet_tpu_torch/parallel/mesh.py),
`space_all_to_all` and `halo_exchange`, each an all-reduce of a zeroed
buffer with one slot per rank, on 2 and 4 gloo processes on the CPU.

Held, bit for bit: the all-to-all against the row permutation it stands
for (float32, uint8 and int32 rows); each halo exchange (`lo` and `hi` of
0, 1 and the slab's depth) against its definition computed here from
every rank's seeded slab, forward (the neighbours' slices, zeros past the
grid's ends) and backward (the adjoint: each halo's gradient added back
to the neighbour's slices it came from, in the order the backward adds
them). The collectives are counted: one all-reduce per all-to-all, one
per halo exchange forward and one backward, none for two empty halos.
"""

import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu_torch.utils import tracing
from test_torch_distributed import run_ranks

WORLDS = (2, 4)
SLAB = 3
HALOS = [(lo, hi) for lo in (0, 1, SLAB) for hi in (0, 1, SLAB)]
ROW = (2, 5)  # the all-to-all's row shape
DTYPES = ("float32", "uint8", "int32")


def _count(name: str) -> int:
  """A counter's total (corenet_tpu_torch/utils/tracing.py)."""
  return tracing.counters()[name]


def _rows(world, rank, dtype):
  """Rank `rank`'s all-to-all input: row j goes to rank j."""
  rng = np.random.default_rng([world, rank, DTYPES.index(dtype)])
  return (rng.standard_normal((world,) + ROW) * 100).astype(dtype)


def _slab(world, rank):
  rng = np.random.default_rng([world, rank, 7])
  x = rng.standard_normal((2, 3, SLAB, 2, 2))
  douts = {(lo, hi): rng.standard_normal((2, 3, lo + SLAB + hi, 2, 2))
           for lo, hi in HALOS}
  return x, douts


def exchange_jobs(rank, world):
  """Every all-to-all and halo case on this rank, with its collectives."""
  from corenet_tpu_torch.parallel import mesh
  mesh.create_mesh(space=world)
  out = {}
  for dtype in DTYPES:
    count = _count("mesh.collectives")
    got = mesh.space_all_to_all(torch.from_numpy(_rows(world, rank, dtype)))
    out["a2a", dtype] = (got.numpy(), _count("mesh.collectives") - count)
  x, douts = _slab(world, rank)
  for lo, hi in HALOS:
    xt = torch.from_numpy(x).requires_grad_(True)
    count = _count("mesh.collectives")
    y = mesh.halo_exchange(xt, 2, lo, hi)
    (y * torch.from_numpy(douts[lo, hi])).sum().backward()
    out["halo", lo, hi] = (y.detach().numpy(), xt.grad.numpy(),
                           _count("mesh.collectives") - count)
  try:
    mesh.space_all_to_all(torch.zeros(world + 1))
  except ValueError as e:
    out["refusal"] = str(e)
  return out


@pytest.fixture(scope="module", params=WORLDS)
def ranks(request, tmp_path_factory):
  world = request.param
  return world, run_ranks(tmp_path_factory.mktemp(f"exchange{world}"),
                          "test_torch_space_collectives", "exchange_jobs",
                          world=world, timeout=300)


@pytest.mark.parametrize("dtype", DTYPES)
def test_all_to_all_is_the_row_permutation(ranks, dtype):
  world, results = ranks
  for rank, r in enumerate(results):
    got, collectives = r["a2a", dtype]
    want = np.stack([_rows(world, i, dtype)[rank] for i in range(world)])
    assert got.dtype == want.dtype and np.array_equal(got, want), rank
    assert collectives == 1, collectives
  assert all("takes [" in r["refusal"] for r in results)


def _halo_reference(world, lo, hi):
  """Each rank's extended slab and input gradient by the definition."""
  slabs = [_slab(world, r) for r in range(world)]
  ys, dxs = [], []
  for r, (x, douts) in enumerate(slabs):
    below = (slabs[r - 1][0][:, :, SLAB - lo:] if r > 0
             else np.zeros_like(x[:, :, :lo]))
    above = (slabs[r + 1][0][:, :, :hi] if r < world - 1
             else np.zeros_like(x[:, :, :hi]))
    ys.append(np.concatenate([below, x, above], 2))
    dx = douts[lo, hi][:, :, lo:lo + SLAB].copy()
    if r > 0:  # the previous rank's halo above is this rank's first hi
      dx[:, :, :hi] += slabs[r - 1][1][lo, hi][:, :, lo + SLAB:]
    if r < world - 1:  # the next rank's halo below is this rank's last lo
      dx[:, :, SLAB - lo:] += slabs[r + 1][1][lo, hi][:, :, :lo]
    dxs.append(dx)
  return ys, dxs


@pytest.mark.parametrize("lo,hi", HALOS)
def test_halo_exchange_is_its_definition(ranks, lo, hi):
  world, results = ranks
  ys, dxs = _halo_reference(world, lo, hi)
  for rank, r in enumerate(results):
    y, dx, collectives = r["halo", lo, hi]
    tt.assert_array_equal(y, ys[rank], err_msg=f"y, rank {rank}")
    tt.assert_array_equal(dx, dxs[rank], err_msg=f"dx, rank {rank}")
    assert collectives == (0 if lo == hi == 0 else 2), collectives
