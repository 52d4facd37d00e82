"""The PyTorch port's depth-sharded layers (the 'space' axis:
corenet_tpu_torch/parallel/mesh.py's halo exchange, models/layers.py and
models/packing.py's `depth_sharded` mode) against the same layers on the
whole tensor, on 2 and 4 gloo processes on the CPU.

Each rank (tests/test_torch_distributed.py::run_ranks) lays the world out
as one space group, runs every layer case on its depth slab of a seeded
input, and backpropagates its slab of a seeded output gradient; the test
process runs the unsharded layer on the whole input. Both run in
float64, so that the comparison sees the sharding and not two float32
summation orders (a bias gradient, a sum of 192 terms of both signs,
parts by 1.4e-6 of its largest value between a slab's sum and the
whole's) nor torch's CPU float32 `conv_transpose3d`, whose weight
gradient is garbage at a depth of 3 and a padding of 3 on one or two
threads. Held, within 1e-6 relative: the slabs put together against the whole output and input gradient, and the
ranks' parameter gradients summed against the whole layer's (each rank's
loss is its slab's share, and the halo's backward carries the neighbours'
terms back); without a group, the whole layer. Cases: fine Conv k3 and
k5, fine ConvTranspose k3 and k7, packed conv and transposed conv, and
`phase_output` on a fine and a packed transposed convolution, each at a
slab as deep as its deepest halo and at a deeper one. Also
`halo_exchange`'s zeros at the grid's ends and its refusal of a halo
deeper than a slab.
"""

import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu_torch.utils import tracing
from test_torch_distributed import run_ranks

# name → (layer class, kwargs, packed). Inputs are (B, C, D, H, W) with
# packed cells along D when packed.
CASES = {
    "conv k3": ("Conv", dict(kernel_size=3, padding=1), False),
    "conv k5": ("Conv", dict(kernel_size=5, padding=2), False),
    "conv_t k3": ("ConvTranspose", dict(kernel_size=3, stride=2, padding=1,
                                        output_padding=1), False),
    "conv_t k7": ("ConvTranspose", dict(kernel_size=7, stride=2, padding=3,
                                        output_padding=1), False),
    "packed conv k3": ("Conv", dict(kernel_size=3, padding=1,
                                    packed_io=True), True),
    "packed conv k5": ("Conv", dict(kernel_size=5, padding=2,
                                    packed_io=True), True),
    "packed conv_t k3": ("ConvTranspose", dict(
        kernel_size=3, stride=2, padding=1, output_padding=1,
        packed_io=True), True),
    "packed conv_t k7": ("ConvTranspose", dict(
        kernel_size=7, stride=2, padding=3, output_padding=1,
        packed_io=True), True),
    "conv_t k7 phase_output": ("ConvTranspose", dict(
        kernel_size=7, stride=2, padding=3, output_padding=1,
        phase_output=True), False),
    "packed conv_t k7 phase_output": ("ConvTranspose", dict(
        kernel_size=7, stride=2, padding=3, output_padding=1,
        packed_io=True, phase_output=True), True),
}
CIN, COUT, HW, BATCH = 3, 2, 4, 2
WORLDS = (2, 4)


def _count(name: str) -> int:
  """A counter's total (corenet_tpu_torch/utils/tracing.py)."""
  return tracing.counters()[name]


def _layer(name, depth_sharded=False):
  from corenet_tpu_torch.models import layers
  cls, kwargs, packed = CASES[name]
  layer = getattr(layers, cls)(CIN, COUT, ndim=3, depth_sharded=depth_sharded,
                               **kwargs)
  layer.reset_parameters(torch.Generator().manual_seed(len(name)))
  return layer.double()


def _slabs(name):
  """The slab depths of a case: its deepest halo, and one more."""
  halo = max(_layer(name).depth_halo)
  return (halo, halo + 1)


def _inputs(name, world, slab):
  """The whole input and output gradient of a case, from a seed."""
  _, kwargs, packed = CASES[name]
  rng = np.random.default_rng([world, slab, len(name)])
  cin = CIN * (8 if packed else 1)
  x = rng.standard_normal((BATCH, cin, world * slab, HW, HW))
  with torch.no_grad():
    y = _layer(name)(torch.from_numpy(x))
  dout = rng.standard_normal(tuple(y.shape))
  return x, dout


def _run(layer, x, dout):
  x = torch.from_numpy(x).requires_grad_(True)
  y = layer(x)
  (y * torch.from_numpy(dout)).sum().backward()
  return (y.detach().numpy(), x.grad.numpy(),
          {n: p.grad.numpy() for n, p in layer.named_parameters()})


def _output_depth_dim(name):
  # phase_output is channel-last: [B, D', H', W', C'].
  return 1 if CASES[name][1].get("phase_output") else 2


def layer_jobs(rank, world):
  """Every case and slab on this rank's depth slab; and the halo
  exchange's ends and refusal."""
  from corenet_tpu_torch.parallel import mesh
  mesh.create_mesh(space=world)
  assert (mesh.data_count(), mesh.space_count(), mesh.space_index(),
          mesh.data_index()) == (1, world, rank, 0)
  out = {}
  for name in CASES:
    for slab in _slabs(name):
      x, dout = _inputs(name, world, slab)
      dim = _output_depth_dim(name)
      oslab = dout.shape[dim] // world
      count = _count("mesh.collectives")
      y, dx, grads = _run(
          _layer(name, depth_sharded=True),
          np.ascontiguousarray(x[:, :, rank * slab:(rank + 1) * slab]),
          np.ascontiguousarray(np.take(
              dout, range(rank * oslab, (rank + 1) * oslab), axis=dim)))
      out[name, slab] = {"y": y, "dx": dx, "grads": grads,
                         "collectives": _count("mesh.collectives") - count}
  # Ends: rank r's slab holds the value r + 1, so its halos hold its
  # neighbours' values and zeros past the grid.
  x = torch.full((1, 1, 2, 1, 1), rank + 1.0, dtype=torch.float64)
  out["halo"] = mesh.halo_exchange(x, 2, 2, 1).flatten().tolist()
  try:
    mesh.halo_exchange(x, 2, 3, 0)
  except ValueError as e:
    out["refusal"] = str(e)
  return out


@pytest.fixture(scope="module", params=WORLDS)
def ranks(request, tmp_path_factory):
  world = request.param
  return world, run_ranks(tmp_path_factory.mktemp(f"space{world}"),
                          "test_torch_space", "layer_jobs", world=world,
                          timeout=300)


def _close(got, want, what):
  tt.assert_allclose(got, want, rtol=1e-6,
                     atol=1e-6 * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_depth_sharded_layer_matches_the_whole_layer(ranks, name):
  world, results = ranks
  dim = _output_depth_dim(name)
  for slab in _slabs(name):
    x, dout = _inputs(name, world, slab)
    y, dx, grads = _run(_layer(name), x, dout)
    got = [r[name, slab] for r in results]
    what = f"{name}, {world} ranks, slab {slab}"
    _close(np.concatenate([g["y"] for g in got], axis=dim), y, what)
    _close(np.concatenate([g["dx"] for g in got], axis=2), dx, what)
    for key, value in grads.items():
      _close(sum(g["grads"][key] for g in got), value, f"{what}: {key}")
    # One halo all-reduce forward and one backward per layer call.
    assert [g["collectives"] for g in got] == [2] * world, what


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_depth_sharded_layer_alone_is_the_whole_layer(name):
  """Without a space group a depth-sharded layer's halos are the zero
  padding of the grid's ends: it computes the whole layer."""
  x, dout = _inputs(name, 1, max(_slabs(name)))
  want, got = _run(_layer(name), x, dout), _run(_layer(name, True), x, dout)
  for w, g in ((want[0], got[0]), (want[1], got[1])):
    _close(g, w, name)
  for key, value in want[2].items():
    _close(got[2][key], value, f"{name}: {key}")


def test_halo_exchange_zero_ends_and_refusal(ranks):
  world, results = ranks
  for rank, r in enumerate(results):
    below = [float(rank)] * 2 if rank > 0 else [0.0] * 2
    above = [rank + 2.0] if rank < world - 1 else [0.0]
    assert r["halo"] == below + [rank + 1.0] * 2 + above, (rank, r["halo"])
    assert "nearest space ranks" in r["refusal"]


def test_the_stage_rule():
  """The first tower that splits into whole slabs at least as deep as its
  halos and every later one's, and the refusal of a grid with none."""
  from corenet_tpu_torch.models.corenet import (
      CoreNet, CoreNetConfig, DecoderConfig)
  from corenet_tpu_torch.models.decoder import shard_stage
  assert shard_stage(4, 2, 2, 7) == 2  # 128³ fine, space 2
  assert shard_stage(4, 2, 2, 2) == 2  # 128³ packed from stage 2
  assert shard_stage(4, 4, 2, 2) == 3  # 128³ packed, space 4
  assert shard_stage(1, 2, 2, 7) == 4  # 32³ fine, space 2
  with pytest.raises(ValueError, match="no tower"):
    CoreNet(CoreNetConfig(DecoderConfig((32, 32, 32), 2)),
            depth_shard=(0, 16), device="meta")
  with pytest.raises(ValueError, match="index < count"):
    CoreNet(CoreNetConfig(DecoderConfig((32, 32, 32), 2)),
            depth_shard=(2, 2), device="meta")
