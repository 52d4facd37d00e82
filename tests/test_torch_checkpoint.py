"""The port's `.cpt` checkpoints (corenet_tpu_torch/train/checkpoint.py and
its msgpack codec, train/flax_msgpack.py) against the JAX package's, on the
CPU.

A tiny CoreNet (32³, the flax weights of tests/test_torch_model.py) takes
one step of optax's Adam on seeded gradients, with its BatchRenorm
statistics moved and their step counters at 1 (the step's own gradients
and statistics are held to JAX's in tests/test_torch_train_step.py; a
compiled JAX step would take most of this file's time);
`corenet_tpu.train.checkpoint` writes that state and the port restores it
into its own model and torch Adam. The restored model's logits equal the
bridged model's, and one more Adam step in each package, on the same
seeded gradients, agrees within the tolerances of
tests/test_torch_train_step.py::test_adam_matches_optax: 1e-6 relative,
plus 1e-6 of the largest parameter magnitude (the model's, since CoreNet's
biases start at zero). The port's bytes restore through JAX's
`decode_state(data, template)` to equal arrays, bit for bit; the codec
re-encodes flax's bytes unchanged.
"""

import functools
import os

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import numpy.testing as tt
import optax
import pytest
import torch

from corenet_tpu.train import checkpoint as jax_cpt
from corenet_tpu.train import state as jax_state
from corenet_tpu_torch.models.batch_renorm import BatchRenorm
from corenet_tpu_torch.models.convert import (
    adam_state_to_jax, jax_variables_from_state_dict, state_dict_from_jax)
from corenet_tpu_torch.models.corenet import (
    CoreNet, CoreNetConfig, DecoderConfig)
from corenet_tpu_torch.models.layers import Linear
from corenet_tpu_torch.train import checkpoint as cpt
from corenet_tpu_torch.train import flax_msgpack
from corenet_tpu_torch.train.state import create_train_state
from test_torch_model import BATCH, _scene, _variables

torch.set_num_threads(2)

RES = (32, 32, 32)
META = {"classes": ["__void__", "a"], "full_config": {"x": [1, 2.5, None]}}


def _numpy(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _gradients(seed):
  """Seeded gradients shaped like the params (the JAX tree)."""
  rng = np.random.default_rng(seed)
  return jax.tree_util.tree_map(
      lambda p: rng.standard_normal(p.shape).astype(np.float32) * 1e-2,
      _numpy(_variables(32)["params"]))


def _adam_step(state, grads):
  """One optax Adam step of a JAX TrainState on numpy gradients."""
  updates, opt_state = jax_state.create_optimizer().update(
      jax.tree_util.tree_map(jnp.asarray, grads), state.opt_state,
      state.params)
  return state.replace(params=optax.apply_updates(state.params, updates),
                       opt_state=opt_state,
                       global_step=state.global_step + BATCH)


@functools.lru_cache(maxsize=None)
def _jax_checkpoint():
  """(JAX TrainState after one step, its .cpt bytes)."""
  state = _adam_step(_template(), _gradients(2))
  rng = np.random.default_rng(3)

  def moved(path, value):
    if path[-1].key == "steps":
      return np.ones_like(value)
    return value + rng.normal(0, 0.01, value.shape).astype(value.dtype)

  state = state.replace(batch_stats=jax.tree_util.tree_map_with_path(
      moved, _numpy(state.batch_stats)))
  state = jax.device_get(state)
  return state, jax_cpt.encode_state(state, META)


def _port_state():
  """A port TrainState with an uninitialized CPU model and fresh Adam."""
  return create_train_state(CoreNet(CoreNetConfig(DecoderConfig(RES, 2))),
                            device="cpu")


def _logits(model):
  image, v2s, offsets = _scene(RES[0])
  with torch.inference_mode():
    return model.eval()(torch.from_numpy(image), torch.from_numpy(v2s),
                        torch.from_numpy(offsets))


def test_jax_checkpoint_restores_in_the_port_and_trains_on():
  jax_state_1, data = _jax_checkpoint()
  assert int(jax_state_1.opt_state[0].count) == 1
  state, meta = cpt.decode_state(data, _port_state())
  assert meta == META and state.global_step == BATCH
  assert state.model.decoder.stage_1_bn.steps.dtype == torch.int32

  bridged = CoreNet(CoreNetConfig(DecoderConfig(RES, 2)))
  bridged.load_state_dict(state_dict_from_jax(
      {"params": _numpy(jax_state_1.params),
       "batch_stats": _numpy(jax_state_1.batch_stats)}))
  assert torch.equal(_logits(state.model), _logits(bridged))

  # One more Adam step in each package on the same gradients.
  grads = _gradients(0)
  jax_state_2 = _adam_step(jax_state_1, grads)
  opt_state = jax_state_2.opt_state
  want = state_dict_from_jax({"params": _numpy(jax_state_2.params)})
  scale = max(float(v.abs().max()) for v in want.values())
  torch_grads = state_dict_from_jax({"params": grads})
  for name, p in state.model.named_parameters():
    p.grad = torch_grads[name]
  state.optimizer.step()
  before = state_dict_from_jax({"params": _numpy(jax_state_1.params)})
  for name, p in state.model.named_parameters():
    ref = want[name].numpy()
    tt.assert_allclose(p.detach().numpy(), ref, rtol=1e-6,
                       atol=1e-6 * scale, err_msg=name)
    assert state.optimizer.state[p]["step"] == 2
  # The step moved the parameters by about lr where the gradients were.
  moved = max(float((p.detach() - before[n]).abs().max())
              for n, p in state.model.named_parameters())
  assert 2e-4 < moved < 1e-3
  mu = state_dict_from_jax({"params": _numpy(opt_state[0].mu)})
  nu = state_dict_from_jax({"params": _numpy(opt_state[0].nu)})
  for name, p in state.model.named_parameters():
    st = state.optimizer.state[p]
    for key, ref in (("exp_avg", mu[name]), ("exp_avg_sq", nu[name])):
      tt.assert_allclose(st[key].numpy(), ref.numpy(), rtol=1e-6,
                         atol=1e-6 * float(ref.abs().max()), err_msg=name)


@functools.lru_cache(maxsize=None)
def _template():
  """The JAX TrainState of the flax weights with optax's initial state."""
  optimizer = jax_state.create_optimizer()
  return jax_state.create_train_state(
      jax.tree_util.tree_map(jnp.asarray, _variables(32)), optimizer)


def _assert_trees_equal(got, want):
  got_leaves, got_def = jax.tree_util.tree_flatten_with_path(got)
  want_leaves, want_def = jax.tree_util.tree_flatten_with_path(want)
  assert got_def == want_def
  for (path, a), (_, b) in zip(got_leaves, want_leaves):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    assert np.array_equal(a, b), jax.tree_util.keystr(path)


def test_port_checkpoint_restores_in_jax_bit_for_bit():
  # JAX → port → JAX: the port re-encodes the JAX state losslessly.
  jax_state_1, data = _jax_checkpoint()
  state, _ = cpt.decode_state(data, _port_state())
  back, meta = jax_cpt.decode_state(cpt.encode_state(state, META),
                                    _template())
  assert meta == META and int(back.global_step) == BATCH
  for field in ("params", "batch_stats", "opt_state"):
    _assert_trees_equal(getattr(back, field), getattr(jax_state_1, field))

  # A port state after its own step: JAX reads its weights and moments.
  grads = state_dict_from_jax({"params": _gradients(1)})
  for name, p in state.model.named_parameters():
    p.grad = grads[name]
  state.optimizer.step()
  state = cpt.dataclasses.replace(state, global_step=2 * BATCH)
  back, _ = jax_cpt.decode_state(cpt.encode_state(state, META), _template())
  assert int(back.global_step) == 2 * BATCH
  variables = jax_variables_from_state_dict(state.model.state_dict())
  _assert_trees_equal(back.params, variables["params"])
  _assert_trees_equal(back.batch_stats, variables["batch_stats"])
  adam = adam_state_to_jax(state.model, state.optimizer)["0"]
  assert int(back.opt_state[0].count) == 2 and adam["count"].dtype == np.int32
  _assert_trees_equal(back.opt_state[0].mu, adam["mu"])
  _assert_trees_equal(back.opt_state[0].nu, adam["nu"])


def test_fresh_states_map_to_each_other():
  """A fresh torch Adam is optax's initial state (count 0, zero moments),
  and JAX's initial state loads into torch as one."""
  model = CoreNet(CoreNetConfig(DecoderConfig(RES, 2)))
  model.load_state_dict(state_dict_from_jax(_variables(32)))
  state = create_train_state(model, device="cpu")
  back, _ = jax_cpt.decode_state(cpt.encode_state(state), _template())
  _assert_trees_equal(back.opt_state, _numpy(_template().opt_state))
  restored, meta = cpt.decode_state(jax_cpt.encode_state(_template()),
                                    _port_state())
  assert meta == {} and restored.global_step == 0
  p = next(restored.model.parameters())
  assert restored.optimizer.state[p]["step"] == 0
  assert not restored.optimizer.state[p]["exp_avg"].any()


class _Tiny(torch.nn.Module):
  """A two-layer stand-in for CoreNet with its naming conventions (a
  Linear's weight and bias, a BatchRenorm's statistics), so that the file
  handling below writes small files."""

  def __init__(self, seed):
    super().__init__()
    gen = torch.Generator().manual_seed(seed)
    self.dense = Linear(3, 4)
    self.dense.reset_parameters(gen)
    self.bn = BatchRenorm(4)


def test_checkpoint_tiers_pruning_and_names(tmp_path):
  """As tests/test_train_eval.py::test_checkpoint_roundtrip_and_tiers."""
  state = create_train_state(_Tiny(0), global_step=123, device="cpu")
  mgr = cpt.CheckpointManager(str(tmp_path / "cpt"), keep_temp=2)
  path = mgr.save_state(state, META)
  assert path.endswith(os.path.join("temp", "state_000000123.cpt"))
  target = create_train_state(_Tiny(1), device="cpu")
  loaded, meta, last = mgr.read_last_checkpoint(target)
  assert loaded.global_step == 123 and meta == META and last == path
  for name, value in loaded.model.state_dict().items():
    assert torch.equal(value, state.model.state_dict()[name]), name
  # The JAX package reads the same file into its own tree.
  raw, _ = jax_cpt.decode_state(open(path, "rb").read())
  tt.assert_array_equal(raw.params["dense"]["kernel"],
                        state.model.dense.weight.detach().numpy().T)
  assert raw.batch_stats["bn"]["steps"].dtype == np.int32

  for s in (200, 300, 400):
    mgr.save_state(cpt.dataclasses.replace(state, global_step=s), META)
  mgr.save_state(cpt.dataclasses.replace(state, global_step=250), META,
                 persistent=True)
  temp = [p for p in mgr.list_checkpoints() if "/temp/" in p]
  assert [int(os.path.basename(p)[6:-4]) for p in temp] == [300, 400]
  persistent = [p for p in mgr.list_checkpoints() if "/persistent/" in p]
  assert [int(os.path.basename(p)[6:-4]) for p in persistent] == [250]
  assert not any(name.endswith(".tmp")
                 for name in os.listdir(tmp_path / "cpt" / "temp"))
  # The newest overall wins; the JAX reader sees the same files.
  raw, meta, last = cpt.CheckpointReader(str(tmp_path / "cpt")
                                         ).read_last_checkpoint()
  assert last.endswith("state_000000400.cpt") and meta == META
  assert isinstance(raw, cpt.RawState) and raw.global_step == 400
  assert jax_cpt.CheckpointReader(str(tmp_path / "cpt")
                                  ).last_checkpoint_path() == last
  assert cpt.CheckpointReader(str(tmp_path / "empty")
                              ).read_last_checkpoint() is None
  with pytest.raises(ValueError, match="not a corenet-tpu checkpoint"):
    cpt.decode_state(b"CORENET-TPU-CPT0" + bytes(8))


# Every msgpack type flax's bytes may hold, at each of its widths.
CODEC_CASES = {
    "nil": None, "true": True, "false": False,
    "positive_fixint": 127, "uint8": 255, "uint16": 65535,
    "uint32": 2 ** 32 - 1, "uint64": 2 ** 64 - 1,
    "negative_fixint": -32, "int8": -128, "int16": -32768,
    "int32": -2 ** 31, "int64": -2 ** 63,
    "float64": -1.25e-300,
    "fixstr": "kernel", "str8": "é" * 40, "str16": "x" * 300,
    "bin8": b"\x00\xff" * 10, "bin16": bytes(range(256)) * 2,
    "fixarray": [1, "a", None], "array16": list(range(20)),
    "fixmap": {"mean": 1.0}, "map16": {str(i): i for i in range(20)},
    "empty_map": {},
    "ndarray_f32": np.arange(12, dtype=np.float32).reshape(3, 4),
    "ndarray_f32_strided": np.arange(12, dtype=np.float32).reshape(3, 4).T,
    "ndarray_0d_int32": np.asarray(7, np.int32),
    "ndarray_empty": np.zeros((0, 3), np.float32),
    "ndarray_bool": np.array([True, False, True]),
    "ndarray_u8": np.arange(256, dtype=np.uint8),
    "ndarray_i64_f64": [np.arange(3, dtype=np.int64),
                        np.linspace(0, 1, 5)],
    "ndarray_ext32": np.ones(70_000, np.float32),
    "npscalar_f32": np.float32(2.5), "npscalar_i32": np.int32(-3),
    "tree": {"params": {"dense": {"kernel": np.ones((2, 3), np.float32)}},
             "opt_state": {"0": {"count": np.asarray(1, np.int32)}, "1": {}}},
}


def _assert_same(got, want):
  assert type(got) is type(want) or (
      isinstance(want, (bytes, bytearray)) and bytes(got) == want), (
          type(got), type(want))
  if isinstance(want, dict):
    assert list(got) == list(want)
    for key in want:
      _assert_same(got[key], want[key])
  elif isinstance(want, list):
    assert len(got) == len(want)
    for a, b in zip(got, want):
      _assert_same(a, b)
  elif isinstance(want, (np.ndarray, np.generic)):
    assert got.dtype == want.dtype and np.shape(got) == np.shape(want)
    assert np.array_equal(got, want)
  elif not isinstance(want, (bytes, bytearray)):
    assert got == want


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_codec_matches_flax_msgpack(case):
  value = CODEC_CASES[case]
  flax_bytes = msgpack.packb(value, default=flax.serialization._msgpack_ext_pack,
                             strict_types=True)
  assert flax_msgpack.packb(value) == flax_bytes
  _assert_same(flax_msgpack.unpackb(flax_bytes),
               flax.serialization.msgpack_restore(flax_bytes))


def test_codec_reads_float32_and_rejects_what_flax_never_writes(monkeypatch):
  assert flax_msgpack.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
  # A leaf over flax's chunk size (2**30 bytes, made small here) is split
  # into chunks: the codec refuses it.
  monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
  chunked = flax.serialization.msgpack_serialize(
      {"w": np.zeros(100, np.float32)})
  with pytest.raises(ValueError, match="chunked"):
    flax_msgpack.unpackb(chunked)
  with pytest.raises(ValueError, match="extension type 2"):
    flax_msgpack.unpackb(msgpack.packb(msgpack.ExtType(2, b"ab")))
  with pytest.raises(ValueError, match="truncated"):
    flax_msgpack.unpackb(msgpack.packb("abcdef")[:-2])
  with pytest.raises(TypeError):
    flax_msgpack.packb({"x": object()})
