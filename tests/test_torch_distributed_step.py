"""The PyTorch port's training step over 2 processes (gloo, CPU) against
the JAX step on the whole batch and against the port's own one-process
step.

The JAX package's default training branch at 32³ (tests/
test_torch_train_step.py's scenes, flax-initialized weights with random
BatchRenorm statistics): triangles voxelized in the step, the phase loss,
with the fine decoder and with the packed one. Each of 2 ranks steps on
one scene (tests/test_torch_distributed.py::run_ranks); the JAX step and
the port's one-process step take both. Held: the loss and the new
statistics within 1e-4 of JAX and the gradients by the three levels of
tests/test_train_step_grad_parity.py (tests/test_torch_train_step.py::
_assert_step_matches), global_step advanced by the global batch, both
ranks' averaged gradients and parameters after the Adam step equal bit
for bit. Against the port's one-process step on both scenes, run as a
rank is run (a process of its own, one thread): a group of one rank
steps bit for bit as no group does, and the two ranks' loss and
statistics lie within 1e-5 of it and their gradients within the levels
above.
"""

import dataclasses
import hashlib

import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu_torch.utils import tracing
from test_torch_distributed import run_ranks

torch.set_num_threads(2)

RES = (32, 32, 32)
EXECUTIONS = {"fine": {}, "packed": {"packed_decoder": True}}
def _model(execution):
  from corenet_tpu_torch.models.corenet import (
      CoreNet, CoreNetConfig, DecoderConfig)
  return CoreNet(CoreNetConfig(DecoderConfig(RES, 2)), phase_output=True,
                 **EXECUTIONS[execution])


def _count(name: str) -> int:
  """A counter's total (corenet_tpu_torch/utils/tracing.py)."""
  return tracing.counters()[name]


def _digest(tensors):
  h = hashlib.sha256()
  for t in tensors:
    h.update(t.detach().numpy().tobytes())
  return h.hexdigest()


def _step(model, batch, vox_kwargs):
  """One step of the port on `batch` (numpy): the state, the metrics and
  the device collectives the step launched."""
  from corenet_tpu_torch.train.state import create_train_state
  from corenet_tpu_torch.train.step import make_train_step
  state = create_train_state(model, device="cpu")
  step = make_train_step(state.model, state.optimizer, "FG_BG", RES,
                         voxelization_kwargs=vox_kwargs)
  count = _count("mesh.collectives")
  state, metrics = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
  return state, metrics, _count("mesh.collectives") - count


def _run_executions(rank, scenes, state_dict, batch, vox_kwargs,
                    full=True):
  """Each execution's step on `scenes` of the batch; the gradients and
  buffers in full where `full`, else their digests."""
  out = {}
  for execution in EXECUTIONS:
    model = _model(execution)
    model.load_state_dict(state_dict)
    state, metrics, collectives = _step(
        model, {k: v[scenes] for k, v in batch.items()}, vox_kwargs)
    result = {"loss": float(metrics["loss"]),
              "global_step": state.global_step,
              "collectives": collectives,
              "grads_digest": _digest(p.grad for p in model.parameters()),
              "params_digest": _digest(model.parameters())}
    if full:
      result["grads"] = {n: p.grad.numpy()
                         for n, p in model.named_parameters()}
      result["buffers"] = {n: b.numpy() for n, b in model.named_buffers()}
    out[execution] = result
  return out


def step_jobs(rank, world, state_dict, batch, vox_kwargs):
  """Each execution's step on this rank's scene."""
  return _run_executions(rank, slice(rank, rank + 1), state_dict, batch,
                         vox_kwargs, full=rank == 0)


def one_process_jobs(rank, world, state_dict, batch, vox_kwargs, store):
  """Each execution's step on both scenes in one process with no group,
  then in a group of one rank."""
  from corenet_tpu_torch.parallel import mesh
  alone = _run_executions(0, slice(0, 2), state_dict, batch, vox_kwargs)
  mesh.initialize(init_method="file://" + store, rank=0, world_size=1,
                  device="cpu")
  grouped = _run_executions(0, slice(0, 2), state_dict, batch, vox_kwargs,
                            full=False)
  return alone, grouped


@pytest.fixture(scope="module")
def inputs():
  from corenet_tpu_torch.models.convert import state_dict_from_jax
  from test_torch_model import _variables
  from test_torch_train_step import VOX_KWARGS, _triangle_batch
  variables = _variables(RES[0])
  return (variables, dict(state_dict_from_jax(variables)),
          _triangle_batch(), VOX_KWARGS)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, inputs):
  _, state_dict, batch, vox_kwargs = inputs
  return run_ranks(tmp_path_factory.mktemp("step_jobs"),
                   "test_torch_distributed_step", "step_jobs",
                   {"state_dict": state_dict, "batch": batch,
                    "vox_kwargs": vox_kwargs}, timeout=600)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory, inputs):
  """The port's one-process step, run as the ranks are (one thread, a
  process of its own), without a group and in a group of one."""
  _, state_dict, batch, vox_kwargs = inputs
  tmp = tmp_path_factory.mktemp("one_process_jobs")
  return run_ranks(tmp, "test_torch_distributed_step", "one_process_jobs",
                   {"state_dict": state_dict, "batch": batch,
                    "vox_kwargs": vox_kwargs, "store": str(tmp / "store")},
                   world=1, timeout=600, join=False)[0]


@dataclasses.dataclass
class _State:
  global_step: int


def _rank0_model(execution, result):
  """A model holding rank 0's new statistics and averaged gradients."""
  model = _model(execution)
  model.load_state_dict({k: torch.from_numpy(v)
                         for k, v in result["buffers"].items()},
                        strict=False)
  for name, p in model.named_parameters():
    p.grad = torch.from_numpy(result["grads"][name])
  return model


@pytest.mark.parametrize("execution", sorted(EXECUTIONS))
def test_two_rank_step_matches_jax_on_the_whole_batch(inputs, ranks,
                                                      execution):
  from corenet_tpu.models.corenet import CoreNet as JaxCoreNet
  from corenet_tpu.models.corenet import CoreNetConfig as JaxCoreNetConfig
  from corenet_tpu.models.corenet import DecoderConfig as JaxDecoderConfig
  from test_torch_train_step import _assert_step_matches, _jax_step
  variables, _, batch, vox_kwargs = inputs
  jax_model = JaxCoreNet(JaxCoreNetConfig(decoder=JaxDecoderConfig(
      resolution=RES, num_output_channels=2)), phase_output=True,
                         **EXECUTIONS[execution])
  ref = _jax_step(variables, batch, jax_model, vox_kwargs)
  results = [r[execution] for r in ranks]
  for key in ("loss", "global_step", "grads_digest", "params_digest"):
    assert results[0][key] == results[1][key], key
  assert results[0]["global_step"] == 2
  _assert_step_matches(ref, _rank0_model(execution, results[0]),
                       _State(results[0]["global_step"]),
                       {"loss": results[0]["loss"]})


@pytest.mark.parametrize("execution", sorted(EXECUTIONS))
def test_a_group_of_one_steps_as_no_group_does(one_process, execution):
  """One rank in a group runs every collective of the step (BatchRenorm's
  4 per layer in float32: two reduces and their backward; the loss's 2;
  the gradients' 1), and its loss, gradients and parameters after Adam
  are those of the step without a group, bit for bit."""
  alone, grouped = (r[execution] for r in one_process)
  assert alone["collectives"] == 0
  layers = sum(1 for name in alone["buffers"] if name.endswith(".steps"))
  assert grouped["collectives"] == 4 * layers + 2 + 1, grouped["collectives"]
  for key in ("loss", "global_step", "grads_digest", "params_digest"):
    assert grouped[key] == alone[key], key


@pytest.mark.parametrize("execution", sorted(EXECUTIONS))
def test_two_rank_step_matches_the_one_process_step(ranks, one_process,
                                                    execution):
  """Against the port's one-process step on both scenes: the loss and
  the new statistics within 1e-5; the gradients by the levels of
  tests/test_torch_train_step.py, since a train-mode backward at batch 2
  is chaotic (the ranks sum BatchRenorm's statistics in another order, and
  the backward through its layers at a few samples per channel carries
  that rounding to about 10 % of the encoder's gradients, while the
  group of one above is bit-equal)."""
  want, got = one_process[0][execution], ranks[0][execution]
  assert want["global_step"] == got["global_step"] == 2
  tt.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
  for name, value in want["buffers"].items():
    tt.assert_allclose(got["buffers"][name], value, rtol=1e-5,
                       atol=1e-5 * np.abs(value).max(), err_msg=name)
  _assert_gradient_levels(want["grads"], got["grads"])


def _assert_gradient_levels(ref, got):
  """tests/test_torch_train_step.py's three levels, in the port's layout:
  all gradients together at cosine ≥ 0.96, each that carries mass at
  ≥ 0.90, the layers next to the loss within 5 % relative L2."""
  from test_torch_train_step import _feeds_batch_renorm
  allr = np.concatenate([ref[k].ravel() for k in ref]).astype(np.float64)
  allg = np.concatenate([got[k].ravel() for k in ref]).astype(np.float64)
  nr = np.linalg.norm(allr)
  assert allr @ allg / (nr * np.linalg.norm(allg)) >= 0.96
  near_loss = ("decoder.stage_5", "decoder.stage_6", "decoder.rt_skip_5")
  checked = near = 0
  for key, r in ref.items():
    r, g = r.astype(np.float64), got[key].astype(np.float64)
    rn = np.linalg.norm(r)
    if _feeds_batch_renorm(key) or rn < 1e-4 * nr / np.sqrt(len(ref)):
      continue  # ~zero true gradient: both sides hold rounding dust
    assert r.ravel() @ g.ravel() / (rn * np.linalg.norm(g)) >= 0.90, key
    checked += 1
    if key.startswith(near_loss):
      assert np.linalg.norm(g - r) / rn <= 0.05, key
      near += 1
  assert checked > 150 and near >= 10, (checked, near)
