"""The PyTorch port's training step on a (data, space) layout (gloo, CPU)
against the JAX package's one-device step and the port's one-process
step, on the same scenes and weights.

The 'space' axis (corenet_tpu_torch/parallel/mesh.py::create_mesh): the
space ranks of a data group step on the same batch, each with a
depth-sharded model (`CoreNet(depth_shard=...)`) on its slab of the
labels; the decoder exchanges halos, the IoU sums each scene over the
space group. Cases at 32³ (tests/test_torch_train_step.py's scenes and
flax-initialized weights with random BatchRenorm statistics):

- "fgbg": float32 FG_BG with the phase loss, triangles voxelized in the
  step (the fine decoder shards from tower 4), on data 1 × space 2;
- "semantic": float32 SEMANTIC on a labeled grid of three classes whose
  labels part at the slab boundary, on data 1 × space 2;
- "fgbg" on data 2 × space 2 (4 ranks, a scene per data group).

Held, as tests/test_torch_distributed_step.py holds data parallelism:
the loss and new statistics within 1e-4 of JAX's step and the gradients
by the three levels of tests/test_train_step_grad_parity.py; against the
port's one-process step, run as a rank is run, the loss and statistics
within 1e-5 and the gradients by the same levels; every rank's loss,
averaged gradients and parameters after Adam bit-equal; global_step
advanced by the global batch. The collectives per step are counted: the
data-parallel ones, plus two halo all-reduces (forward and backward) per
sharded convolution, two for each IoU's sums over the space group, and
the FG_BG labels' all-to-all (shared over the space group:
tests/test_torch_space_gt.py, _step_shared.py). A group laid out with
space 1 steps bit for bit as no group does. The packed decoder and bf16
are in tests/test_torch_space_step_{packed,bf16}.py.
"""

import hashlib

import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu_torch.utils import tracing
from test_torch_distributed import run_ranks

torch.set_num_threads(2)

RES = (32, 32, 32)
SEMANTIC_CLASSES = 3


def _count(name: str) -> int:
  """A counter's total (corenet_tpu_torch/utils/tracing.py)."""
  return tracing.counters()[name]


def _routes() -> dict:
  """The labels' routes taken so far (train/gt.py::labels_slab)."""
  counts = tracing.counters()
  return {route: counts[f"gt.route.{route}"]
          for route in ("space_shared", "replicated")}


def _digest(tensors):
  h = hashlib.sha256()
  for t in tensors:
    h.update(t.detach().float().numpy().tobytes())
  return h.hexdigest()


def _delta(counts, before):
  """The counts that moved since `before`."""
  return {k: v - before.get(k, 0) for k, v in counts.items()
          if v != before.get(k, 0)}


def _model(case, depth_shard=None):
  from corenet_tpu_torch.models.corenet import (
      CoreNet, CoreNetConfig, DecoderConfig)
  return CoreNet(CoreNetConfig(DecoderConfig(case["res"], case["channels"])),
                 depth_shard=depth_shard, **case["model"])


def step_case(case, scenes, depth_shard=None, full=True):
  """The port's step from the case's weights on `scenes` of each of its
  batches: the losses and (`full`) each batch's gradients; for the first
  batch the global step, the device collectives, digests of the gradients
  and parameters after Adam, and (`full`) its gradients and new
  statistics."""
  from corenet_tpu_torch.train.state import create_train_state
  from corenet_tpu_torch.train.step import make_train_step
  out = {"losses": []}
  for i, batch in enumerate(case["batches"]):
    model = _model(case, depth_shard)
    model.load_state_dict(case["state_dict"])
    state = create_train_state(model, device="cpu")
    step = make_train_step(state.model, state.optimizer, case["task"],
                           case["res"],
                           voxelization_kwargs=case["vox_kwargs"])
    count = _count("mesh.collectives")
    routes = _routes()
    state, metrics = step(state, {k: torch.from_numpy(v[scenes])
                                  for k, v in batch.items()})
    out["losses"].append(float(metrics["loss"]))
    if full:
      grads = {n: p.grad.float().numpy() for n, p in model.named_parameters()}
      out.setdefault("batch_grads", []).append(grads)
    if i:
      continue
    out.update(global_step=state.global_step,
               collectives=_count("mesh.collectives") - count,
               routes=_delta(_routes(), routes),
               grads_digest=_digest(p.grad for p in model.parameters()),
               params_digest=_digest(model.parameters()),
               buffers_digest=_digest(model.buffers()),
               shard_stage=model.decoder.shard_stage)
    if full:
      out["grads"] = grads
      out["buffers"] = {n: b.numpy() for n, b in model.named_buffers()}
  return out


def space_jobs(rank, world, cases, space):
  """Each case on this rank: its data group's scenes, its depth slab."""
  from corenet_tpu_torch.parallel import mesh
  mesh.create_mesh(space=space)
  out = {}
  for name, case in cases.items():
    per = case["batches"][0]["image"].shape[0] // mesh.data_count()
    lo = mesh.data_index() * per
    out[name] = step_case(case, slice(lo, lo + per),
                          (mesh.space_index(), space), full=rank == 0)
  return out


def one_process_jobs(rank, world, cases, store):
  """Each case on all its scenes in one process with no group; then the
  first in a group of one laid out with space 1."""
  from corenet_tpu_torch.parallel import mesh
  alone = {name: step_case(case, slice(None)) for name, case in cases.items()}
  mesh.initialize(init_method="file://" + store, rank=0, world_size=1,
                  device="cpu")
  mesh.create_mesh(data=1, space=1)
  first = next(iter(cases))
  grouped = step_case(cases[first], slice(None), depth_shard=(0, 1),
                      full=False)
  return alone, grouped


def run_cases(tmp_path_factory, name, cases, world, space):
  return run_ranks(tmp_path_factory.mktemp(name), "test_torch_space_step",
                   "space_jobs", {"cases": cases, "space": space},
                   world=world, timeout=600)


def run_one_process(tmp_path_factory, name, cases):
  tmp = tmp_path_factory.mktemp(name)
  return run_ranks(tmp, "test_torch_space_step", "one_process_jobs",
                   {"cases": cases, "store": str(tmp / "store")}, world=1,
                   timeout=600, join=False)[0]


def semantic_variables(variables):
  """The variables with a third output class: stage_6_t's kernel and bias
  take a seeded column of their own scale."""
  import copy
  variables = copy.deepcopy(variables)
  layer = variables["params"]["decoder"]["stage_6_t"]
  rng = np.random.default_rng(3)
  for key in ("kernel", "bias"):
    value = layer[key]
    bound = float(np.abs(value).max())
    extra = rng.uniform(-bound, bound, value.shape[:-1] + (1,))
    layer[key] = np.concatenate([value, extra.astype(np.float32)], -1)
  return variables


def semantic_batch():
  """tests/test_torch_train_step.py's grid batch with label 2 on the far
  half of the depth: classes part where the two slabs meet."""
  from test_torch_train_step import _batch
  batch = _batch()
  far = (np.arange(RES[0]) >= RES[0] // 2)[None, :, None, None]
  batch["grid"] = np.where(batch["grid"] == 1, 1 + far, 0).astype(np.int32)
  return batch


@pytest.fixture(scope="module")
def inputs():
  from corenet_tpu_torch.models.convert import state_dict_from_jax
  from test_torch_model import _variables
  from test_torch_train_step import VOX_KWARGS, _triangle_batch
  variables = _variables(RES[0])
  sem_variables = semantic_variables(variables)
  cases = {
      "fgbg": {"res": RES, "channels": 2, "model": {"phase_output": True},
               "task": "FG_BG", "vox_kwargs": VOX_KWARGS,
               "batches": [_triangle_batch()],
               "state_dict": dict(state_dict_from_jax(variables))},
      "semantic": {"res": RES, "channels": SEMANTIC_CLASSES, "model": {},
                   "task": "SEMANTIC", "vox_kwargs": None,
                   "batches": [semantic_batch()],
                   "state_dict": dict(state_dict_from_jax(sem_variables))},
  }
  return {"fgbg": variables, "semantic": sem_variables}, cases


@pytest.fixture(scope="module")
def space2(tmp_path_factory, inputs):
  return run_cases(tmp_path_factory, "space2", inputs[1], world=2, space=2)


@pytest.fixture(scope="module")
def data2_space2(tmp_path_factory, inputs):
  cases = {"fgbg": inputs[1]["fgbg"]}
  return run_cases(tmp_path_factory, "data2_space2", cases, world=4, space=2)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory, inputs):
  return run_one_process(tmp_path_factory, "one_process", inputs[1])


@pytest.fixture(scope="module")
def jax_refs(inputs):
  """Each case's JAX step, computed once."""
  variables, cases = inputs
  refs = {}

  def get(name):
    if name not in refs:
      refs[name] = jax_reference(variables[name], cases[name])
    return refs[name]

  return get


def jax_reference(variables, case):
  """JAX's one-device step on the case's first batch: (loss, global step,
  gradients, new statistics)."""
  from corenet_tpu.models.corenet import CoreNet as JaxCoreNet
  from corenet_tpu.models.corenet import CoreNetConfig as JaxCoreNetConfig
  from corenet_tpu.models.corenet import DecoderConfig as JaxDecoderConfig
  from test_torch_train_step import _jax_step
  model = JaxCoreNet(JaxCoreNetConfig(decoder=JaxDecoderConfig(
      resolution=case["res"], num_output_channels=case["channels"])),
                     **case["model"])
  if case["task"] == "FG_BG":
    return _jax_step(variables, case["batches"][0], model,
                     case["vox_kwargs"])
  return _jax_semantic_step(variables, case["batches"][0], model)


def _jax_semantic_step(variables, batch, model):
  """tests/test_torch_train_step.py's `_jax_step` for the SEMANTIC task."""
  import jax
  import jax.numpy as jnp
  from corenet_tpu.train.state import create_train_state as jax_train_state
  from corenet_tpu.train.step import make_train_step as jax_make_train_step
  from test_torch_train_step import _grad_keeper
  optimizer = _grad_keeper()
  state = jax_train_state(jax.tree_util.tree_map(jnp.asarray, variables),
                          optimizer)
  step = jax_make_train_step(model, optimizer, "SEMANTIC", RES, donate=False)
  state, metrics = step(state, jax.tree_util.tree_map(jnp.asarray, batch))
  return (float(metrics["loss"]), int(state.global_step),
          jax.tree_util.tree_map(np.asarray, state.opt_state["grads"]),
          jax.tree_util.tree_map(np.asarray, state.batch_stats))


def rank0_model(case, result):
  """A model holding rank 0's new statistics and averaged gradients."""
  model = _model(case)
  model.load_state_dict({k: torch.from_numpy(v)
                         for k, v in result["buffers"].items()},
                        strict=False)
  for name, p in model.named_parameters():
    p.grad = torch.from_numpy(result["grads"][name])
  return model


class _State:
  def __init__(self, global_step):
    self.global_step = global_step


def assert_ranks_agree(results, global_step):
  """Every rank's loss, step count, averaged gradients, parameters after
  Adam and collectives alike."""
  for key in ("losses", "global_step", "grads_digest", "params_digest",
              "collectives", "shard_stage"):
    assert len({str(r[key]) for r in results}) == 1, (key, results)
  assert results[0]["global_step"] == global_step


def assert_matches_one_process(want, got):
  """Loss and statistics within 1e-5 of the port's one-process step,
  gradients by the step levels."""
  from test_torch_distributed_step import _assert_gradient_levels
  tt.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
  for name, value in want["buffers"].items():
    tt.assert_allclose(got["buffers"][name], value, rtol=1e-5,
                       atol=1e-5 * np.abs(value).max(), err_msg=name)
  _assert_gradient_levels(want["grads"], got["grads"])


def halo_collectives(shard_stage):
  """Two convolutions per tower from the shard stage on, each exchanging
  halos once forward and once backward."""
  return 2 * 2 * (7 - shard_stage)


def data_parallel_collectives(result):
  """BatchRenorm's 4 per float32 layer and the gradients' 1
  (tests/test_torch_distributed_step.py); the losses' are counted
  apart."""
  layers = sum(1 for name in result["buffers"] if name.endswith(".steps"))
  return 4 * layers + 1


@pytest.mark.parametrize("name", ["fgbg", "semantic"])
def test_space_step_matches_jax(inputs, jax_refs, space2, name):
  from test_torch_train_step import _assert_step_matches
  case = inputs[1][name]
  ref = jax_refs(name)
  got = [r[name] for r in space2]
  assert_ranks_agree(got, 2)
  assert got[0]["shard_stage"] == 4
  _assert_step_matches(ref, rank0_model(case, got[0]),
                       _State(got[0]["global_step"]),
                       {"loss": got[0]["losses"][0]})


@pytest.mark.parametrize("name", ["fgbg", "semantic"])
def test_space_step_matches_the_one_process_step(inputs, space2, one_process,
                                                 name):
  want, got = one_process[0][name], space2[0][name]
  assert want["global_step"] == got["global_step"] == 2
  assert want["shard_stage"] == 7
  assert want["collectives"] == 0
  assert_matches_one_process(want, got)
  # Each mean over the world and each IoU's sums over the space group: an
  # all-reduce forward and one backward. FG_BG has one IoU; SEMANTIC an
  # IoU and a cross-entropy. FG_BG's labels, voxelized in the step at a
  # batch that divides by the space count, are shared over the space
  # group: one all-to-all; SEMANTIC's come with the batch, whole on every
  # rank.
  losses = 4 if name == "fgbg" else 6
  labels = 1 if name == "fgbg" else 0
  assert got["collectives"] == (data_parallel_collectives(got) + losses
                                + halo_collectives(4) + labels), (
                                    got["collectives"])
  assert got["routes"] == (
      {"space_shared": 1} if labels else {"replicated": 1}), got["routes"]


def test_data2_space2_step_matches_jax_and_one_process(
    inputs, jax_refs, data2_space2, one_process):
  """4 ranks: scene 0 on ranks 0 and 1, scene 1 on ranks 2 and 3."""
  from test_torch_train_step import _assert_step_matches
  got = [r["fgbg"] for r in data2_space2]
  assert_ranks_agree(got, 2)
  _assert_step_matches(jax_refs("fgbg"), rank0_model(inputs[1]["fgbg"],
                                                     got[0]),
                       _State(got[0]["global_step"]),
                       {"loss": got[0]["losses"][0]})
  assert_matches_one_process(one_process[0]["fgbg"], got[0])


def test_a_space_group_of_one_steps_as_no_group_does(one_process):
  """create_mesh(space=1) in a group of one and depth_shard (0, 1): the
  data-parallel collectives only, and the step of no group bit for bit."""
  alone, grouped = one_process[0]["fgbg"], one_process[1]
  assert grouped["shard_stage"] == 7
  assert grouped["collectives"] == data_parallel_collectives(alone) + 2
  for key in ("losses", "global_step", "grads_digest", "params_digest"):
    assert grouped[key] == alone[key], key
