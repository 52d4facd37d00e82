"""The training step on the 'space' axis with its ground truth shared over
the space group (train/gt.py::space_shared) against the same step on the
replicated route (every space rank voxelizes its data group's whole batch
and keeps its slab), on gloo processes on the CPU.

Cases at tests/test_torch_space_step.py's sizes (32³, its scenes and
flax-initialized weights): FG_BG with the phase loss on the fine decoder
(K3, the packed fill and K4 at s = 2) and on the packed one from tower 3
(K4 at s = 4), and FG_BG without it (the blocked labeled grid), each on
data 1 × space 2 at batch 2; the fine phase-loss step on data 2 × space 2
at a batch of 4 (2 per data group). Held: the loss, the new statistics,
the averaged gradients and the parameters after Adam bit for bit between
the two routes, on every rank; the route counts (one shared call per
step, one replicated where the route is turned off); the shared step's
one all-to-all more. A data group's batch of 3 on space 2 does not divide
and takes the replicated route by itself. The shared step against JAX is
tests/test_torch_space_step{,_packed}.py's (their FG_BG batches divide).
`TrainPipeline` with the layout (`--space=2`'s) at h7's batch of 4 and
h7's voxelization (irm 8), at 32³, shares the GT; at a batch of 3 it
replicates it.
"""

import numpy as np
import pytest
import torch

from corenet_tpu_torch.utils import tracing
from test_torch_distributed import run_ranks
from test_torch_saved_states import remove_saved_states
from test_torch_space_step import RES, step_case

torch.set_num_threads(2)

ROUTES = ("shared", "replicated")


def _routes() -> dict:
  """The labels' routes taken so far (train/gt.py::labels_slab)."""
  counts = tracing.counters()
  return {route: counts[f"gt.route.{route}"]
          for route in ("space_shared", "replicated")}


def space_jobs(rank, world, cases, space):
  """Each case on this rank's data group's scenes and depth slab, by both
  routes."""
  from corenet_tpu_torch.parallel import mesh
  from corenet_tpu_torch.train import gt
  mesh.create_mesh(space=space)
  shares = gt.shares_over_space
  out = {}
  for name, case in cases.items():
    per = case["batches"][0]["image"].shape[0] // mesh.data_count()
    lo = mesh.data_index() * per
    for route in ROUTES:
      if route == "replicated":
        gt.shares_over_space = lambda *_: False
      out[name, route] = step_case(case, slice(lo, lo + per),
                                   (mesh.space_index(), space), full=False)
      gt.shares_over_space = shares
  return out


@pytest.fixture(scope="module")
def cases():
  from corenet_tpu_torch.models.convert import state_dict_from_jax
  from test_torch_model import _variables
  from test_torch_train_step import VOX_KWARGS, _triangle_batch
  state_dict = dict(state_dict_from_jax(_variables(RES[0])))
  two = _triangle_batch()
  four = {k: np.concatenate([v, v[::-1]]) for k, v in two.items()}

  def case(model, batch):
    return {"res": RES, "channels": 2, "model": model, "task": "FG_BG",
            "vox_kwargs": VOX_KWARGS, "batches": [batch],
            "state_dict": state_dict}

  phase = {"phase_output": True}
  packed = {"phase_output": True, "packed_decoder": True,
            "pack_from_stage": 3}
  return {"space2": {"fine": case(phase, two), "packed": case(packed, two),
                     "grid": case({}, two),
                     "three": case(phase, {k: v[:3] for k, v in
                                           four.items()})},
          "data2": {"fine": case(phase, four)}}


@pytest.fixture(scope="module")
def space2(tmp_path_factory, cases):
  return run_ranks(tmp_path_factory.mktemp("shared2"),
                   "test_torch_space_step_shared", "space_jobs",
                   {"cases": cases["space2"], "space": 2}, world=2,
                   timeout=600)


@pytest.fixture(scope="module")
def data2_space2(tmp_path_factory, cases):
  return run_ranks(tmp_path_factory.mktemp("shared4"),
                   "test_torch_space_step_shared", "space_jobs",
                   {"cases": cases["data2"], "space": 2}, world=4,
                   timeout=600)


def _assert_routes_equal(results, name):
  keys = ("losses", "global_step", "grads_digest", "params_digest",
          "buffers_digest", "shard_stage")
  for rank, r in enumerate(results):
    shared, replicated = r[name, "shared"], r[name, "replicated"]
    for key in keys:
      assert shared[key] == replicated[key], (name, rank, key)
    assert shared["routes"] == {"space_shared": 1}, shared["routes"]
    assert replicated["routes"] == {"replicated": 1}, replicated["routes"]
    assert shared["collectives"] == replicated["collectives"] + 1
  # Every rank of the world takes the same step.
  assert len({r[name, "shared"]["params_digest"] for r in results}) == 1


@pytest.mark.parametrize("name", ["fine", "packed", "grid"])
def test_shared_step_equals_the_replicated_step(space2, name):
  _assert_routes_equal(space2, name)
  assert space2[0][name, "shared"]["global_step"] == 2


def test_shared_step_on_data2_space2_equals_the_replicated_step(
    data2_space2):
  _assert_routes_equal(data2_space2, "fine")
  assert data2_space2[0]["fine", "shared"]["global_step"] == 4


def test_a_batch_that_does_not_divide_is_not_shared(space2):
  for r in space2:
    for route in ROUTES:
      got = r["three", route]
      assert got["routes"] == {"replicated": 1}, (route, got["routes"])
      assert got["global_step"] == 3
    # No all-to-all: the route that would share makes as many collectives.
    assert r["three", "shared"]["collectives"] == (
        r["three", "replicated"]["collectives"])
    assert r["three", "shared"]["params_digest"] == (
        r["three", "replicated"]["params_digest"])


def pipeline_jobs(rank, world, configs):
  """One step of TrainPipeline on data 1 × space 2 for each configuration:
  the GT routes it took."""
  from corenet_tpu_torch import config as cfg
  from corenet_tpu_torch.parallel import mesh
  from corenet_tpu_torch.train import pipeline
  layout = mesh.create_mesh(space=2)
  out = []
  for config_dict in configs:
    full = cfg.config_from_dict(cfg.TrainPipeline, config_dict)
    p = pipeline.TrainPipeline(full.train, full.output_path, device="cpu",
                               mesh=layout, compute_dtype="float32")
    before = _routes()
    p.run(max_steps=1)
    out.append({k: v - before[k] for k, v in _routes().items()
                if v != before[k]})
  return out


def test_train_pipeline_shares_the_gt_where_the_batch_divides(
    tmp_path_factory):
  from helpers import make_fixture_dataset
  from test_torch_distributed_pipeline import _train_dict
  root = tmp_path_factory.mktemp("shared_pipeline")
  manifest, meshes_dir = make_fixture_dataset(str(root / "ds"), num_scenes=4,
                                              image_size=64)
  configs = []
  for batch in (4, 3):
    config = _train_dict(str(root / str(batch)), manifest, meshes_dir)
    data = config["train"]["data"]
    data["data_loader"]["batch_size"] = batch
    data["voxelization_config"][
        "voxelization_image_resolution_multiplier"] = 8
    configs.append(config)
  try:
    ranks = run_ranks(root, "test_torch_space_step_shared", "pipeline_jobs",
                      {"configs": configs}, timeout=600)
  finally:
    remove_saved_states(root)
  for routes in ranks:
    assert routes == [{"space_shared": 1}, {"replicated": 1}], routes
