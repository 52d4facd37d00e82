"""The PyTorch port's TrainPipeline and train CLI on the 'space' axis: 2
gloo processes on the CPU laid out as data 1 × space 2
(parallel/mesh.py::create_mesh(space=2), the CLI's --space=2), against
the JAX package's loader and checkpoint reader and the port's one-process
eval.

TrainPipeline at 32³ in float32 with the phase loss (the fine decoder,
sharded from tower 4), tests/helpers.py's fixture dataset of 4 scenes at
a batch of 1 per data group: 2 steps through TrainPipeline(mesh=...),
then the train CLI with --multihost --space=2 in a torchrun-shaped
environment resumes for 2 more and runs a recurrent eval at its last
step. Held: both space ranks load the same batches, the JAX loader's over
the data group's shard of each epoch (`distributed_indices(len, 1, 0)`:
the whole epoch); global_step advances by the batch times the data count
(1 per step); both ranks end with the same weights; rank 0 alone writes
the checkpoints, which JAX's `decode_state` reads and the CLI resumes
from; the recurrent eval, which runs the unsharded eval twin on each
rank's shard of the eval set, writes the CSV of one process's eval of
the same checkpoint; each step's labels, on a batch of 1, take the
replicated route (the shared one: tests/test_torch_space_step_shared.py).
On data 2 × space 2 (4 ranks), each data group's two space ranks load the
JAX loader's batches over its shard of the epoch.
"""

import json
import os

import pytest
import torch

from test_torch_distributed import run_ranks
from test_torch_distributed_pipeline import (
    _free_port, _recording, _summary, _train_dict)
from test_torch_saved_states import remove_saved_states

torch.set_num_threads(2)

SCENES = 4
EVAL_STEP = 4


def _config_dict(root, manifest, meshes_dir):
  """tests/test_torch_distributed_pipeline.py's training configuration
  with a recurrent eval of the same scenes at the last step."""
  config = _train_dict(root, manifest, meshes_dir)
  data = dict(config["train"]["data"], data_loader={
      "num_data_workers": 1, "batch_size": 2, "prefetch_factor": 2,
      "worker_processes": False})
  config["eval"] = [{"start_step": EVAL_STEP, "interval": 1000,
                     "persistent_checkpoint": False,
                     "config": {"name": "space_eval", "data": data,
                                "num_qualitative_results": 0}}]
  return config


def train_jobs(rank, world, config_dict, max_steps):
  """TrainPipeline on the data 1 × space 2 layout (the group is the
  worker's)."""
  from corenet_tpu_torch import config as cfg
  from corenet_tpu_torch.parallel import mesh
  from corenet_tpu_torch.train import checkpoint, gt, pipeline
  record = {"batches": [], "saves": []}
  _recording(pipeline.TrainPipeline, checkpoint.CheckpointManager, record)
  full = cfg.config_from_dict(cfg.TrainPipeline, config_dict)
  p = pipeline.TrainPipeline(full.train, full.output_path, device="cpu",
                             mesh=mesh.create_mesh(space=2),
                             compute_dtype="float32")
  before = dict(gt.route_counts)
  p.run(max_steps=max_steps)
  return dict(_summary(p, record), depth_shard=p.model.depth_shard,
              shard_stage=p.model.decoder.shard_stage,
              routes={k: v - before[k] for k, v in gt.route_counts.items()})


def cli_jobs(rank, world, config_path, max_steps):
  """The train CLI with --multihost --space=2."""
  from corenet_tpu_torch.cli import train
  from corenet_tpu_torch.train import checkpoint, pipeline
  record = {"batches": [], "saves": []}
  _recording(pipeline.TrainPipeline, checkpoint.CheckpointManager, record)
  p = train.main([f"--config_path={config_path}", "--multihost",
                  "--space=2", "--device=cpu", "--compute_dtype=float32",
                  f"--max_steps={max_steps}"])
  return dict(_summary(p, record), depth_shard=p.model.depth_shard)


def loader_jobs(rank, world, config_dict):
  """This rank's (data index, scenes of its first epoch's batches) under
  TrainPipeline on data world/2 × space 2, without training."""
  from corenet_tpu_torch import config as cfg
  from corenet_tpu_torch.parallel import mesh
  from corenet_tpu_torch.train import pipeline
  full = cfg.config_from_dict(cfg.TrainPipeline, config_dict)
  p = pipeline.TrainPipeline(full.train, full.output_path, device="cpu",
                             mesh=mesh.create_mesh(space=2))
  return mesh.data_index(), [list(hb.scene_ids)
                             for hb, _ in p._epoch_loader(0)]


def eval_jobs(rank, world, config_dict, out_dir):
  """One process: the newest checkpoint's state (linked into `out_dir`)
  through the same recurrent eval, with `out_dir` for its output path."""
  from corenet_tpu_torch import config as cfg
  from corenet_tpu_torch.train import pipeline
  src = os.path.join(config_dict["output_path"], "cpt", "persistent")
  dst = os.path.join(out_dir, "cpt", "persistent")
  os.makedirs(dst)
  newest = sorted(os.listdir(src))[-1]
  os.link(os.path.join(src, newest), os.path.join(dst, newest))
  full = cfg.config_from_dict(cfg.TrainPipeline,
                              dict(config_dict, output_path=out_dir))
  p = pipeline.TrainPipeline(full.train, out_dir, device="cpu",
                             compute_dtype="float32")
  p.create_or_load_state()
  evals = pipeline.RecurrentEvals(full.eval, out_dir)
  return evals.run_single(p, full.eval[0].config, p.state.global_step)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
  """2 steps through TrainPipeline, 2 more through the CLI, and one
  process's eval of the last checkpoint; the states are removed once the
  module's tests are done."""
  from helpers import make_fixture_dataset
  root = tmp_path_factory.mktemp("space_train")
  manifest, meshes_dir = make_fixture_dataset(
      str(root / "ds"), num_scenes=SCENES, image_size=64)
  config_dict = _config_dict(str(root), manifest, meshes_dir)
  first = run_ranks(root, "test_torch_space_pipeline", "train_jobs",
                    {"config_dict": config_dict, "max_steps": 2})
  config_path = root / "train.json"
  config_path.write_text(json.dumps(config_dict))
  port = _free_port()
  resumed = run_ranks(
      root, "test_torch_space_pipeline", "cli_jobs",
      {"config_path": str(config_path), "max_steps": EVAL_STEP}, join=False,
      env=lambda rank: {"RANK": str(rank), "WORLD_SIZE": "2",
                        "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
                        "MASTER_PORT": str(port)})
  one = str(root / "one_process")
  miou = run_ranks(root, "test_torch_space_pipeline", "eval_jobs",
                   {"config_dict": config_dict, "out_dir": one}, world=1,
                   join=False)[0]
  yield config_dict, first, resumed, one, miou
  remove_saved_states(root)


def _jax_batches(config_dict, epoch, data=1, index=0):
  """The JAX loader's scenes over data group `index`'s shard of an epoch
  of `data` groups (of 1: the whole epoch)."""
  from corenet_tpu import config as jax_config
  from corenet_tpu.data.loader import DataLoader, distributed_indices
  from corenet_tpu.data.manager import DatasetManager
  full = jax_config.config_from_dict(jax_config.TrainPipeline, config_dict)
  dataset = DatasetManager(full.train.data).create_dataset(local_seed=epoch)
  shard = dataset.select(distributed_indices(len(dataset), data, index,
                                             pad_data=True, shuffle=False))
  return [list(hb.scene_ids) for hb, _ in DataLoader(
      shard, batch_size=1, drop_last=True, worker_processes=False)]


def test_space_ranks_load_their_data_groups_batches(trained):
  config_dict, first, resumed, _, _ = trained
  epoch0 = _jax_batches(config_dict, 0)
  assert len(epoch0) == SCENES
  for rank in range(2):
    assert first[rank]["depth_shard"] == (rank, 2)
    assert first[rank]["shard_stage"] == 4
    assert first[rank]["batches"] == epoch0[:2]
    assert resumed[rank]["batches"] == epoch0[2:]
  # global_step counts the batch of 1 times the data count 1.
  assert [r["global_step"] for r in first] == [2, 2]
  # A batch of 1 does not share over 2 space ranks (and irm 2 takes the
  # general rasterizer): the replicated route each step.
  assert [r["routes"] for r in first] == [
      {"space_shared": 0, "replicated": 2}] * 2
  assert [r["global_step"] for r in resumed] == [4, 4]


def test_data_groups_load_their_shards_on_data2_space2(trained,
                                                       tmp_path_factory):
  """4 ranks: ranks 0 and 1 (data group 0) load the JAX loader's batches
  over `distributed_indices(len, 2, 0)`, ranks 2 and 3 over its shard 1."""
  config_dict = trained[0]
  ranks = run_ranks(tmp_path_factory.mktemp("space_loaders"),
                    "test_torch_space_pipeline", "loader_jobs",
                    {"config_dict": config_dict}, world=4)
  assert [index for index, _ in ranks] == [0, 0, 1, 1]
  for rank, (index, batches) in enumerate(ranks):
    assert batches == _jax_batches(config_dict, 0, 2, index), rank
  assert len(ranks[0][1]) == SCENES // 2


def test_space_ranks_hold_the_same_state_and_rank_0_checkpoints_it(trained):
  from corenet_tpu.train import checkpoint as jax_cpt
  config_dict, first, resumed, _, _ = trained
  for runs in (first, resumed):
    assert runs[0]["digest"] == runs[1]["digest"]
    assert runs[1]["saves"] == []
  assert first[0]["saves"] == [0, 2] and resumed[0]["saves"] == [4]
  out = config_dict["output_path"]
  names = sorted(os.listdir(os.path.join(out, "cpt", "persistent")))
  assert len(names) == 2, names
  with open(os.path.join(out, "cpt", "persistent", names[-1]), "rb") as f:
    state, meta = jax_cpt.decode_state(f.read())
  assert int(state.global_step) == 4 and meta["classes"]
  assert int(state.opt_state["0"]["count"]) == 4
  assert int(state.batch_stats["decoder"]["stage_6_bn2"]["steps"]) == 4


def test_the_recurrent_eval_equals_one_process(trained):
  config_dict, _, _, one, miou = trained
  rel = os.path.join("evals", "space_eval", str(EVAL_STEP),
                     "voxel_metrics.csv")
  with open(os.path.join(config_dict["output_path"], rel)) as f:
    ranks_csv = f.read()
  with open(os.path.join(one, rel)) as f:
    one_csv = f.read()
  assert ranks_csv == one_csv
  assert 0.0 <= miou <= 1.0
