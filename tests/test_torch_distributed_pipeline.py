"""The PyTorch port's eval and training pipelines and the train CLI over 2
processes (gloo, CPU), against the JAX package.

EvalPipeline on the 5 scenes of tests/helpers.py's fixture dataset over 2
ranks (shards of 3 and 2: two batches on rank 0, one on rank 1, the
shape of the JAX package's tests/test_multiprocess.py::
test_two_process_recurrent_eval) with an inference function that is a
fixed function of each scene: rank 0's CSV equals the JAX pipeline's on
the whole dataset in one process, rank 1 writes none, and rank 0's
summary writer holds the tiles of both shards.

TrainPipeline at 32³ in bf16 with the phase loss, 6 scenes at a batch of 1
per rank: 2 steps, then the train CLI with --multihost in a
torchrun-shaped environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT; --device=cpu, so gloo) resumes for 2 more. Each rank's
batches are the JAX loader's over its shard of each epoch
(corenet_tpu.data.loader.distributed_indices(len, 2, rank,
pad_data=True)), the resumed run going on with the next batch of its
shard; the static fill is on; every checkpoint is written once, by rank
0, and decodes in the JAX package's decode_state; both ranks end with the
same weights; each rank logs to its own file.
"""

import json
import os
import socket

import numpy as np
import pytest
import torch

from test_torch_distributed import run_ranks
from test_torch_saved_states import empty_older_states, remove_saved_states

torch.set_num_threads(2)

RES = (32, 32, 32)
EVAL_SCENES = 5
TRAIN_SCENES = 6


# ------------------------------------------------------------------ eval ----
def _eval_dict(manifest, meshes_dir, qualitative):
  return {
      "name": "dist_eval",
      "num_qualitative_results": qualitative,
      "num_qualitative_results_in_tensor_board": 4,
      "data": {
          "datasets": [{"dataset_path": manifest, "meshes_dir": meshes_dir,
                        "shuffle": "ONCE"}],
          "shuffle": "PER_EPOCH",
          "data_loader": {"num_data_workers": 1, "batch_size": 2,
                          "prefetch_factor": 2, "worker_processes": False},
          "voxelization_config": {
              "task_type": "FG_BG",
              "resolution": dict(zip(("depth", "height", "width"), RES)),
              "conservative_rasterization": False,
              "voxelization_image_resolution_multiplier": 8}}}


def scene_inference(image, camera, v2x, grid_offsets, resolution):
  """A PMF that is a fixed function of each scene alone (a seeded field
  with a box of class 1), whatever the batch and the framework."""
  image = np.asarray(image)
  pmf = np.zeros((image.shape[0],) + tuple(resolution) + (2,), np.float32)
  for i, scene in enumerate(image):
    rng = np.random.default_rng(int(scene.astype(np.int64).sum() % 1000))
    pmf[i] = rng.random(pmf.shape[1:])
    lo = 6 + int(scene[0, 0, 0]) % 6
    pmf[i, lo:lo + 16, lo:lo + 16, lo:lo + 16, 1] += 0.5
  return pmf


class RecordingWriter:

  def __init__(self):
    self.images, self.scalars = [], []

  def add_image(self, tag, image, step):
    self.images.append((tag, np.asarray(image).shape))

  def add_scalar(self, tag, value, step):
    self.scalars.append(tag)

  def flush(self):
    pass


def eval_jobs(rank, world, eval_dict, out_dir):
  import functools
  from corenet_tpu_torch import config as cfg
  from corenet_tpu_torch.eval import pipeline
  # Small views: a tile of 5 × 5 views of 16².
  pipeline.QualitativeResults = functools.partial(
      pipeline.QualitativeResults, image_size=(16, 16))
  writer = RecordingWriter() if rank == 0 else None
  out = os.path.join(out_dir, f"rank{rank}")
  ep = pipeline.EvalPipeline(cfg.config_from_dict(cfg.EvalConfig, eval_dict),
                             out, scene_inference, summary_writer=writer,
                             device="cpu")
  batches = []
  real = ep._run_batches

  def counting(loader, *args, **kwargs):
    batches.append(len(loader))
    return real(loader, *args, **kwargs)

  ep._run_batches = counting
  miou = ep.run_eval(0)
  step_dir = os.path.join(out, "dist_eval", "0")
  csv_path = os.path.join(step_dir, "voxel_metrics.csv")
  return {"miou": miou, "batches": batches,
          "csv": open(csv_path).read() if os.path.exists(csv_path) else None,
          "tiles": sorted(f for f in os.listdir(step_dir)
                          if f.startswith("img_")),
          "summary": None if writer is None else (writer.images,
                                                  writer.scalars)}


@pytest.fixture(scope="module")
def eval_dataset(tmp_path_factory):
  from helpers import make_fixture_dataset
  root = tmp_path_factory.mktemp("dist_eval")
  return root, make_fixture_dataset(str(root / "ds"),
                                    num_scenes=EVAL_SCENES, image_size=64)


def test_eval_over_two_ranks_equals_jax_in_one_process(eval_dataset):
  import jax.numpy as jnp
  from corenet_tpu import config as jax_config
  from corenet_tpu.eval import pipeline as jax_pipeline
  root, (manifest, meshes_dir) = eval_dataset
  eval_dict = _eval_dict(manifest, meshes_dir, qualitative=2)
  ranks = run_ranks(root, "test_torch_distributed_pipeline", "eval_jobs",
                    {"eval_dict": eval_dict, "out_dir": str(root / "port")})
  jax_dir = root / "jax"
  want_iou = jax_pipeline.EvalPipeline(
      jax_config.config_from_dict(jax_config.EvalConfig,
                                  _eval_dict(manifest, meshes_dir, 0)),
      str(jax_dir), lambda *args: jnp.asarray(scene_inference(*args))
  ).run_eval(0)
  want_csv = (jax_dir / "dist_eval" / "0" / "voxel_metrics.csv").read_text()

  assert [r["batches"] for r in ranks] == [[2], [1]]
  assert ranks[0]["csv"] == want_csv and ranks[1]["csv"] is None
  assert ranks[0]["miou"] == ranks[1]["miou"] == want_iou
  assert 0 < want_iou < 1
  # Each rank drew its own first 2 scenes; rank 0's writer took all 4.
  assert [len(r["tiles"]) for r in ranks] == [2, 2]
  assert not set(ranks[0]["tiles"]) & set(ranks[1]["tiles"])
  images, scalars = ranks[0]["summary"]
  assert images == [(f"rec_{i}", (80, 80, 3)) for i in range(4)]
  assert "General/mIoU" in scalars and ranks[1]["summary"] is None


# ----------------------------------------------------------------- train ----
def _train_dict(root, manifest, meshes_dir):
  """32³, FG_BG, a batch of 1 per rank, h7's voxelization at multiplier 2
  without a configured fill count; no recurrent eval, checkpoints only at
  the start and the end."""
  return {
      "string_templates": [],
      "train": {
          "data": {
              "datasets": [{"dataset_path": manifest,
                            "meshes_dir": meshes_dir,
                            "shuffle": "PER_EPOCH"}],
              "shuffle": "PER_EPOCH",
              "data_loader": {"num_data_workers": 1, "batch_size": 1,
                              "prefetch_factor": 2,
                              "worker_processes": False},
              "voxelization_config": {
                  "task_type": "FG_BG",
                  "resolution": dict(zip(("depth", "height", "width"),
                                         RES)),
                  "conservative_rasterization": False,
                  "voxelization_image_resolution_multiplier": 2}},
          "resnet50_imagenet_checkpoint": "",
          "checkpoint_interval": 1000, "persistent_checkpoint_interval": 1000,
          "tensorboard_log_interval": 2, "fill_audit_interval": 2},
      "eval": [],
      "output_path": os.path.join(root, "out"),
  }


def _recording(pipeline_cls, cpt_cls, record):
  """Patches the classes to record the scenes of each batch a rank's
  loader gives and each checkpoint it saves; a save empties the older
  states (tests/test_torch_saved_states.py)."""
  real_loader = pipeline_cls._epoch_loader
  real_save = cpt_cls.save_state

  def epoch_loader(self, start):
    for hb, valid in real_loader(self, start):
      record["batches"].append(list(hb.scene_ids))
      yield hb, valid

  def save_state(self, state, *args, **kwargs):
    record["saves"].append(state.global_step)
    path = real_save(self, state, *args, **kwargs)
    empty_older_states(self.cpt_dir, path)
    return path

  pipeline_cls._epoch_loader = epoch_loader
  cpt_cls.save_state = save_state


def _summary(pipeline, record):
  import hashlib
  digest = hashlib.sha256()
  for value in pipeline.state.model.state_dict().values():
    digest.update(value.numpy().tobytes())
  return dict(record, global_step=pipeline.state.global_step,
              fill_rounds=pipeline.fill_rounds,
              digest=digest.hexdigest())


def train_jobs(rank, world, config_dict, max_steps):
  """TrainPipeline directly (the group is the worker's)."""
  from corenet_tpu_torch import config as cfg
  from corenet_tpu_torch.train import checkpoint, pipeline
  record = {"batches": [], "saves": [], "audits": []}
  _recording(pipeline.TrainPipeline, checkpoint.CheckpointManager, record)
  full = cfg.config_from_dict(cfg.TrainPipeline, config_dict)
  p = pipeline.TrainPipeline(full.train, full.output_path, device="cpu")
  real_audit = p.audit_static_fill
  p.audit_static_fill = lambda: (record["audits"].append(real_audit())
                                 or record["audits"][-1])
  p.run(max_steps=max_steps)
  return _summary(p, record)


def cli_jobs(rank, world, config_path, max_steps):
  """The train CLI with --multihost: it joins the group from the
  environment and leaves it at the end."""
  from corenet_tpu_torch.cli import train
  from corenet_tpu_torch.train import checkpoint, pipeline
  record = {"batches": [], "saves": []}
  _recording(pipeline.TrainPipeline, checkpoint.CheckpointManager, record)
  p = train.main([f"--config_path={config_path}", "--multihost",
                  "--device=cpu", f"--max_steps={max_steps}"])
  return _summary(p, record)


def _free_port():
  with socket.socket() as s:
    s.bind(("localhost", 0))
    return s.getsockname()[1]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
  """2 steps through TrainPipeline, then 2 more through the CLI; the
  states are removed once the module's tests are done."""
  from helpers import make_fixture_dataset
  root = tmp_path_factory.mktemp("dist_train")
  manifest, meshes_dir = make_fixture_dataset(
      str(root / "ds"), num_scenes=TRAIN_SCENES, image_size=64)
  config_dict = _train_dict(str(root), manifest, meshes_dir)
  first = run_ranks(root, "test_torch_distributed_pipeline", "train_jobs",
                    {"config_dict": config_dict, "max_steps": 4})
  config_path = root / "train.json"
  config_path.write_text(json.dumps(config_dict))
  port = _free_port()
  resumed = run_ranks(
      root, "test_torch_distributed_pipeline", "cli_jobs",
      {"config_path": str(config_path), "max_steps": 8}, join=False,
      env=lambda rank: {"RANK": str(rank), "WORLD_SIZE": "2",
                        "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
                        "MASTER_PORT": str(port)})
  yield config_dict, first, resumed
  remove_saved_states(root)


def _jax_batches(config_dict, rank, epoch):
  """The JAX loader's scenes over rank's shard of an epoch."""
  from corenet_tpu import config as jax_config
  from corenet_tpu.data.loader import DataLoader, distributed_indices
  from corenet_tpu.data.manager import DatasetManager
  full = jax_config.config_from_dict(jax_config.TrainPipeline, config_dict)
  dataset = DatasetManager(full.train.data).create_dataset(local_seed=epoch)
  shard = dataset.select(distributed_indices(len(dataset), 2, rank,
                                             pad_data=True, shuffle=False))
  return [list(hb.scene_ids) for hb, _ in DataLoader(
      shard, batch_size=1, drop_last=True, worker_processes=False)]


def test_each_rank_trains_on_its_shard_in_jax_order(trained):
  config_dict, first, resumed = trained
  for rank in range(2):
    epoch0, epoch1 = (_jax_batches(config_dict, rank, e) for e in (0, 1))
    assert len(epoch0) == TRAIN_SCENES // 2
    assert first[rank]["batches"] == epoch0[:2]
    # The resume goes on with the next batch of its shard, then epoch 1.
    assert resumed[rank]["batches"] == epoch0[2:] + epoch1[:1]
  # The two ranks' shards of an epoch are disjoint.
  assert not ({s for b in first[0]["batches"] for s in b}
              & {s for b in first[1]["batches"] for s in b})
  assert [r["global_step"] for r in first] == [4, 4]
  assert [r["global_step"] for r in resumed] == [8, 8]


def test_ranks_hold_the_same_state_and_rank_0_checkpoints_it(trained):
  from corenet_tpu.train import checkpoint as jax_cpt
  config_dict, first, resumed = trained
  for runs in (first, resumed):
    assert runs[0]["digest"] == runs[1]["digest"]
    assert runs[1]["saves"] == []
  # The initial state, then each run's end.
  assert first[0]["saves"] == [0, 4] and resumed[0]["saves"] == [8]
  out = config_dict["output_path"]
  names = sorted(os.listdir(os.path.join(out, "cpt", "persistent")))
  assert len(names) == 2, names
  with open(os.path.join(out, "cpt", "persistent", names[-1]), "rb") as f:
    state, meta = jax_cpt.decode_state(f.read())
  assert int(state.global_step) == 8 and meta["classes"]
  # 4 steps of the global batch, as JAX counts Adam's and BatchRenorm's.
  assert int(state.opt_state["0"]["count"]) == 4
  assert int(state.batch_stats["encoder"]["stage1_bn"]["steps"]) == 4


def test_the_static_fill_is_on_under_two_processes(trained):
  _, first, resumed = trained
  assert [r["fill_rounds"] for r in first + resumed] == [6] * 4
  assert [r["audits"] for r in first] == [[True, True]] * 2


def test_the_cli_logs_each_rank_and_summarizes_on_rank_0(trained):
  config_dict, _, _ = trained
  out = config_dict["output_path"]
  logs = sorted(os.listdir(os.path.join(out, "logs")))
  assert logs == ["worker_0.log", "worker_1.log"]
  for rank in range(2):
    with open(os.path.join(out, "logs", f"worker_{rank}.log")) as f:
      text = f.read()
    assert f" W:{rank} " in text and "Loaded checkpoint" in text
  with open(os.path.join(out, "tb", "train", "scalars.jsonl")) as f:
    records = [json.loads(line) for line in f]
  assert [r["step"] for r in records if r["tag"] == "loss"] == [2, 4, 6, 8]
  assert all(r["value"] == 1.0 for r in records
             if r["tag"] == "gt/fill_audit_ok")
  assert sorted(os.listdir(os.path.join(out, "progress"))) == [
      "worker_0.json", "worker_1.json"]
