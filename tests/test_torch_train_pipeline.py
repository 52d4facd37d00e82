"""The PyTorch port's training pipeline (corenet_tpu_torch/train/pipeline.py)
and its step triggers against the JAX package's, on the CPU.

`TrainPipeline` trains a bf16 CoreNet at 32³ on the fixture dataset
(tests/helpers.py, 4 scenes, batch 2) for 8 steps with the phase loss on
ground truth voxelized in the step and the static fill with its audit,
then resumes. Checked: the checkpoint names and tiers against what the
JAX package's CheckpointManager writes on the same StepEvent schedule;
the port's `.cpt` in JAX's `decode_state`; the data order of a resumed
run against the JAX pipeline's loader (and the profiler's trace); the
fill audit's cadence; a
recurrent eval's CSV and scalars, with the training model left in train
mode; the refusals that name the slices still to come. The CLI and the
encoder `.npz` are in tests/test_torch_train_cli.py.
"""

import datetime
import json
import os

import jax
import numpy as np
import pytest
import torch

from corenet_tpu import config as jax_config
from corenet_tpu.parallel import mesh as jax_mesh
from corenet_tpu.train import checkpoint as jax_cpt
from corenet_tpu.train import pipeline as jax_pipeline
from corenet_tpu.utils import misc as jax_misc
from corenet_tpu_torch import config as cfg
from corenet_tpu_torch.train import pipeline
from corenet_tpu_torch.utils import misc
from helpers import make_fixture_dataset

torch.set_num_threads(2)

RES = 32
BATCH = 2
SCENES = 4
MAX_STEPS = 8


def full_config_dict(root, manifest, meshes_dir, **train):
  """A TrainPipeline configuration (JSON data) at 32³, batch 2: FG_BG with
  h7's voxelization at multiplier 2, the static 6-round fill and its audit
  every 4 steps, temp checkpoints every 4 steps and persistent ones every
  6, the loss every 2, one recurrent eval of the same scenes every 8."""

  def data():
    return {
        "datasets": [{"dataset_path": manifest, "meshes_dir": meshes_dir,
                      "shuffle": "PER_EPOCH"}],
        "shuffle": "PER_EPOCH",
        "data_loader": {"num_data_workers": 2, "batch_size": BATCH,
                        "prefetch_factor": 2, "worker_processes": False},
        "voxelization_config": {
            "task_type": "FG_BG",
            "resolution": {"depth": RES, "height": RES, "width": RES},
            "conservative_rasterization": False,
            "voxelization_image_resolution_multiplier": 2,
            "voxelization_fill_rounds": 6}}

  return {
      "string_templates": [],
      "train": dict({
          "data": data(), "resnet50_imagenet_checkpoint": "",
          "checkpoint_interval": 4, "persistent_checkpoint_interval": 6,
          "tensorboard_log_interval": 2, "initial_learning_rate": 4e-4,
          "fill_audit_interval": 4, "max_steps": MAX_STEPS}, **train),
      "eval": [{"start_step": 0, "interval": 8,
                "persistent_checkpoint": False,
                "config": {"name": "mini_eval", "data": data(),
                           "num_qualitative_results": 0}}],
      "output_path": os.path.join(root, "out"),
  }


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
  root = str(tmp_path_factory.mktemp("train_pipeline"))
  manifest, meshes_dir = make_fixture_dataset(
      os.path.join(root, "ds"), num_scenes=SCENES, image_size=64)
  return root, manifest, meshes_dir


@pytest.fixture(scope="module")
def trained(dataset):
  """The pipeline after its 8 steps, with the fill audits it ran."""
  root, manifest, meshes_dir = dataset
  full = cfg.config_from_dict(
      cfg.TrainPipeline, full_config_dict(root, manifest, meshes_dir))
  p = pipeline.TrainPipeline(full.train, full.output_path, device="cpu")
  audits = []
  real_audit = p.audit_static_fill
  p.audit_static_fill = lambda: audits.append(real_audit()) or audits[-1]
  evals = pipeline.RecurrentEvals(full.eval, full.output_path)
  p.run(recurrent_evals=evals)
  return p, full, audits


class _Clock:
  """A datetime module whose clock the test sets."""

  def __init__(self):
    self.now_value = datetime.datetime(2026, 1, 1)
    clock = self

    class _DateTime(datetime.datetime):
      @classmethod
      def now(cls, tz=None):
        return clock.now_value

    self.datetime = _DateTime


@pytest.mark.parametrize("start,interval", [(0, 1), (0, 4), (3, 4), (5, 7),
                                            (10, 3), (0, 16)])
def test_step_event_matches_jax(start, interval):
  port, ref = misc.StepEvent(start, interval), jax_misc.StepEvent(
      start, interval)
  fired = 0
  for prev in range(0, 40):
    for step in (1, 2, 4, 5):
      got = port.trigger(prev, prev + step)
      assert got == ref.trigger(prev, prev + step), (prev, step)
      fired += got
  assert fired > 0
  assert repr(port) == repr(ref)


def test_timed_event_and_eta_match_jax(monkeypatch):
  for module in (misc, jax_misc):
    monkeypatch.setattr(module, "datetime", _Clock())
  clocks = (misc.datetime, jax_misc.datetime)
  events = (misc.TimedEvent(10.0), jax_misc.TimedEvent(10.0))
  etas = (misc.Eta(100, 1100), jax_misc.Eta(100, 1100))
  for seconds in (0, 5, 11, 12, 25, 3600 * 30 + 61):
    for clock in clocks:
      clock.now_value = datetime.datetime(2026, 1, 1) + datetime.timedelta(
          seconds=seconds)
    assert events[0].trigger() == events[1].trigger(), seconds
    for current in (100, 101, 350, 1099):
      assert etas[0].cur_eta_sec(current) == etas[1].cur_eta_sec(current)
      assert etas[0].cur_eta_str(current) == etas[1].cur_eta_str(current)
  assert repr(events[0]) == repr(events[1])


def _jax_checkpoint_names(tmp_path, config):
  """The files the JAX package's CheckpointManager writes when its run
  loop saves on this configuration's schedule: step 0, then each step
  the temp or persistent StepEvent fires on, then max_steps persistent."""
  manager = jax_cpt.CheckpointManager(str(tmp_path / "cpt"))
  params = {"w": np.zeros((2,), np.float32)}
  from corenet_tpu.train import state as jax_state
  opt = jax_state.create_optimizer()
  state = jax_state.create_train_state({"params": params, "batch_stats": {}},
                                       opt)
  manager.save_state(state, {})
  temp = jax_misc.StepEvent(0, config.checkpoint_interval)
  persistent = jax_misc.StepEvent(0, config.persistent_checkpoint_interval)
  prev = 0
  for step in range(BATCH, config.max_steps + 1, BATCH):
    at = state.replace(global_step=step)
    if persistent.trigger(prev, step):
      manager.save_state(at, {}, persistent=True)
    elif temp.trigger(prev, step):
      manager.save_state(at, {})
    prev = step
  manager.save_state(state.replace(global_step=config.max_steps), {},
                     persistent=True)
  return sorted(os.path.relpath(p, str(tmp_path / "cpt"))
                for p in manager.list_checkpoints())


def test_checkpoints_are_named_and_tiered_as_jax_names_them(trained,
                                                            tmp_path):
  p, full, _ = trained
  assert p.state.global_step == MAX_STEPS
  got = sorted(os.path.relpath(path, os.path.join(full.output_path, "cpt"))
               for path in p.cpt_manager.list_checkpoints())
  want = _jax_checkpoint_names(tmp_path, full.train)
  assert got == want
  assert got == ["persistent/state_000000006.cpt",
                 "persistent/state_000000008.cpt",
                 "temp/state_000000000.cpt", "temp/state_000000004.cpt",
                 "temp/state_000000008.cpt"]


def test_the_port_checkpoint_decodes_in_jax(trained):
  p, full, _ = trained
  path = p.cpt_manager.last_checkpoint_path()
  with open(path, "rb") as f:
    state, meta = jax_cpt.decode_state(f.read())
  assert int(state.global_step) == MAX_STEPS
  assert meta["classes"] == list(p.classes)
  jax_train = jax_config.config_from_dict(jax_config.TrainConfig,
                                          meta["train_config"])
  assert jax_train.max_steps == MAX_STEPS
  assert int(state.opt_state["0"]["count"]) == MAX_STEPS // BATCH
  kernel = state.params["decoder"]["stage_0"]["kernel"]
  np.testing.assert_array_equal(
      kernel, p.model.decoder.stage_0.weight.detach().numpy().T)
  steps = state.batch_stats["encoder"]["stage1_bn"]["steps"]
  assert int(steps) == MAX_STEPS // BATCH  # one per step, eval left it


def test_the_fill_audit_runs_on_its_cadence(trained):
  """Once at the first step and at each crossing of 4 and 8; each audited
  cube converged; successive audits rotate through the batch."""
  p, _, audits = trained
  assert p.fill_rounds == 6
  assert audits == [True, True, True]
  assert p._fill_audit_count == 3
  with open(os.path.join(p.output_path, "tb", "train",
                         "scalars.jsonl")) as f:
    rows = [json.loads(line) for line in f]
  assert [r["step"] for r in rows if r["tag"] == "loss"] == [2, 4, 6, 8]
  assert [r["step"] for r in rows
          if r["tag"] == "gt/fill_audit_ok"] == [2, 4, 8]
  assert all(np.isfinite(r["value"]) for r in rows)


def test_the_recurrent_eval_writes_its_results(trained):
  """The eval at step 8: its CSV and scalars, its mean IoU in the train
  stream, the training model still in train mode with bf16 compute."""
  p, full, _ = trained
  out = full.output_path
  csv = os.path.join(out, "evals", "mini_eval", "8", "voxel_metrics.csv")
  with open(csv) as f:
    rows = [line.split(",") for line in f.read().splitlines()]
  assert rows[0][1:] == ["__void__", "class_a", "class_b", "__global__"]
  assert [r[0] for r in rows[1:]] == ["iou", "precision", "recall"]
  with open(os.path.join(out, "tb", "mini_eval", "scalars.jsonl")) as f:
    scalars = {json.loads(line)["tag"]: json.loads(line) for line in f}
  assert scalars["General/mIoU"]["step"] == MAX_STEPS
  assert 0.0 <= scalars["General/mIoU"]["value"] <= 1.0
  with open(os.path.join(out, "tb", "train", "scalars.jsonl")) as f:
    assert any(json.loads(line)["tag"] == "eval/mini_eval/mIoU"
               for line in f)
  assert p.model.training
  assert p.model.compute_dtype == torch.bfloat16
  assert p.model.phase_output  # the phase loss, auto for FG_BG


def test_resume_continues_at_the_saved_step_in_jax_order(trained):
  """A fresh pipeline on the same output resumes at step 8 with the saved
  weights, and its next epoch's batches are the JAX pipeline's loader's
  (scenes, images and random grid offsets) from that step."""
  p, full, _ = trained
  resumed = pipeline.TrainPipeline(full.train, full.output_path,
                                   device="cpu")
  state = resumed.create_or_load_state()
  assert state.global_step == MAX_STEPS
  for (name, a), b in zip(state.model.state_dict().items(),
                          p.model.state_dict().values()):
    assert torch.equal(a, b), name

  jax_full = jax_config.config_from_dict(
      jax_config.TrainPipeline, cfg.config_to_dict(full))
  ref = jax_pipeline.TrainPipeline(
      jax_full.train, str(full.output_path) + "_jax",
      mesh=jax_mesh.create_mesh(data=BATCH, devices=jax.devices()[:BATCH]))
  for start in (MAX_STEPS, MAX_STEPS + BATCH, MAX_STEPS - BATCH):
    got = list(resumed._epoch_loader(start))
    want = list(ref._epoch_loader(start))
    assert len(got) == len(want) > 0
    for (hb, _), (jb, _) in zip(got, want):
      assert hb.scene_ids == jb.scene_ids
      np.testing.assert_array_equal(hb.image, jb.image)
      np.testing.assert_array_equal(hb.grid_offset, jb.grid_offset)

  seen = []
  real_step = resumed.train_step

  def spy(state, batch):
    seen.append(batch["image"].numpy().copy())
    return real_step(state, batch)

  resumed.train_step = spy
  # The profiler window opens at the first iteration; the run ends inside
  # it, and the trace is written all the same.
  trace_dir = os.path.join(full.output_path, "profile")
  resumed.run(max_steps=MAX_STEPS + BATCH, profile_dir=trace_dir,
              profile_start=0, profile_steps=5)
  assert resumed.state.global_step == MAX_STEPS + BATCH
  with open(os.path.join(trace_dir, "trace.json")) as f:
    assert "traceEvents" in json.load(f)
  first, _ = next(iter(ref._epoch_loader(MAX_STEPS)))
  assert len(seen) == 1
  np.testing.assert_array_equal(seen[0], first.image)


def test_refusals_name_their_slices(dataset, caplog):
  root, manifest, meshes_dir = dataset
  full = cfg.config_from_dict(
      cfg.TrainPipeline, full_config_dict(root, manifest, meshes_dir))
  out = os.path.join(root, "refused")
  for kwargs, slice_name in ((dict(gt_mode="host"), "slice 8b"),
                             (dict(mesh=object()), "slice 7")):
    with pytest.raises(NotImplementedError, match=slice_name):
      pipeline.TrainPipeline(full.train, out, device="cpu", **kwargs)
  with pytest.raises(ValueError, match="phase_loss"):
    pipeline.TrainPipeline(
        cfg.config_from_dict(cfg.TrainPipeline, full_config_dict(
            root, manifest, meshes_dir, last_upscale_factor=4)).train, out,
        phase_loss=True, device="cpu")
  with caplog.at_level("INFO"):
    auto = pipeline.TrainPipeline(full.train, out, device="cpu")
    fine = pipeline.TrainPipeline(full.train, out, device="cpu",
                                  decoder_execution="fine",
                                  compute_dtype="float32", phase_loss=False)
  # 32³ has a seed grid of 1³, which does not pack: 'auto' trains the
  # fine decoder there, and 'packed' is refused.
  notes = [r.getMessage() for r in caplog.records
           if r.getMessage().startswith("decoder execution: ")]
  assert notes == ["decoder execution: fine (decoder_execution='auto')",
                   "decoder execution: fine (decoder_execution='fine')"]
  assert not auto.model.packed_decoder
  with pytest.raises(ValueError, match="even grid at the packing point"):
    pipeline.TrainPipeline(full.train, out, device="cpu",
                           decoder_execution="packed")
  assert auto.model.compute_dtype == torch.bfloat16
  assert fine.model.compute_dtype is None and not fine.model.phase_output


def test_an_epoch_the_batch_does_not_divide_goes_on(tmp_path):
  """3 scenes, batch 2: one full batch per epoch. The JAX pipeline derives
  the epoch from all 3, so from step 2 its loader has one example left
  and yields no batch: its train_steps raises "Empty training dataset".
  The port starts the next epoch there: the scenes of the JAX loader's
  epoch 1 (from step 3), and training goes on."""
  manifest, meshes_dir = make_fixture_dataset(
      str(tmp_path / "ds"), num_scenes=3, image_size=64)
  full = cfg.config_from_dict(cfg.TrainPipeline, full_config_dict(
      str(tmp_path), manifest, meshes_dir))
  p = pipeline.TrainPipeline(full.train, full.output_path, device="cpu")
  jax_full = jax_config.config_from_dict(
      jax_config.TrainPipeline, cfg.config_to_dict(full))
  ref = jax_pipeline.TrainPipeline(
      jax_full.train, str(tmp_path / "jax"),
      mesh=jax_mesh.create_mesh(data=BATCH, devices=jax.devices()[:BATCH]))
  assert list(ref._epoch_loader(2)) == []
  for start, jax_start in ((0, 0), (2, 3), (4, 6)):
    got = [hb.scene_ids for hb, _ in p._epoch_loader(start)]
    want = [hb.scene_ids for hb, _ in ref._epoch_loader(jax_start)]
    assert got == want and len(got) == 1, (start, got, want)

  def fake_step(state, batch):
    return (state.__class__(state.model, state.optimizer,
                            state.global_step + BATCH),
            {"loss": torch.zeros(())})

  p.state = pipeline.state_lib.TrainState(None, None, 0)
  p.train_step = fake_step
  steps = p.train_steps()
  assert [next(steps)[0] for _ in range(4)] == [2, 4, 6, 8]
