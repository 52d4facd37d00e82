"""The PyTorch port's packed (space-to-depth) execution through its entry
points, on the CPU: TrainPipeline with decoder_execution="packed", and the
packed flags of the train, eval and demo CLIs. The packed model itself is
held against the JAX package in tests/test_torch_packed_model.py.
"""

import dataclasses
import os

import pytest
import torch

from corenet_tpu_torch import config as cfg
from corenet_tpu_torch.cli import demo as demo_cli
from corenet_tpu_torch.cli import eval as eval_cli
from corenet_tpu_torch.cli import train as train_cli
from corenet_tpu_torch.models.corenet import (
    CoreNet, CoreNetConfig, DecoderConfig)
from corenet_tpu_torch.ops import phased_gt as phased
from corenet_tpu_torch.train import pipeline
from corenet_tpu_torch.utils import flags
from helpers import make_fixture_dataset
from test_torch_saved_states import (  # noqa: F401  (an autouse fixture)
    remove_states_after_each_test)

torch.set_num_threads(2)


def test_train_pipeline_trains_packed(tmp_path):
  """TrainPipeline(decoder_execution="packed") at 64³ (a 2³ seed grid, the
  smallest that packs at every stage): two steps of the packed decoder
  with the phase loss, K4's path at s = 4, and a checkpoint that a fine
  model loads; 'auto' packs there too."""
  manifest, meshes_dir = make_fixture_dataset(str(tmp_path / "ds"),
                                              num_scenes=4, image_size=64)
  data = {"datasets": [{"dataset_path": manifest, "meshes_dir": meshes_dir,
                        "shuffle": "PER_EPOCH"}],
          "data_loader": {"num_data_workers": 2, "batch_size": 2,
                          "prefetch_factor": 2, "worker_processes": False},
          "shuffle": "PER_EPOCH",
          "voxelization_config": {
              "task_type": "FG_BG",
              "resolution": {"depth": 64, "height": 64, "width": 64},
              "conservative_rasterization": False,
              # h7's multiplier: the blocked rasterizer and K4's path.
              "voxelization_image_resolution_multiplier": 8}}
  full = cfg.config_from_dict(cfg.TrainPipeline, {
      "string_templates": [], "output_path": str(tmp_path / "out"),
      "eval": [],
      "train": {"data": data, "resnet50_imagenet_checkpoint": "",
                "checkpoint_interval": 100,
                "persistent_checkpoint_interval": 100,
                "tensorboard_log_interval": 2, "max_steps": 4}})
  # 'auto' packs where the model is eligible, as in the JAX package.
  for execution, packed in (("auto", True), ("fine", False)):
    model = pipeline.TrainPipeline(full.train, full.output_path,
                                   decoder_execution=execution,
                                   device="cpu").model
    assert model.packed_decoder == packed and model.phase_output
  p = pipeline.TrainPipeline(full.train, full.output_path,
                             decoder_execution="packed",
                             compute_dtype="float32", device="cpu")
  assert p.model.packed_decoder and p.model.phase_output
  factors = []
  real = phased.phased_gt_forward
  phased.phased_gt_forward = lambda packed, s: (factors.append(s),
                                                real(packed, s))[1]
  try:
    p.run()
  finally:
    phased.phased_gt_forward = real
  assert p.state.global_step == 4 and factors == [4, 4]
  loss = [line for line in open(os.path.join(
      full.output_path, "tb", "train", "scalars.jsonl"))]
  assert len(loss) == 2
  fine = CoreNet(p.model_config)
  fine.load_state_dict(p.model.state_dict())


class _Stop(Exception):
  pass


def test_clis_pass_the_packed_flags(monkeypatch):
  """--packed_inference / --nopacked_inference reach super-resolution in
  the eval and demo CLIs, --decoder_execution=packed the TrainPipeline."""
  seen = []

  def record(*args, **kwargs):
    seen.append(kwargs.get("packed_execution", kwargs.get(
        "decoder_execution")))
    raise _Stop

  model = CoreNet(CoreNetConfig(DecoderConfig((32,) * 3, 2)))
  monkeypatch.setattr(eval_cli, "load_model",
                      lambda path: (model, None, None, 0))
  monkeypatch.setattr(eval_cli, "super_resolution_from_model", record)
  import corenet_tpu_torch.eval.super_resolution as sr
  monkeypatch.setattr(sr, "super_resolution_from_model", record)
  monkeypatch.setattr(train_cli, "TrainPipeline", record)
  monkeypatch.setattr(train_cli, "load_config_file", lambda *a, **k: (
      dataclasses.make_dataclass("C", ["train", "output_path", "eval"])(
          None, "", [])))
  monkeypatch.setattr(train_cli, "config_to_dict", lambda c: {})
  for flag in ("--packed_inference", "--nopacked_inference"):
    with pytest.raises(_Stop):
      eval_cli.main(["--checkpoint_path=x.cpt", "--output_path=out",
                     "--device=cpu", flag])
  assert seen == [True, False]
  with pytest.raises(_Stop):
    train_cli.main(["--config_path=c.json", "--device=cpu",
                    "--decoder_execution=packed"])
  assert seen[-1] == "packed"
  for flag, value in (("--packed_inference", True),
                      ("--nopacked_inference", False)):
    args = flags.parse_flags(demo_cli.ProgramArgs, [
        "--scene=s.npz", "--meshes_dir=m", "--checkpoint=c.cpt", flag])
    assert args.packed_inference is value


def test_recurrent_evals_decode_fine_unless_asked(monkeypatch):
  """The in-training evals take the fine decoder, whatever the training
  model runs, unless RecurrentEvals is asked for the packed one."""
  seen = []

  def record(model, resolution, **kwargs):
    seen.append(kwargs["packed_execution"])
    raise _Stop

  monkeypatch.setattr(pipeline, "super_resolution_inference_factory", record)
  model = CoreNet(CoreNetConfig(DecoderConfig((64,) * 3, 2)),
                  packed_decoder=True)
  trainer = type("Trainer", (), {"model": model,
                                 "model_config": model.config,
                                 "device": torch.device("cpu")})
  for kwargs in ({}, {"packed_execution": True}):
    with pytest.raises(_Stop):
      pipeline.RecurrentEvals([], "out", **kwargs).run_single(trainer, None, 0)
  assert seen == [False, True]
