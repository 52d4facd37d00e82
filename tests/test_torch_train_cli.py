"""The PyTorch port's train CLI (corenet_tpu_torch/cli/train.py) and its
encoder `.npz` reader (corenet_tpu_torch/cli/import_resnet50_checkpoint.py)
against the JAX package's, on the CPU.

`main` trains the configuration of tests/test_torch_train_pipeline.py
(32³, batch 2, bf16, the phase loss) for one step, then
`python -m corenet_tpu_torch.cli.train` resumes it from its newest `.cpt`
for one more, with a recurrent eval; the JAX package's `decode_state`
reads the result. The flags are the JAX `ProgramArgs`' names and
defaults, plus --device. The encoder `.npz` is written from a JAX tree as
the JAX importer lays it out, and loads as the JAX package loads it.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from corenet_tpu.cli import import_resnet50_checkpoint as jax_import
from corenet_tpu.cli import train as jax_train_cli
from corenet_tpu.train import checkpoint as jax_cpt
from corenet_tpu.utils import flags as jax_flags
from corenet_tpu_torch import config as cfg
from corenet_tpu_torch.cli import import_resnet50_checkpoint as npz_reader
from corenet_tpu_torch.cli import train as train_cli
from corenet_tpu_torch.models.convert import state_dict_from_jax
from corenet_tpu_torch.models.corenet import (
    CoreNet, CoreNetConfig, DecoderConfig)
from corenet_tpu_torch.train import pipeline
from corenet_tpu_torch.utils import flags
from helpers import make_fixture_dataset
from test_torch_model import _variables
from test_torch_train_pipeline import BATCH, full_config_dict

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
  root = str(tmp_path_factory.mktemp("train_cli"))
  manifest, meshes_dir = make_fixture_dataset(
      os.path.join(root, "ds"), num_scenes=4, image_size=64)
  data = full_config_dict(root, manifest, meshes_dir)
  data["eval"][0].update(start_step=4, interval=4)
  path = os.path.join(root, "train.json5")
  with open(path, "w") as f:
    json.dump(data, f)
  return path, data["output_path"]


def test_train_cli_trains_resumes_and_writes_what_jax_reads(config_path):
  path, out = config_path
  p = train_cli.main([f"--config_path={path}", "--max_steps=2",
                      "--device=cpu", "--compilation_cache_dir=/nowhere"])
  assert p.state.global_step == 2
  assert p.model.compute_dtype == torch.bfloat16 and p.model.phase_output
  names = sorted(os.listdir(os.path.join(out, "cpt", "persistent")))
  assert names == ["state_000000002.cpt"]

  # Resume in a fresh interpreter, as a user restarts: one more step, the
  # eval at its start step 4.
  env = dict(os.environ, PYTHONPATH=REPO)
  run = subprocess.run(
      [sys.executable, "-m", "corenet_tpu_torch.cli.train",
       f"--config_path={path}", "--max_steps=4", "--device=cpu"],
      cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
  assert run.returncode == 0, run.stderr[-3000:]
  assert "Loaded checkpoint" in run.stderr and "state_000000002" in run.stderr
  assert sorted(os.listdir(os.path.join(out, "cpt", "persistent"))) == [
      "state_000000002.cpt", "state_000000004.cpt"]
  assert sorted(os.listdir(os.path.join(out, "cpt", "temp"))) == [
      "state_000000000.cpt", "state_000000004.cpt"]
  assert os.path.exists(os.path.join(out, "evals", "mini_eval", "4",
                                     "voxel_metrics.csv"))
  with open(os.path.join(out, "tb", "mini_eval", "scalars.jsonl")) as f:
    assert {json.loads(line)["step"] for line in f} == {4}

  with open(os.path.join(out, "cpt", "persistent", "state_000000004.cpt"),
            "rb") as f:
    state, meta = jax_cpt.decode_state(f.read())
  assert int(state.global_step) == 4
  assert int(state.opt_state["0"]["count"]) == 4 // BATCH
  full = cfg.config_from_dict(cfg.TrainPipeline, meta["full_config"])
  assert full.output_path == out and full.eval[0].config.name == "mini_eval"
  assert meta["train_config"] == meta["full_config"]["train"]
  assert meta["classes"] == ["__void__", "class_a", "class_b"]


def _defaults(cls):
  out = {}
  for f in dataclasses.fields(cls):
    if f.default is not dataclasses.MISSING:
      out[f.name] = f.default
    elif f.default_factory is not dataclasses.MISSING:
      out[f.name] = f.default_factory()
    else:
      out[f.name] = None
  return out


def test_flags_are_the_jax_clis(config_path):
  """The same flag names and defaults as the JAX CLI, plus --device, and
  the same values from the same command line."""
  ours = _defaults(train_cli.ProgramArgs)
  theirs = _defaults(jax_train_cli.ProgramArgs)
  assert ours.pop("device") == "cuda"
  assert ours == theirs
  argv = ["--config_path=c.json5", "-D", "a=b", "--set", "train.x=1",
          "--max_steps=7", "--compute_dtype=float32", "--phase_loss=off",
          "--renorm_ramp_start=0", "--profile_dir=p", "--nomultihost"]
  got = dataclasses.asdict(flags.parse_flags(train_cli.ProgramArgs, argv))
  want = dataclasses.asdict(jax_flags.parse_flags(jax_train_cli.ProgramArgs,
                                                  argv))
  assert got.pop("device") == "cuda"
  assert got == want


def test_train_cli_refusals(config_path, monkeypatch):
  path, _ = config_path
  for extra, slice_name in (("--multihost", "slice 7"),
                            ("--space=2", "slice 7"),
                            ("--gt_mode=host", "slice 8b")):
    with pytest.raises(NotImplementedError, match=slice_name):
      train_cli.main([f"--config_path={path}", "--device=cpu", extra])
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    train_cli.main([f"--config_path={path}"])


def _encoder_npz(path):
  """An encoder `.npz` in the JAX importer's flat layout, from the JAX
  tree of tests/test_torch_model.py with every value moved: the JAX
  package's own `load_encoder_variables` reads it."""
  variables = _variables(32)
  rng = np.random.default_rng(2)
  flat = {}
  for collection in ("params", "batch_stats"):
    stack = [((collection, "encoder"), variables[collection]["encoder"])]
    while stack:
      prefix, node = stack.pop()
      for key, value in node.items():
        if isinstance(value, dict):
          stack.append((prefix + (key,), value))
        elif key == "steps":
          flat["/".join(prefix + (key,))] = np.zeros([], np.int32)
        else:
          flat["/".join(prefix + (key,))] = (
              value + rng.normal(0, 0.01, value.shape)).astype(np.float32)
  np.savez(path, **flat)
  return variables, flat


def test_the_encoder_npz_loads_as_jax_loads_it(tmp_path):
  path = str(tmp_path / "encoder.npz")
  variables, flat = _encoder_npz(path)
  assert len(flat) > 300
  merged = jax_import.load_encoder_variables(variables, path)
  want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, merged))
  fresh = state_dict_from_jax(variables)
  got = npz_reader.load_encoder_variables(fresh, path)
  assert sorted(got) == sorted(want)
  changed = 0
  for key, value in want.items():
    assert torch.equal(got[key], value), key
    assert got[key].dtype == fresh[key].dtype, key
    changed += not torch.equal(value, fresh[key])
  assert changed == len(flat) - sum(k.endswith("steps") for k in flat)
  assert all(torch.equal(got[k], fresh[k]) for k in fresh
             if k.startswith("decoder."))

  np.savez(str(tmp_path / "bad.npz"), **{"params/encoder/nope/kernel":
                                         np.zeros((1, 1, 3, 4), np.float32)})
  with pytest.raises(KeyError, match="nope"):
    npz_reader.load_encoder_variables(fresh, str(tmp_path / "bad.npz"))
  np.savez(str(tmp_path / "shape.npz"), **{
      "params/encoder/stage1_conv/bias": np.zeros(3, np.float32)})
  with pytest.raises(ValueError, match="shape"):
    npz_reader.load_encoder_variables(fresh, str(tmp_path / "shape.npz"))

  # The pipeline's encoder import reads the file into its model.
  model = CoreNet(CoreNetConfig(DecoderConfig((32,) * 3, 2)))
  p = pipeline.TrainPipeline.__new__(pipeline.TrainPipeline)
  p.model = model
  p.config = cfg.TrainConfig(data=None, resnet50_imagenet_checkpoint=path)
  p._load_encoder_weights()
  for key, value in model.state_dict().items():
    if key.startswith("encoder."):
      assert torch.equal(value, want[key]), key
