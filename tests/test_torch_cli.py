"""The port's eval and demo CLIs (python -m corenet_tpu_torch.cli.eval /
.cli.demo) against the JAX package's, on the CPU, on one `.cpt` that
`corenet_tpu.train.checkpoint.encode_state` writes, over the fixture
dataset of tests/helpers.py; after
tests/test_cli_tools.py::test_train_cli_then_demo.

The checkpoint holds a seeded 32³ CoreNet (the port's seeded init with
random BatchRenorm statistics, bridged into a JAX TrainState with optax's
initial state), a full_config with one eval that asks for qualitative
results, and the classes. Both eval CLIs voxelize the same GT, agree on
the mean IoU within 1e-3 (the tolerance of
tests/test_torch_eval_pipeline.py: the frameworks' float32 logits differ
in their last digits, and a voxel whose two classes tie within that flips
its argmax) and write the same number of `img_*.png` tiles, drawn at 64²
per view here to keep the CPU's rasterizer quick. The demo CLIs are held
to each other in tests/test_torch_cli_demo.py on the same checkpoint.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corenet_tpu.cli import eval as jax_eval
from corenet_tpu.eval import qualitative as jax_qualitative
from corenet_tpu.eval import results as jax_results
from corenet_tpu.train import checkpoint as jax_cpt
from corenet_tpu.train import state as jax_state
from corenet_tpu_torch.cli import eval as eval_cli
from corenet_tpu_torch.eval import pipeline
from corenet_tpu_torch.eval import results
from corenet_tpu_torch.models.convert import jax_variables_from_state_dict
from corenet_tpu_torch.models.corenet import (
    CoreNet, CoreNetConfig, DecoderConfig)
from corenet_tpu_torch.utils.png import decode_png
from helpers import make_fixture_dataset

torch.set_num_threads(2)

RES = 32
SCENES = 3
QUALITATIVE = 2
TILE_VIEW = (64, 64)


def _data_pipeline(manifest, meshes_dir):
  return {
      "datasets": [{"dataset_path": manifest, "meshes_dir": meshes_dir,
                    "shuffle": "NEVER"}],
      "shuffle": "NEVER",
      "data_loader": {"num_data_workers": 2, "batch_size": 2,
                      "prefetch_factor": 2, "worker_processes": False},
      "voxelization_config": {
          "task_type": "FG_BG",
          "resolution": {"depth": RES, "height": RES, "width": RES},
          "conservative_rasterization": False,
          "voxelization_image_resolution_multiplier": 8}}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
  """(.cpt path, scene NPZ path, meshes dir, the seeded model)."""
  root = tmp_path_factory.mktemp("cli")
  manifest, meshes_dir = make_fixture_dataset(str(root / "ds"),
                                              num_scenes=SCENES)
  model = CoreNet(CoreNetConfig(DecoderConfig((RES,) * 3, 2)))
  model.reset_parameters(torch.Generator().manual_seed(0))
  gen = torch.Generator().manual_seed(1)
  with torch.no_grad():
    for name, buf in model.named_buffers():
      if name.endswith(".mean"):
        buf.copy_(torch.randn(buf.shape, generator=gen) * 0.3)
      elif name.endswith(".var"):
        buf.copy_(torch.rand(buf.shape, generator=gen) * 1.5 + 0.5)
  variables = jax.tree_util.tree_map(
      jnp.asarray, jax_variables_from_state_dict(model.state_dict()))
  state = jax_state.create_train_state(variables,
                                       jax_state.create_optimizer())
  data = _data_pipeline(manifest, meshes_dir)
  full_config = {
      "string_templates": [], "output_path": str(root / "train"),
      "train": {"data": data, "resnet50_imagenet_checkpoint": ""},
      "eval": [{"start_step": 0, "interval": 10 ** 9,
                "persistent_checkpoint": False,
                "config": {"name": "cli_eval", "data": data,
                           "num_qualitative_results": QUALITATIVE,
                           "num_qualitative_results_in_tensor_board": 1}}]}
  path = root / "state_000000000.cpt"
  path.write_bytes(jax_cpt.encode_state(state, {
      "full_config": full_config,
      "classes": ["__void__", "class_a", "class_b"]}))
  scene = os.path.join(os.path.dirname(manifest),
                       json.load(open(manifest))["files"][0])
  return str(path), scene, meshes_dir, model


def _recording(monkeypatch, module):
  """Records the GT grids a package's QuantitativeResults sees."""
  grids = []
  add_batch = module.QuantitativeResults.add_batch

  def recording(self, pmf, gt_grid, *args, **kwargs):
    grids.append(np.asarray(gt_grid))
    return add_batch(self, pmf, gt_grid, *args, **kwargs)

  monkeypatch.setattr(module.QuantitativeResults, "add_batch", recording)
  return grids


def test_both_eval_clis_agree_on_a_jax_checkpoint(checkpoint, tmp_path,
                                                  monkeypatch):
  path, _, _, _ = checkpoint
  monkeypatch.setattr(jax_qualitative, "QualitativeResults", functools.partial(
      jax_qualitative.QualitativeResults, image_size=TILE_VIEW))
  monkeypatch.setattr(pipeline, "QualitativeResults", functools.partial(
      pipeline.QualitativeResults, image_size=TILE_VIEW))
  jax_grids = _recording(monkeypatch, jax_results)
  grids = _recording(monkeypatch, results)

  want = jax_eval.main([f"--checkpoint_path={path}",
                        f"--output_path={tmp_path / 'jax'}",
                        "--compilation_cache_dir=none",
                        "--nopacked_inference"])
  got = eval_cli.main([f"--checkpoint_path={path}",
                       f"--output_path={tmp_path / 'port'}",
                       "--device=cpu"])
  assert list(got) == list(want) == ["cli_eval"]
  assert abs(got["cli_eval"] - want["cli_eval"]) <= 1e-3, (got, want)

  assert len(grids) == len(jax_grids) == 2
  for a, b in zip(grids, jax_grids):
    np.testing.assert_array_equal(a, b)
  assert 0.01 < float(np.mean(grids[0])) < 0.5

  outs = {}
  for name in ("jax", "port"):
    out = tmp_path / name / "cli_eval" / "0"
    assert (out / "voxel_metrics.csv").exists()
    outs[name] = sorted(p.name for p in out.glob("img_*.png"))
  assert outs["port"] == outs["jax"] and len(outs["port"]) == QUALITATIVE
  tile = decode_png((tmp_path / "port" / "cli_eval" / "0" / outs["port"][0]
                     ).read_bytes())
  assert tile.shape == (5 * 64, 5 * 64, 3)

  # The port's summaries: per-class IoU scalars and the first tile.
  tb = tmp_path / "port" / "tb" / "cli_eval"
  tags = {json.loads(line)["tag"]
          for line in (tb / "scalars.jsonl").read_text().splitlines()}
  assert {"IoU/class_a", "IoU/__void__", "General/mIoU"} <= tags
  assert (tb / "rec_0_0.png").exists()


def test_the_eval_cli_needs_a_card_unless_asked_for_the_cpu(
    checkpoint, tmp_path, monkeypatch):
  path, _, _, _ = checkpoint
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    eval_cli.main([f"--checkpoint_path={path}",
                   f"--output_path={tmp_path}"])
  assert not os.listdir(tmp_path)


def test_a_port_checkpoint_serves_through_the_eval_cli(checkpoint, tmp_path):
  """The port's own `.cpt` (its CheckpointManager, its model and Adam)
  serves through the port's CLI like the JAX-written one."""
  from corenet_tpu_torch.train.checkpoint import CheckpointManager
  from corenet_tpu_torch.train.state import create_train_state
  path, _, _, model = checkpoint
  _, extra = jax_cpt.decode_state(open(path, "rb").read())
  extra["full_config"]["eval"][0]["config"]["num_qualitative_results"] = 0
  saved = CheckpointManager(str(tmp_path / "cpt")).save_state(
      create_train_state(model, global_step=8, device="cpu"), extra)
  got = eval_cli.main([f"--checkpoint_path={saved}",
                       f"--output_path={tmp_path / 'out'}", "--device=cpu",
                       "--max_scenes=2"])
  assert 0 < got["cli_eval"] < 1
  assert (tmp_path / "out" / "cli_eval" / "8" / "voxel_metrics.csv").exists()
