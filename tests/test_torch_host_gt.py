"""The port's ground truth on the host (data/batching.py::host_voxelize,
TrainPipeline's and the train CLI's gt_mode="host") against the JAX
package's host GT and the port's own GT voxelized in the step, on the CPU.

On batches of tests/helpers.py's fixture dataset (cubes with seeded
shifts, random grid offsets), for FG_BG, SEMANTIC and instance content,
with and without sub-grid sampling: the port's host grids equal the JAX
package's bit for bit, and equal the port's `train/gt.py::voxelize_batch`
on the same batch. `TrainPipeline(gt_mode="host")` at 32³ gives its
batches that `grid` and `v2x`, and one float32 step on them gives the
loss of the step that voxelizes the same batch itself, within 1e-6
relative. The train CLI with --gt_mode=host runs 2 steps.
"""

import copy
import json
import os

import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu.data import batching as jax_batching
from corenet_tpu.data.dataset import CoreNetDatasetImpl as JaxDatasetImpl
from corenet_tpu_torch import config as cfg
from corenet_tpu_torch.cli import train as train_cli
from corenet_tpu_torch.data import batching
from corenet_tpu_torch.data.dataset import CoreNetDatasetImpl
from corenet_tpu_torch.train import gt as gt_lib
from corenet_tpu_torch.train import pipeline
from helpers import make_fixture_dataset
from test_torch_saved_states import (  # noqa: F401  (an autouse fixture)
    remove_states_after_each_test)
from test_torch_train_pipeline import BATCH, RES, full_config_dict

torch.set_num_threads(2)

TASKS = ("FG_BG", "SEMANTIC", "MESH_INDEX")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
  root = str(tmp_path_factory.mktemp("host_gt"))
  manifest, meshes_dir = make_fixture_dataset(
      os.path.join(root, "ds"), num_scenes=4, image_size=64)
  return root, manifest, meshes_dir


def _batches(manifest, meshes_dir, max_edge_view):
  """The same two scenes batched by each package, with seeded grid
  offsets."""
  offsets = np.random.default_rng(3).random((2, 3)).astype(np.float32)
  port = CoreNetDatasetImpl(manifest, meshes_dir)
  ref = JaxDatasetImpl(manifest, meshes_dir)
  hb = batching.batch([port[0], port[1]], max_edge_view=max_edge_view,
                      grid_offsets=offsets)
  jb = jax_batching.batch([ref[0], ref[1]], max_edge_view=max_edge_view,
                          grid_offsets=offsets)
  for name in ("triangles", "tri_mesh_slot", "tri_valid", "mesh_labels",
               "mesh_valid", "grid_offset"):
    tt.assert_array_equal(getattr(hb, name), getattr(jb, name))
  return hb, jb


# (resolution, image resolution multiplier, conservative, sub-grid)
SETTINGS = {
    "h7": ((32, 32, 32), 8, False, False),
    "conservative": ((16, 16, 16), 2, True, False),
    "y1": ((16, 16, 16), 5, False, True),
}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("task", TASKS)
def test_host_voxelize_equals_jax_and_the_device_gt(dataset, task, setting):
  _, manifest, meshes_dir = dataset
  res, irm, conservative, sub_grid = SETTINGS[setting]
  hb, jb = _batches(manifest, meshes_dir, max_edge_view=(24 - 4) / irm /
                    max(res))
  kwargs = dict(image_resolution_multiplier=irm,
                conservative_rasterization=conservative,
                sub_grid_sampling=sub_grid)
  grid, v2x = batching.host_voxelize(hb, task, res, **kwargs)
  want_grid, want_v2x = jax_batching.host_voxelize(jb, task, res, **kwargs)
  assert grid.dtype == np.int32 and grid.shape == (2,) + res
  assert v2x.dtype == np.float32 and v2x.shape == (2, 4, 4)
  tt.assert_array_equal(grid, want_grid)
  tt.assert_array_equal(v2x, want_v2x)
  expected_max = {"FG_BG": 1, "SEMANTIC": hb.mesh_labels.max(),
                  "MESH_INDEX": 2}[task]
  assert grid.max() == expected_max and (grid > 0).mean() > 0.01

  inputs = {k: torch.from_numpy(v)
            for k, v in hb.step_inputs(task).items()}
  device_grid, device_v2x = gt_lib.voxelize_batch(
      inputs["triangles"], inputs["tri_mesh_slot"], inputs["tri_valid"],
      inputs["mesh_labels"], inputs["grid_offset"], resolution=res,
      max_bbox_pixels=24, **kwargs)
  tt.assert_array_equal(grid, device_grid.numpy())
  tt.assert_array_equal(v2x, device_v2x.numpy())

  # Without the fill: the shells alone, as JAX's.
  shells, _ = batching.host_voxelize(hb, task, res, fill_inside=False,
                                     **kwargs)
  tt.assert_array_equal(shells, jax_batching.host_voxelize(
      jb, task, res, fill_inside=False, **kwargs)[0])
  assert (shells > 0).sum() < (grid > 0).sum()


def test_the_pipeline_trains_on_host_ground_truth(dataset, tmp_path):
  _, manifest, meshes_dir = dataset
  full = cfg.config_from_dict(cfg.TrainPipeline, full_config_dict(
      str(tmp_path), manifest, meshes_dir))
  p = pipeline.TrainPipeline(full.train, full.output_path, gt_mode="host",
                             compute_dtype="float32", device="cpu")
  vc = full.train.data.voxelization_config
  state = p.create_or_load_state()
  hb, _ = next(iter(p._epoch_loader(0)))
  assert set(hb.extra) == {"grid", "v2x"}
  grid, v2x = batching.host_voxelize(
      hb, "FG_BG", (RES,) * 3,
      image_resolution_multiplier=vc.voxelization_image_resolution_multiplier,
      conservative_rasterization=vc.conservative_rasterization)
  tt.assert_array_equal(hb.extra["grid"], grid)
  tt.assert_array_equal(hb.extra["v2x"], v2x)
  assert grid.shape == (BATCH,) + (RES,) * 3 and grid.max() == 1

  # One step on the host grid, and one from the same state on the same
  # batch without it, which voxelizes the triangles in the step.
  batch = {k: torch.from_numpy(v)
           for k, v in hb.step_inputs("FG_BG").items()}
  model_state = copy.deepcopy(state.model.state_dict())
  optimizer_state = copy.deepcopy(state.optimizer.state_dict())
  _, host_metrics = p.train_step(state, batch)
  state.model.load_state_dict(model_state)
  state.optimizer.load_state_dict(optimizer_state)
  device_batch = {k: v for k, v in batch.items() if k not in ("grid", "v2x")}
  _, device_metrics = p.train_step(state, device_batch)
  host_loss = float(host_metrics["loss"])
  device_loss = float(device_metrics["loss"])
  assert np.isfinite(host_loss)
  assert abs(host_loss - device_loss) <= 1e-6 * abs(device_loss), (
      host_loss, device_loss)

  # The C++ fill is exact: there is no static fill to audit.
  p._last_batch = batch
  assert p.fill_rounds == 6 and p.audit_static_fill() is None
  with pytest.raises(ValueError, match="gt_mode"):
    pipeline.TrainPipeline(full.train, full.output_path, gt_mode="loader",
                           device="cpu")


def test_the_train_cli_trains_on_host_ground_truth(dataset, tmp_path):
  _, manifest, meshes_dir = dataset
  data = full_config_dict(str(tmp_path), manifest, meshes_dir)
  data["eval"] = []
  path = str(tmp_path / "train.json")
  with open(path, "w") as f:
    json.dump(data, f)
  p = train_cli.main([f"--config_path={path}", "--max_steps=2",
                      "--device=cpu", "--gt_mode=host"])
  assert p.gt_mode == "host" and p.state.global_step == 2
  with open(os.path.join(data["output_path"], "tb", "train",
                         "scalars.jsonl")) as f:
    losses = [json.loads(line)["value"] for line in f]
  assert len(losses) == 1 and np.isfinite(losses[0])
