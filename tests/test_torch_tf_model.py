"""The port's frozen-TF-graph path (eval/tf_model.py, cli/tf_model_eval.py
and the demo's `.pb` branch) against the JAX package's, on the CPU.

On the tiny frozen graph of tests/test_tf_model.py (the released graphs'
contract: the four input nodes, a baked `output_resolution`, `class_pdf`
at 16³): the port's `TfFrozenGraphModel` returns the JAX package's PMFs
(float32, within 1e-6), from numpy arrays and from tensors; the train-
free eval through `python -m corenet_tpu_torch.cli.tf_model_eval` on the
fixture dataset at 32³ (8 super-resolution offsets) writes the CSV that
the JAX package's CLI writes over the same graph (mean IoU within 1e-3);
the demo reconstructs from the `.pb`.
"""

import json
import os

import numpy as np
import numpy.testing as tt
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from corenet_tpu.cli import tf_model_eval as jax_tf_model_eval  # noqa: E402
from corenet_tpu.eval.tf_model import (  # noqa: E402
    TfFrozenGraphModel as JaxTfFrozenGraphModel)
from corenet_tpu_torch.cli import demo  # noqa: E402
from corenet_tpu_torch.cli import tf_model_eval  # noqa: E402
from corenet_tpu_torch.eval import qualitative  # noqa: E402
from corenet_tpu_torch.eval.tf_model import (  # noqa: E402
    TfFrozenGraphModel, super_resolution_from_tf_model)
from helpers import make_fixture_dataset  # noqa: E402
from test_tf_model import C, NATIVE, _build_frozen_graph  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
  path = str(tmp_path_factory.mktemp("tf_graph") / "model.pb")
  _build_frozen_graph(path)
  return path


def _inputs(seed=0, b=2, offsets=3):
  rng = np.random.RandomState(seed)
  return ((rng.rand(b, 24, 24, 3) * 255).astype(np.uint8),
          rng.randn(b, 4, 4).astype(np.float32),
          rng.randn(b, 4, 4).astype(np.float32),
          rng.rand(offsets, b, 3).astype(np.float32))


def test_the_frozen_graph_model_returns_jax_pmfs(graph):
  model = TfFrozenGraphModel(graph)
  ref = JaxTfFrozenGraphModel(graph)
  assert model.output_shape == ref.output_shape == NATIVE + (C,)
  inputs = _inputs()
  want = ref(*inputs)
  got = model(*inputs)
  assert got.dtype == np.float32 and got.shape == (3, 2) + NATIVE + (C,)
  tt.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
  from_tensors = model(*(torch.from_numpy(x) for x in inputs))
  tt.assert_allclose(from_tensors, want, rtol=1e-6, atol=1e-6)

  # Super-resolution over the graph: 32³ from the 16³ native grid, on the
  # eval pipeline's device.
  sri = super_resolution_from_tf_model(graph, device="cpu")
  assert sri.resolution == NATIVE
  image, camera, v2x, offsets = inputs
  pmf = sri(image, camera, v2x, offsets[0], (32, 32, 32))
  assert isinstance(pmf, torch.Tensor) and pmf.shape == (2, 32, 32, 32, C)
  tt.assert_allclose(pmf.sum(-1).numpy(), 1.0, rtol=1e-5)
  with pytest.raises(FileNotFoundError):
    TfFrozenGraphModel(graph + ".missing")


def _eval_config(tmp_path, graph, manifest, meshes_dir, out):
  data = {
      "datasets": [{"dataset_path": manifest, "meshes_dir": meshes_dir,
                    "high_realism": True, "shuffle": "NEVER"}],
      "shuffle": "NEVER",
      "data_loader": {"batch_size": 2, "num_data_workers": 1,
                      "worker_processes": False},
      "voxelization_config": {
          "task_type": "FG_BG",
          "resolution": {"depth": 32, "height": 32, "width": 32},
          "voxelization_image_resolution_multiplier": 2}}
  path = str(tmp_path / f"{os.path.basename(out)}.json")
  with open(path, "w") as f:
    json.dump({"string_templates": [], "frozen_graph_path": graph,
               "output_path": out,
               "eval_config": {"name": "full_eval", "data": data,
                               "num_qualitative_results": 0,
                               "num_qualitative_results_in_tensor_board":
                                   0}}, f)
  return path


def _csv(out):
  path = os.path.join(out, "full_eval", "-1", "voxel_metrics.csv")
  with open(path) as f:
    return [line.split(",") for line in f.read().splitlines()]


def test_the_tf_model_eval_cli_writes_the_jax_csv(graph, tmp_path,
                                                  monkeypatch):
  manifest, meshes_dir = make_fixture_dataset(str(tmp_path / "ds"),
                                              num_scenes=4, image_size=32)
  port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
  miou = tf_model_eval.main([
      "--config_path=" + _eval_config(tmp_path, graph, manifest, meshes_dir,
                                      port_out), "--device=cpu"])
  want = jax_tf_model_eval.main([
      "--config_path=" + _eval_config(tmp_path, graph, manifest, meshes_dir,
                                      jax_out),
      "--compilation_cache_dir=none"])
  assert np.isfinite(miou) and 0 < miou < 1
  assert abs(miou - want) <= 1e-3, (miou, want)
  got_rows, want_rows = _csv(port_out), _csv(jax_out)
  assert [r[0] for r in got_rows] == [r[0] for r in want_rows]
  assert got_rows[0] == want_rows[0]
  for got, ref in zip(got_rows[1:], want_rows[1:]):
    tt.assert_allclose(np.array(got[1:], float), np.array(ref[1:], float),
                       atol=1e-3)
  # The card unless the CPU is asked for.
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    tf_model_eval.main(["--config_path=x.json"])


def test_the_demo_reconstructs_from_a_frozen_graph(graph, tmp_path,
                                                   monkeypatch):
  """The demo's `.pb` branch: the tile is drawn from the graph's
  super-resolved PMF (the drawing is stubbed; tests/test_torch_cli_demo.py
  draws real tiles)."""
  manifest, meshes_dir = make_fixture_dataset(str(tmp_path / "ds"),
                                              num_scenes=1, image_size=32)
  scene = os.path.join(os.path.dirname(manifest),
                       json.load(open(manifest))["files"][0])
  drawn = []

  def visualize(image, pmf, grid, *args, **kwargs):
    drawn.append((image, pmf, grid))
    return np.zeros((8, 8, 3), np.uint8)

  monkeypatch.setattr(qualitative, "visualize_scene_output", visualize)
  tile = demo.main([f"--scene={scene}", f"--meshes_dir={meshes_dir}",
                    f"--checkpoint={graph}", "--resolution=32",
                    f"--output={tmp_path / 'recon.png'}", "--device=cpu"])
  assert tile.shape == (8, 8, 3) and (tmp_path / "recon.png").exists()
  image, pmf, grid = drawn[0]
  assert pmf.shape == (32, 32, 32, C) and grid.shape == (32, 32, 32)
  tt.assert_allclose(pmf.sum(-1), 1.0, rtol=1e-5)
  assert grid.max() >= 1
