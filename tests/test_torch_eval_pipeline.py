"""The port's EvalPipeline (corenet_tpu_torch/eval/pipeline.py) against the
JAX package's, end to end on the CPU: the fixture dataset of
tests/helpers.py (5 scenes at batch 2, so the last batch is padded), GT at
32³ with h7's eval voxelization, FG_BG and SEMANTIC.

With one fixed numpy inference function given to both pipelines, the GT
grids, the confusion matrices, the mean IoU and the CSV text are equal
exactly. With the tiny CoreNet of tests/test_torch_model.py (flax weights
bridged by models/convert.py) the GT is still equal bit for bit, while the
two frameworks' float32 logits differ in their last digits: a voxel whose
two largest probabilities tie within that flips its argmax, so the
confusion entries may differ by at most 0.1 % of the voxels and the mean
IoU by at most 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu import config as jax_config
from corenet_tpu.eval import pipeline as jax_pipeline
from corenet_tpu.train.step import make_eval_forward as jax_eval_forward
from corenet_tpu_torch import config
from corenet_tpu_torch.eval import pipeline
from corenet_tpu_torch.models.convert import state_dict_from_jax
from corenet_tpu_torch.models.corenet import (
    CoreNet, CoreNetConfig, DecoderConfig)
from corenet_tpu_torch.train.step import make_eval_forward
from corenet_tpu_torch.utils.png import decode_png
from helpers import make_fixture_dataset
from test_torch_model import _jax_model, _variables

torch.set_num_threads(2)

RES = (32, 32, 32)
SCENES = 5


@pytest.fixture(scope="module")
def fixture_ds(tmp_path_factory):
  root = tmp_path_factory.mktemp("eval_ds")
  return make_fixture_dataset(str(root), num_scenes=SCENES, num_classes=2)


def _eval_config(cfg, fixture_ds, task_type, qualitative=0):
  path, meshes = fixture_ds
  return cfg.config_from_dict(cfg.EvalConfig, {
      "name": "fixture_eval",
      "num_qualitative_results": qualitative,
      "data": {
          "datasets": [{"dataset_path": path, "meshes_dir": meshes,
                        "shuffle": "ONCE"}],
          "shuffle": "PER_EPOCH",
          "data_loader": {"num_data_workers": 2, "batch_size": 2,
                          "prefetch_factor": 2, "worker_processes": False},
          "voxelization_config": {
              "task_type": task_type,
              "resolution": dict(zip(("depth", "height", "width"), RES)),
              "conservative_rasterization": False,
              "voxelization_image_resolution_multiplier": 8}}})


class _Recorder:
  """Keeps the GT grids a pipeline voxelizes and its QuantitativeResults."""

  def __init__(self, module, pipe, monkeypatch):
    self.grids, self.results = [], None
    gt_fn = pipe._cached_gt_fn

    def keeping_gt(*args):
      grid, v2x = gt_fn(*args)
      self.grids.append(np.asarray(grid))
      return grid, v2x

    pipe._cached_gt_fn = keeping_gt
    results_cls = module.QuantitativeResults
    recorder = self

    class Recording(results_cls):
      def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        recorder.results = self

    monkeypatch.setattr(module, "QuantitativeResults", Recording)


def _run_both(fixture_ds, tmp_path, monkeypatch, task_type, jax_infer,
              port_infer, step=3):
  """run_eval of both pipelines → ((mean IoU, recorder, CSV text), ...)."""
  out = []
  for module, cfg, infer, kwargs in (
      (jax_pipeline, jax_config, jax_infer, {}),
      (pipeline, config, port_infer, {"device": "cpu"})):
    root = tmp_path / module.__name__
    pipe = module.EvalPipeline(
        _eval_config(cfg, fixture_ds, task_type), str(root), infer,
        write_qualitative=False, **kwargs)
    recorder = _Recorder(module, pipe, monkeypatch)
    mean_iou = pipe.run_eval(step)
    text = (root / "fixture_eval" / str(step) / "voxel_metrics.csv"
            ).read_text()
    out.append((mean_iou, recorder, text))
  return out


def _fixed_inference(channels):
  """A numpy inference function: a seeded PMF per batch with a block of
  class 1, whatever the framework of its inputs."""
  def infer(image, camera, v2x, grid_offsets, resolution):
    image = np.asarray(image)
    rng = np.random.default_rng(int(image.astype(np.int64).sum() % 1000))
    pmf = rng.random((image.shape[0],) + tuple(resolution) + (channels,))
    pmf[:, 8:24, 8:24, 8:24, 1] += 0.5
    return pmf.astype(np.float32)
  return infer


@pytest.mark.parametrize("task_type", ["FG_BG", "SEMANTIC"])
def test_eval_pipeline_matches_jax_with_a_fixed_inference_function(
    fixture_ds, tmp_path, monkeypatch, task_type):
  infer = _fixed_inference(2 if task_type == "FG_BG" else 3)
  (jax_iou, jax_rec, jax_text), (iou, rec, text) = _run_both(
      fixture_ds, tmp_path, monkeypatch, task_type,
      lambda *args: jnp.asarray(infer(*args)), infer)
  assert len(rec.grids) == len(jax_rec.grids) == 3
  for got, want in zip(rec.grids, jax_rec.grids):
    assert got.dtype == want.dtype == np.uint8
    tt.assert_array_equal(got, want)
  tt.assert_array_equal(rec.results.confusion, jax_rec.results.confusion)
  # 5 scenes at batch 2: the padded sixth scene is not counted.
  assert rec.results.confusion.sum() == SCENES * 32 ** 3
  assert iou == jax_iou and 0 < iou < 1
  assert text == jax_text
  if task_type == "SEMANTIC":  # two-cube scenes hold both classes
    assert {0, 1, 2} == set(np.unique(np.concatenate(rec.grids)))


@pytest.mark.parametrize("task_type", ["FG_BG"])
def test_eval_pipeline_matches_jax_with_the_bridged_model(
    fixture_ds, tmp_path, monkeypatch, task_type):
  variables = _variables(RES[0])
  forward = jax_eval_forward(_jax_model(RES[0]), RES)
  jax_vars = jax.tree_util.tree_map(jnp.asarray, variables)

  def jax_infer(image, camera, v2x, grid_offsets, resolution):
    assert tuple(resolution) == RES
    return forward(jax_vars, image, camera, v2x, grid_offsets)

  model = CoreNet(CoreNetConfig(DecoderConfig(RES, 2)))
  model.load_state_dict(state_dict_from_jax(variables))
  port_forward = make_eval_forward(model.eval())

  def port_infer(image, camera, v2x, grid_offsets, resolution):
    assert tuple(resolution) == RES and image.dtype == torch.uint8
    return port_forward(image, camera, v2x, grid_offsets)

  (jax_iou, jax_rec, _), (iou, rec, text) = _run_both(
      fixture_ds, tmp_path, monkeypatch, task_type, jax_infer, port_infer,
      step=0)
  for got, want in zip(rec.grids, jax_rec.grids):
    tt.assert_array_equal(got, want)
  voxels = SCENES * 32 ** 3
  assert rec.results.confusion.sum() == jax_rec.results.confusion.sum() == (
      voxels)
  moved = np.abs(rec.results.confusion - jax_rec.results.confusion).max()
  assert moved <= 1e-3 * voxels, moved
  assert abs(iou - jax_iou) <= 1e-3, (iou, jax_iou)
  assert text.count("\n") == 4


def test_eval_pipeline_options(fixture_ds, tmp_path, monkeypatch):
  """max_scenes, the summary writer, no CSV without write_results;
  qualitative results write their tiles; the default device without a card
  raises."""
  infer = _fixed_inference(2)

  class Writer:
    def __init__(self):
      self.scalars, self.images, self.flushed = {}, {}, False

    def add_scalar(self, name, value, step):
      self.scalars[name] = (value, step)

    def add_image(self, name, image, step):
      self.images[name] = (image.shape, step)

    def flush(self):
      self.flushed = True

  writer = Writer()
  pipe = pipeline.EvalPipeline(
      _eval_config(config, fixture_ds, "FG_BG"), str(tmp_path), infer,
      write_results=False, write_qualitative=False, summary_writer=writer,
      device="cpu")
  recorder = _Recorder(pipeline, pipe, monkeypatch)
  mean_iou = pipe.run_eval(7, max_scenes=3)
  assert recorder.results.confusion.sum() == 3 * 32 ** 3
  assert writer.flushed and writer.scalars["General/mIoU"] == (mean_iou, 7)
  assert "IoU/__void__" in writer.scalars
  assert not (tmp_path / "fixture_eval").exists() and not writer.images

  # A config that asks for qualitative results (as every shipped one
  # does) gets its tiles beside the CSV, the first in the summaries; at
  # 64² per view here (the pipeline draws 256²), to keep the CPU's
  # rasterizer quick.
  monkeypatch.setattr(pipeline, "QualitativeResults", functools.partial(
      pipeline.QualitativeResults, image_size=(64, 64)))
  writer = Writer()
  asks = pipeline.EvalPipeline(
      _eval_config(config, fixture_ds, "FG_BG", qualitative=1),
      str(tmp_path), infer, summary_writer=writer, device="cpu")
  asks.run_eval(0, max_scenes=2)
  out = tmp_path / "fixture_eval" / "0"
  tiles = sorted(p.name for p in out.glob("img_*.png"))
  assert len(tiles) == 1 and (out / "voxel_metrics.csv").exists()
  assert decode_png((out / tiles[0]).read_bytes()).shape == (320, 320, 3)
  assert writer.images == {"rec_0": ((320, 320, 3), 0)}
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    pipeline.EvalPipeline(_eval_config(config, fixture_ds, "FG_BG"),
                          str(tmp_path), infer)
