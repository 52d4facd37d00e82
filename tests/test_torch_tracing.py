"""The port's spans and counters (corenet_tpu_torch/utils/tracing.py) on the
CPU: off outside a profiler, recorded under one, on the profiler's clock,
and where the training pipeline and the serving entry put them."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from corenet_tpu_torch import config as cfg
from corenet_tpu_torch.eval.super_resolution import (
    super_resolution_from_model)
from corenet_tpu_torch.models.corenet import (
    CoreNet, CoreNetConfig, DecoderConfig)
from corenet_tpu_torch.train import pipeline
from corenet_tpu_torch.train.state import create_train_state
from corenet_tpu_torch.train.step import make_train_step
from corenet_tpu_torch.utils import tracing
from helpers import make_fixture_dataset
from test_torch_train_pipeline import full_config_dict

torch.set_num_threads(2)

TRAIN_CHILDREN = ["train.loader_wait", "train.to_device", "train.gt",
                  "train.forward", "train.loss", "train.backward",
                  "train.optimizer"]
SERVE_CHILDREN = ["serve.to_device", "serve.encode", "serve.decode",
                  "serve.assemble"]


def _children(parent, recorded):
  return [s for s in recorded if s.parent is parent]


def test_off_is_one_shared_no_op_that_records_nothing():
  tracing.clear()
  first, second = tracing.span("a"), tracing.span("b", id=3)
  assert first is second
  with first as got:
    assert got is None
    tracing.count("tracing_test.off")
  assert tracing.spans() == []


def test_on_records_name_id_parent_thread_and_counts():
  tracing.clear()
  with profile(activities=[ProfilerActivity.CPU]):
    with tracing.span("outer", id=7):
      tracing.count("tracing_test.outer")
      with tracing.span("inner"):
        tracing.count("tracing_test.inner", 2)
        tracing.count("tracing_test.inner")
      with tracing.span("other", id=8):
        pass
    done = threading.Event()

    def elsewhere():
      with tracing.span("on_a_thread"):
        pass
      done.set()

    worker = threading.Thread(target=elsewhere)
    worker.start()
    worker.join(timeout=30)
    assert done.is_set()
  outer, inner, other, threaded = tracing.spans()
  assert [s.name for s in (outer, inner, other, threaded)] == [
      "outer", "inner", "other", "on_a_thread"]
  assert (outer.id, inner.id, other.id) == (7, 7, 8)
  assert outer.parent is None and threaded.parent is None
  assert inner.parent is outer and other.parent is outer
  main = threading.get_ident()
  assert outer.thread == inner.thread == main != threaded.thread
  assert outer.counts == {"tracing_test.outer": 1}
  assert inner.counts == {"tracing_test.inner": 3}
  assert other.counts is None
  for s in (outer, inner, other, threaded):
    assert s.start <= s.end
  assert outer.start <= inner.start <= inner.end <= other.start
  assert other.end <= outer.end
  tracing.clear()
  assert tracing.spans() == []


def test_a_span_shares_the_profilers_clock():
  tracing.clear()
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    with tracing.span("tracing_test.clock"):
      time.sleep(0.01)
  span, = tracing.spans()
  ranges = [ev for ev in prof.profiler.kineto_results.events()
            if ev.name() == "tracing_test.clock"]
  assert len(ranges) == 1
  start = ranges[0].start_ns()
  end = start + ranges[0].duration_ns()
  assert abs(span.start - start) < 1_000_000
  assert abs(span.end - end) < 1_000_000


def test_counters_count_with_tracing_off():
  before = tracing.counters().get("tracing_test.counter", 0)
  tracing.count("tracing_test.counter")
  tracing.count("tracing_test.counter", 4)
  assert tracing.counters()["tracing_test.counter"] == before + 5


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
  root = str(tmp_path_factory.mktemp("tracing_data"))
  return (root,) + make_fixture_dataset(root)


def test_two_training_steps_record_the_step_and_its_parts(dataset):
  root, manifest, meshes_dir = dataset
  config = full_config_dict(root, manifest, meshes_dir)
  # The adaptive fill, whose rounds each read a flag (fill.sync).
  config["train"]["data"]["voxelization_config"][
      "voxelization_fill_rounds"] = 0
  full = cfg.config_from_dict(cfg.TrainPipeline, config)
  pipe = pipeline.TrainPipeline(full.train, full.output_path, device="cpu")
  pipe.model.reset_parameters(torch.Generator().manual_seed(0))
  pipe.state = create_train_state(pipe.model, device="cpu")
  pipe.train_step = make_train_step(
      pipe.model, pipe.state.optimizer, pipe.task_type, pipe.resolution,
      voxelization_kwargs=dict(pipe.voxelization_kwargs,
                               algorithm=pipe.gt_algorithm))
  steps = pipe.train_steps()
  tracing.clear()
  try:
    with profile(activities=[ProfilerActivity.CPU]):
      first, _ = next(steps)
      next(steps)
  finally:
    steps.close()
  recorded = tracing.spans()
  main = threading.get_ident()
  roots = [s for s in recorded if s.name == "train.step"]
  assert [s.id for s in roots] == [0, first]
  for root_span in roots:
    assert root_span.thread == main and root_span.parent is None
    children = _children(root_span, recorded)
    assert [s.name for s in children] == TRAIN_CHILDREN
    assert all(s.id == root_span.id and s.thread == main for s in children)
    starts = [s.start for s in children]
    assert starts == sorted(starts)
    gt_span = children[TRAIN_CHILDREN.index("train.gt")]
    syncs = _children(gt_span, recorded)
    assert syncs and {s.name for s in syncs} == {"fill.sync"}
    assert all(s.counts == {"fill.rounds": 1} for s in syncs)
  collates = [s for s in recorded if s.name == "loader.collate"]
  assert collates and all(s.thread != main and s.parent is None
                          for s in collates)


def test_one_request_records_the_request_and_its_parts():
  model = CoreNet(CoreNetConfig(DecoderConfig((32,) * 3, 2)))
  model.reset_parameters(torch.Generator().manual_seed(0))
  infer = super_resolution_from_model(model, model.state_dict(), (32,) * 3,
                                      device="cpu")
  rng = np.random.default_rng(0)
  image = rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
  camera = np.eye(4, dtype=np.float32)[None]
  camera[0, 2, 3] = 2.0
  v2x = np.diag(np.float32([32, 32, 32, 1]))[None]
  offsets = np.full((1, 3), 0.5, np.float32)
  tracing.clear()
  with profile(activities=[ProfilerActivity.CPU]):
    infer(image, camera, v2x, offsets, (32,) * 3)
    infer(image, camera, v2x, offsets, (32,) * 3)
  recorded = tracing.spans()
  roots = [s for s in recorded if s.name == "serve.request"]
  assert [s.id for s in roots] == [1, 2]
  for root_span in roots:
    children = _children(root_span, recorded)
    assert [s.name for s in children] == SERVE_CHILDREN
    assert all(s.id == root_span.id for s in children)
  assert len(recorded) == 2 * (1 + len(SERVE_CHILDREN))
