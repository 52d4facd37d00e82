"""The serving product's CUDA graphs (corenet_tpu_torch/eval/
super_resolution.py: `GraphPlan`, `GraphedCall`) on the CPU: which way
each call goes, the copies around a replay and the counters, with a
stand-in for the graph; a CPU product never captures. The graphs
themselves are held to the eager PMF on the card (tests/test_torch_cuda.py).
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from corenet_tpu_torch.eval import super_resolution as sr
from corenet_tpu_torch.models.corenet import (
    CoreNet, CoreNetConfig, DecoderConfig)
from corenet_tpu_torch.utils import tracing

torch.set_num_threads(2)

A, B = ("a",), ("b",)
GRAPH_COUNTERS = ("serve.graph.eager", "serve.graph.captures",
                  "serve.graph.replays")


def _ways(plan, calls):
  return [plan.way(key, profiling) for key, profiling in calls]


def test_a_signature_runs_eagerly_then_captures_then_replays():
  plan = sr.GraphPlan()
  ways = []
  for _ in range(4):
    way = plan.way(A, False)
    if way == sr.CAPTURE:
      plan.graphs[A] = object()
    ways.append(way)
  assert ways == [sr.EAGER, sr.CAPTURE, sr.REPLAY, sr.REPLAY]


def test_a_new_signature_starts_over():
  plan = sr.GraphPlan()
  assert _ways(plan, [(A, False), (A, False)]) == [sr.EAGER, sr.CAPTURE]
  plan.graphs[A] = object()
  assert _ways(plan, [(B, False), (A, False), (B, False)]) == [
      sr.EAGER, sr.REPLAY, sr.CAPTURE]


def test_signatures_beyond_the_cap_run_eagerly():
  plan = sr.GraphPlan()
  assert plan.limit == sr.MAX_GRAPHS == 4
  for k in range(4):
    assert _ways(plan, [(k, False), (k, False)]) == [sr.EAGER, sr.CAPTURE]
    plan.graphs[k] = object()
  assert _ways(plan, [(4, False), (4, False), (4, False)]) == [sr.EAGER] * 3
  assert _ways(plan, [(k, False) for k in range(4)]) == [sr.REPLAY] * 4


def test_a_capture_waits_while_a_profiler_runs():
  plan = sr.GraphPlan()
  assert _ways(plan, [(A, True), (A, True), (A, True)]) == [sr.EAGER] * 3
  assert plan.way(A, False) == sr.CAPTURE
  plan.graphs[A] = object()
  assert plan.way(A, True) == sr.REPLAY


def test_the_signature_is_each_inputs_shape_dtype_and_device():
  x = torch.zeros(2, 3)
  assert sr.signature((x, x)) == sr.signature((torch.ones(2, 3), x))
  for other in (torch.zeros(3, 2), torch.zeros(2, 3, dtype=torch.float64)):
    assert sr.signature((other, x)) != sr.signature((x, x))


class _StandInGraph:
  """Replays `fn` from the static inputs into the static output, as a
  captured graph would."""

  def __init__(self, fn, inputs, output):
    self.fn, self.inputs, self.output = fn, inputs, output
    self.replays = 0

  def replay(self):
    self.output.copy_(self.fn(*self.inputs))
    self.replays += 1


@pytest.fixture
def stand_in(monkeypatch):
  """GraphedCall on the CPU, its capture replaced by `_StandInGraph`."""
  monkeypatch.setattr(torch.cuda, "device", lambda device: (
      contextlib.nullcontext()))

  def capture(self, inputs):
    static = tuple(x.clone() for x in inputs)
    output = self.fn(*static)
    return sr._Captured(_StandInGraph(self.fn, static, output), static,
                        output)

  monkeypatch.setattr(sr.GraphedCall, "_capture", capture)


def _counts():
  totals = tracing.counters()
  return tuple(totals[n] for n in GRAPH_COUNTERS)


def _passes(image, camera, v2x, offsets):
  """A stand-in for the model: one 'PMF' [m³, B, 2, 2, 2, 1] per pass
  from the inputs."""
  value = (image.float().mean((1, 2, 3))[None] + camera[None, :, 0, 0]
           + v2x[None, :, 0, 0] + offsets.sum(-1))
  return value[..., None, None, None, None].expand(
      value.shape + (2, 2, 2, 1)).contiguous()


def _request(seed, batch=2):
  rng = np.random.default_rng(seed)
  image = torch.from_numpy(rng.integers(0, 256, (batch, 8, 8, 3),
                                        dtype=np.uint8))
  camera = torch.from_numpy(rng.standard_normal((batch, 4, 4)).astype(
      np.float32))
  v2x = torch.diag(torch.tensor([2.0, 2.0, 2.0, 1.0])).repeat(batch, 1, 1)
  return image, camera, v2x, torch.full((batch, 3), 0.5)


@pytest.mark.parametrize("output", [2, 4])
def test_replays_copy_inputs_in_and_never_hand_out_the_static_output(
    stand_in, output):
  graphed = sr.GraphedCall(_passes, torch.device("cpu"))
  infer = sr.SuperResolutionInference(graphed, (2, 2, 2), "cpu")
  eager = sr.SuperResolutionInference(_passes, (2, 2, 2), "cpu")
  before = _counts()
  pmfs = [infer(*_request(seed), (output,) * 3) for seed in range(4)]
  assert tuple(a - b for a, b in zip(_counts(), before)) == (1, 1, 2)
  captured, = graphed.plan.graphs.values()
  assert captured.graph.replays == 3
  for seed, pmf in enumerate(pmfs):
    assert torch.equal(pmf, eager(*_request(seed), (output,) * 3))
    assert pmf.untyped_storage().data_ptr() != (
        captured.output.untyped_storage().data_ptr())
  assert not torch.equal(pmfs[2], pmfs[3])


def test_a_replay_is_a_span_in_the_request_which_counts_it(stand_in):
  infer = sr.SuperResolutionInference(
      sr.GraphedCall(_passes, torch.device("cpu")), (2, 2, 2), "cpu")
  infer(*_request(0), (2,) * 3)
  infer(*_request(1), (2,) * 3)
  tracing.clear()
  with profile(activities=[ProfilerActivity.CPU]):
    infer(*_request(2), (2,) * 3)
  request, to_device, replay, assemble = tracing.spans()
  assert [s.name for s in (request, to_device, replay, assemble)] == [
      "serve.request", "serve.to_device", "serve.replay", "serve.assemble"]
  assert all(s.parent is request for s in (to_device, replay, assemble))
  assert request.counts == {"serve.graph.replays": 1}
  assert replay.counts is None


def test_a_deferred_capture_is_counted_eager_in_the_request(stand_in):
  graphed = sr.GraphedCall(_passes, torch.device("cpu"))
  infer = sr.SuperResolutionInference(graphed, (2, 2, 2), "cpu")
  tracing.clear()
  with profile(activities=[ProfilerActivity.CPU]):
    infer(*_request(0), (2,) * 3)
    infer(*_request(1), (2,) * 3)
  requests = [s for s in tracing.spans() if s.name == "serve.request"]
  assert [s.counts for s in requests] == [{"serve.graph.eager": 1}] * 2
  assert not graphed.plan.graphs
  before = _counts()
  infer(*_request(2), (2,) * 3)
  assert tuple(a - b for a, b in zip(_counts(), before)) == (0, 1, 0)
  assert len(graphed.plan.graphs) == 1


def test_a_cpu_product_never_captures():
  model = CoreNet(CoreNetConfig(DecoderConfig((32,) * 3, 2)))
  model.reset_parameters(torch.Generator().manual_seed(0))
  infer = sr.super_resolution_from_model(model, model.state_dict(),
                                         (32,) * 3, device="cpu")
  assert not isinstance(infer.inference_fn, sr.GraphedCall)
  image = torch.from_numpy(np.random.default_rng(0).integers(
      0, 256, (1, 64, 64, 3), dtype=np.uint8))
  camera = torch.eye(4)[None]
  camera[0, 2, 3] = 2.0
  v2x = torch.diag(torch.tensor([32.0, 32, 32, 1]))[None]
  offsets = torch.full((1, 3), 0.5)
  before = _counts()
  pmfs = [infer(image, camera, v2x, offsets, (32,) * 3) for _ in range(3)]
  assert _counts() == before
  assert torch.equal(pmfs[0], pmfs[2])
