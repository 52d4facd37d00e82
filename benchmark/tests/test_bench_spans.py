"""The readers of the program's spans (benchmark/harness/spans.py and the
metrics that use it) on a canned trace with canned spans: spans outside
the trace's extent, still open or on another thread are left out where
they must be, and a run with nothing to read gives None."""

import sys
import threading
from types import SimpleNamespace

import pytest

from benchmark.harness import spans as spans_lib
from benchmark.harness import spec as spec_lib
from benchmark.harness.trace import Trace
from benchmark.tests.bench_fixtures import REPO
import corenet_tpu_torch.utils
from corenet_tpu_torch.utils import tracing

MS = 1_000_000
MAIN = threading.main_thread().ident
OTHER = MAIN + 1

TRAIN_METRICS = ("loader_wait_ms.train", "collate_ms.train", "gt_ms.train",
                 "fill_rounds.train", "dispatch_ms.train", "launches.train",
                 "idle_unspanned.train")
SERVE_METRICS = ("dispatch_ms.serve", "launches.serve",
                 "idle_unspanned.serve")


class _Run:

  def __init__(self, trace, window):
    self.trace, self.counts, self.window = trace, {}, window


def _span(name, start, end, parent=None, thread=MAIN, counts=None, id=None):
  return SimpleNamespace(name=name, id=id, parent=parent, thread=thread,
                         start=None if start is None else start * MS,
                         end=None if end is None else end * MS,
                         counts=counts)


def _step(id, start, end, parts, syncs):
  """A train.step span and its children: `parts` (name, start, end) in
  order; `syncs` (start, end) fill.sync spans under train.gt."""
  root = _span("train.step", start, end, id=id)
  out = [root]
  for name, s, e in parts:
    child = _span(name, s, e, parent=root, id=id)
    out.append(child)
    if name == "train.gt":
      out += [_span("fill.sync", a, b, parent=child, id=id,
                    counts={"fill.rounds": 1}) for a, b in syncs]
  return out


def _trace():
  """Device busy [10, 14], [20, 22], [30, 40] ms; the host's calls from
  5 to 45 ms, so the extent is [5, 45] ms."""
  device = [("k1", 10 * MS, 14 * MS), ("k2", 20 * MS, 22 * MS),
            ("k3", 30 * MS, 40 * MS)]
  host = [("cudaLaunchKernel", 5 * MS, 5 * MS + 100),
          ("cudaLaunchKernel", 12 * MS, 12 * MS + 100),
          ("cudaMemcpyAsync", 18 * MS, 18 * MS + 500),
          ("cudaLaunchKernel", 25 * MS, 25 * MS + 100),
          ("cudaLaunchKernel", 26 * MS + MS // 2, 26 * MS + MS // 2 + 100),
          ("cudaStreamSynchronize", 41 * MS, 45 * MS),
          ("cudaLaunchKernel", 44 * MS, 44 * MS + 100)]
  return Trace(device, host, 0.04)


def _train_spans():
  before = _step(0, 0, 4, [("train.loader_wait", 0, 1)], [(2, 3)])
  first = _step(4, 4, 26, [
      ("train.loader_wait", 4, 8), ("train.to_device", 8, 9),
      ("train.gt", 9, 16), ("train.forward", 16, 19), ("train.loss", 19, 20),
      ("train.backward", 20, 24), ("train.optimizer", 24, 25)],
      [(11, 12), (13, 14)])
  second = _step(8, 27, 50, [
      ("train.loader_wait", 27, 28), ("train.to_device", 28, 29),
      ("train.gt", 29, 33), ("train.forward", 33, 38), ("train.loss", 38, 39),
      ("train.backward", 39, 44), ("train.optimizer", 44, 49)], [(30, 31)])
  collates = [_span("loader.collate", s, e, thread=OTHER)
              for s, e in ((1, 2), (6, 9), (26, 29), (46, 48))]
  still_open = [_span("train.step", 46, None, id=12)]
  return before + first + second + collates + still_open


@pytest.fixture
def canned(monkeypatch):
  recorded = []
  monkeypatch.setattr(tracing, "spans", lambda: list(recorded))
  return recorded


def _read(name, run):
  return spec_lib.Spec(REPO).module("metrics", name).read(run)


def test_training_readers_on_canned_spans(canned):
  canned += _train_spans()
  run = _Run(_trace(), {"units": 2, "window_s": 0.04})
  assert _read("loader_wait_ms.train", run) == pytest.approx((3 + 1) / 2)
  assert _read("collate_ms.train", run) == pytest.approx((3 + 3) / 2)
  assert _read("gt_ms.train", run) == pytest.approx((7 + 4) / 2)
  assert _read("fill_rounds.train", run) == pytest.approx(3 / 2)
  # forward 3 + 5, loss 1 + 1, backward 4 + 5, optimizer 1 + 1 (cut at 45)
  assert _read("dispatch_ms.train", run) == pytest.approx(21 / 2)
  # 5 of the 6 launch and copy calls lie inside the main thread's spans;
  # the one at 26.5 ms lies in a collate on another thread only.
  assert _read("launches.train", run) == pytest.approx(5 / 2)
  # idle 5 + 6 + 8 + 5 ms, of which [26, 27] has no main-thread span open
  assert _read("idle_unspanned.train", run) == pytest.approx(100 / 24)


def test_the_breakdown_names_each_idle_piece_and_launch(canned):
  canned += _train_spans()
  run = _Run(_trace(), {"units": 2, "window_s": 0.04})
  got = spans_lib.breakdown(run)
  assert got["idle_ms_by_span"] == pytest.approx({
      "train.loader_wait": 2.0, "train.to_device": 1.0, "train.gt": 2.0,
      "train.forward": 1.5, "train.loss": 0.5, "train.backward": 3.0,
      "train.optimizer": 1.0, "train.step": 0.5, "none": 0.5})
  assert sum(got["idle_share_by_span"].values()) == pytest.approx(100.0)
  assert got["launches_by_span"] == pytest.approx({
      "train.loader_wait": 0.5, "train.gt": 0.5, "train.forward": 0.5,
      "train.step": 0.5, "train.optimizer": 0.5, "none": 0.5})
  assert (got["launches_in_roots"], got["launches"]) == (5, 6)
  assert got["counts"] == pytest.approx({"fill.rounds": 1.5})
  assert got["span_ms"]["train.step"] == pytest.approx((21 + 18) / 2)


def test_serving_readers_on_canned_spans(canned):
  for id, (s, e) in enumerate(((3, 19), (21, 46)), start=1):
    root = _span("serve.request", s, e, id=id)
    canned += [root, _span("serve.decode", s + 1, e - 1, parent=root,
                           id=id)]
  run = _Run(_trace(), {"units": 2, "window_s": 0.04})
  # [5, 19] and [21, 45], each request cut to the extent
  assert _read("dispatch_ms.serve", run) == pytest.approx((14 + 24) / 2)
  assert _read("launches.serve", run) == pytest.approx(6 / 2)
  # of the idle time, [19, 20] alone lies outside every request
  assert _read("idle_unspanned.serve", run) == pytest.approx(100 / 24)
  for name in TRAIN_METRICS[:4]:
    assert _read(name, run) in (None, 0.0)


@pytest.mark.parametrize("name", TRAIN_METRICS + SERVE_METRICS)
def test_nothing_to_read_gives_none(canned, monkeypatch, name):
  window = {"units": 2, "window_s": 0.04}
  # No trace, an empty trace, and spans that all lie outside the extent.
  assert _read(name, _Run(None, window)) is None
  assert _read(name, _Run(Trace([], [], 0.04), window)) is None
  canned += [_span("train.step", 50, 60), _span("serve.request", 0, 4),
             _span("loader.collate", 46, 48, thread=OTHER)]
  assert _read(name, _Run(_trace(), window)) is None
  # A program without the registry (a checkout older than its spans):
  # the import fails, and the reader finds nothing.
  canned += _train_spans()
  monkeypatch.delattr(corenet_tpu_torch.utils, "tracing")
  monkeypatch.setitem(sys.modules, "corenet_tpu_torch.utils.tracing", None)
  assert _read(name, _Run(_trace(), window)) is None
