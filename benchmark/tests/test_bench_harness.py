"""The harness is data: every cell, configuration, traffic mix, driver and
metric of BENCHMARK.json is a file found by name, a new one is added as
files and entries alone, the metric readers read a canned trace, and a
run's last line has the contract's shape."""

import hashlib
import json
import os
import re

import pytest

from benchmark.harness import spec as spec_lib
from benchmark.harness.trace import Trace
from benchmark.tests.bench_fixtures import (  # noqa: F401
    REPO, copy_benchmark, run_cell, shrink, tiny_root)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LAST_LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _bench():
  with open(os.path.join(REPO, "BENCHMARK.json")) as f:
    return json.load(f)


def test_every_name_finds_its_files():
  spec = spec_lib.Spec(REPO)
  bench = spec.bench
  for w in bench["workloads"]:
    cell = spec.workload(w["name"])
    assert spec.config(cell["config"])["name"] == cell["config"]
    assert spec.traffic(cell["traffic"])
    driver = spec.module("drivers", cell["driver"])
    for fn in ("setup", "window", "counts", "check", "control"):
      assert callable(getattr(driver, fn))
    assert set(cell["limits"]) <= {"pmf_gap", "loss_gap", "grad_gap",
                                   "change_gap"}
  for m in bench["per_layer"]:
    assert callable(spec.module("metrics", m["name"]).read)


def test_benchmark_json_keeps_the_contracts_shapes():
  bench = _bench()
  assert set(bench) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
  names = [c["name"] for c in bench["configs"]]
  names += [w["name"] for w in bench["workloads"]]
  names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
  assert len(names) == len(set(names))
  for n in names:
    assert NAME.match(n), n
  e2e = {m["name"]: m for m in bench["end_to_end"]}
  assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
  cells = {w["name"]: w for w in bench["workloads"]}
  for c in bench["configs"]:
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("benchmark/")
  for w in cells.values():
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
  for m in bench["end_to_end"]:
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    assert m["source"] in ("host_clock", "device_trace")
  reported = {w: {m["name"] for m in bench["end_to_end"]
                  if w in m.get("workloads", [w])} for w in cells}
  for w, ms in reported.items():
    assert "setup_s" in ms and len(ms) >= 2, w
  for m in bench["per_layer"]:
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert UNIT.match(m["unit"]) and m["moves"] in e2e
    for w in m["workloads"]:
      assert m["moves"] in reported[w], (m["name"], w)
  for w in cells:
    assert any(w in m["workloads"] for m in bench["per_layer"]), w


class _Run:

  def __init__(self, trace, counts, window):
    self.trace, self.counts, self.window = trace, counts, window


def test_metric_readers_on_a_canned_trace():
  spec = spec_lib.Spec(REPO)
  ms = 1_000_000
  device = [
      ("sm90_xmma_fprop_implicit_gemm_bf16", 0, 4 * ms),
      ("void cudnn::wgrad_kernel", 3 * ms, 5 * ms),  # overlaps the first
      ("void gather_rows<float4>(float4 const*)", 6 * ms, 7 * ms),
      ("void blocked_raster_kernel(float const*)", 8 * ms, 10 * ms),
  ]
  trace = Trace(device, [("cudaStreamSynchronize", 5 * ms, 6 * ms)], 0.02)
  window = {"window_s": 0.02, "steps": 2, "requests": 2, "units": 2}
  counts = {"model_flops": 2e9, "peak_flops": 1e12,
            "raster_bound_s": 0.0005, "gather_bound_s": 0.00075}
  run = _Run(trace, counts, window)

  def read(name):
    return spec.module("metrics", name).read(run)

  assert trace.busy_s() == pytest.approx(0.008)
  assert read("idle_share.train") == pytest.approx(60.0)
  assert read("idle_share.serve") == pytest.approx(60.0)
  # A metric named <reader>.<anything> is read by metrics/<reader>.py.
  assert read("idle_share.a_later_cell") == pytest.approx(60.0)
  assert read("mfu.train") == pytest.approx(10.0)
  assert read("conv_ms.train") == pytest.approx(3.0)  # (4 + 2) ms / 2
  assert read("conv_ms.serve") == pytest.approx(3.0)
  assert read("blocked_raster_or_roofline") == pytest.approx(25.0)
  assert read("skip_gather_roofline") == pytest.approx(75.0)
  assert trace.idle_gaps()[0][0] in ("cudaStreamSynchronize",
                                     "no host operation")
  # Nothing to read: the metric is left out, never 0.
  empty = _Run(Trace([], [], 0.02), {}, window)
  for m in spec.bench["per_layer"]:
    if m["source"] == "device_trace":
      assert spec.module("metrics", m["name"]).read(empty) is None


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_the_contracts_keys(tiny_root, capsys, trace):
  code, line, err = run_cell(tiny_root, [
      "--workload", "h7.serve", "--seed", str(2 ** 31 + 7), "--seconds",
      "1", "--trace", str(trace)], capsys)
  assert code == 0 and line["correct"] is True
  keys = list(line)
  assert keys[-1] == "checks"
  assert set(keys[:-1]) == LAST_LINE_KEYS | ({"breakdown"} if trace else
                                             set())
  assert set(line["device"]) >= {"platform", "kind", "count",
                                 "memory_peak_bytes"}
  if trace:
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
  else:
    assert set(line["metrics"]) == {"serve_scenes_per_s", "setup_s"}
  assert "pmf_gap" in line["checks"]
  assert err.strip().splitlines()[-1].startswith("check pmf_gap ")


def _digest(root):
  out = {}
  for folder, _, files in os.walk(root):
    for f in files:
      path = os.path.join(folder, f)
      if "__pycache__" not in path:
        out[os.path.relpath(path, root)] = hashlib.sha256(
            open(path, "rb").read()).hexdigest()
  return out


def test_a_cell_and_a_metric_added_as_files_alone(tmp_path, capsys,
                                                  monkeypatch):
  root = copy_benchmark(str(tmp_path / "checkout"))
  shrink(root)
  monkeypatch.setenv("TMPDIR", str(tmp_path))
  before = _digest(os.path.join(root, "benchmark"))
  b = os.path.join(root, "benchmark")
  with open(os.path.join(b, "traffic", "serve_slow_b2.json"), "w") as f:
    json.dump({"batch": 2, "image_hw": 64, "image_pool": 2, "views": 4,
               "rate_per_s": 4, "drain": True, "warmup_requests": 1,
               "sample": 1, "sample_from": 2}, f)
  with open(os.path.join(b, "workloads", "y1.serve.slow.json"), "w") as f:
    json.dump({"config": "y1", "traffic": "serve_slow_b2",
               "driver": "serve", "limits": {"pmf_gap": 1e-3}}, f)
  with open(os.path.join(b, "metrics", "requests_per_s.slow.py"), "w") as f:
    f.write("def read(run):\n"
            "  return run.window['requests'] / run.window['window_s']\n")
  with open(os.path.join(root, "BENCHMARK.json")) as f:
    bench = json.load(f)
  bench["workloads"].append({"name": "y1.serve.slow", "config": "y1",
                             "traffic": "serve_slow_b2", "chips": 1,
                             "why": "a throwaway cell of the test"})
  for m in bench["end_to_end"]:
    if m["name"] == "serve_scenes_per_s":
      m["workloads"].append("y1.serve.slow")
  bench["per_layer"].append({
      "name": "requests_per_s.slow", "unit": "1/s", "better": "higher",
      "source": "host_clock", "layer": "serving entry",
      "moves": "serve_scenes_per_s", "workloads": ["y1.serve.slow"]})
  with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
    json.dump(bench, f)
  code, line, _ = run_cell(root, ["--workload", "y1.serve.slow", "--seed",
                                  "3", "--seconds", "1", "--trace", "1"],
                           capsys)
  assert code == 0 and line["correct"] is True
  assert line["metrics"]["requests_per_s.slow"]["value"] > 0
  after = _digest(b)
  assert {k: v for k, v in after.items() if k in before} == before
