"""Runs one cell of the benchmark of corenet_tpu_torch and prints its result.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards. The
cell, its configuration, its traffic mix, its driver and its per-layer
metrics are files found by name (benchmark/README.md). A run sets up
(data and weights from the seed, the program built and warmed at the
cell's shapes), measures the window, with `--trace 1` under
torch.profiler, checks what the window produced against the plain
reference, and prints as its last line one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` and, traced, `breakdown`, with
the compared numbers beside their limits last (also the last lines on
standard error). Without the cards the run prints no result and exits
non-zero; so it does if JAX or the JAX package was loaded.

`--control 1` runs no window: it puts the reference one precision below
the configuration's in the program's place and prints the compared
numbers that it reaches, from which the limits were set.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
import time


def _process_start() -> float:
  """The wall-clock time at which this process started."""
  try:
    with open("/proc/self/stat") as f:
      ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
      uptime = float(f.read().split()[0])
    return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
  except (OSError, ValueError, IndexError):
    return time.time()


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Context:
  """What a driver is given: the cell, its configuration and traffic, the
  seed and the device; `mark` logs the set-up's phases."""

  def __init__(self, **kw):
    self.__dict__.update(kw)
    self._last = time.time()

  def mark(self, phase: str) -> None:
    now = time.time()
    print(f"setup {phase} {now - self._last:.3f} s", file=sys.stderr,
          flush=True)
    self._last = now


class Run:
  """What a per-layer metric reads: the window's trace and counts."""

  def __init__(self, trace, counts, window):
    self.trace, self.counts, self.window = trace, counts, window


def parse(argv):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--workload", required=True)
  p.add_argument("--seed", type=int, required=True)
  p.add_argument("--seconds", type=float, required=True)
  p.add_argument("--trace", type=int, choices=(0, 1), default=0)
  p.add_argument("--control", type=int, choices=(0, 1), default=0)
  p.add_argument("--fault", default="",
                 help="a fault planted in the reference put in the "
                 "program's place: print the compared numbers it reaches")
  return p.parse_args(argv)


def main(argv, root: str = ROOT, device: str = "cuda") -> int:
  start = _process_start() if device == "cuda" else time.time()
  args = parse(argv)
  if root not in sys.path:
    sys.path.insert(0, root)
  from benchmark.harness import device as card
  from benchmark.harness import spec as spec_lib
  spec = spec_lib.Spec(root)
  cell = spec.workload(args.workload)
  if device == "cuda":
    missing = card.cards_missing(cell["chips"])
    if missing:
      print(f"benchmark: {missing}; no result", file=sys.stderr)
      return 3
    for line in card.describe():
      print(line, flush=True)
  _tensorboard_without_tensorflow()
  scratch = tempfile.mkdtemp(prefix="corenet_bench_")
  try:
    if args.control or args.fault:
      # The reference alone, on the card, at the cell's batch.
      ctx = _context(args, spec, cell, scratch, device)
      driver = spec.module("drivers", cell["driver"])
      readings = (driver.fault(ctx, args.fault) if args.fault
                  else driver.control(ctx))
      print(json.dumps({args.fault or "control": readings,
                        "seed": args.seed}))
      return 0
    ctx = _context(args, spec, cell, scratch, device)
    line, checks = _measure(args, spec, ctx,
                            spec.module("drivers", cell["driver"]), start)
  finally:
    shutil.rmtree(scratch, ignore_errors=True)
  if line is None:
    return 1
  _join_children()
  forbidden = card.forbidden_modules()
  if forbidden:
    print(f"benchmark: loaded {', '.join(forbidden)}; no result",
          file=sys.stderr)
    return 4
  for name, v, lim in checks:
    print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(line), flush=True)
  return 0


def _context(args, spec, cell, scratch, device):
  import torch
  dev = torch.device("cuda:0" if device == "cuda" else device)
  return Context(cell=cell, config=spec.config(cell["config"]),
                 traffic=spec.traffic(cell["traffic"]),
                 seed=args.seed % (1 << 63), device=dev,
                 chips=cell["chips"], scratch=scratch)


def _measure(args, spec, ctx, driver, start):
  """Set-up, the window (traced when asked), the counts, the peak and the
  check of one process: (the result's line, the compared numbers)."""
  import torch
  from benchmark.harness import trace as trace_lib
  state = driver.setup(ctx)
  setup_s = time.time() - start
  print(f"setup_s {setup_s!r}", file=sys.stderr, flush=True)
  with trace_lib.profiled(bool(args.trace)) as holder:
    result = driver.window(state, args.seconds)
  trace = trace_lib.from_holder(holder, result["window_s"])
  counts = driver.counts(state, result) if args.trace else {}
  cuda = ctx.device.type == "cuda"
  peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
  checks = driver.check(state)

  metrics = {}
  if args.trace:
    run = Run(trace, counts, result)
    for m in spec.metrics("per_layer", args.workload):
      value = spec.module("metrics", m["name"]).read(run)
      if value is not None:
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
  else:
    values = dict(result["e2e"], setup_s=setup_s)
    for m in spec.metrics("end_to_end", args.workload):
      metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
  dev = {"platform": "gpu" if cuda else ctx.device.type,
         "kind": (torch.cuda.get_device_name(ctx.device) if cuda
                  else ctx.device.type),
         "count": ctx.chips, "memory_peak_bytes": peak}
  line = {"correct": all(math.isfinite(v) and v <= lim
                         for _, v, lim in checks),
          "attempted": result["attempted"], "failed": result["failed"],
          "metrics": metrics, "device": dev}
  if trace is not None:
    dev["busy_s"] = trace.busy_s()
    dev["window_s"] = trace.window_s
    line["breakdown"] = {"device_ops": trace.top_ops(),
                         "idle_gaps": trace.idle_gaps()}
  line["checks"] = {name: {"value": v, "limit": lim}
                    for name, v, lim in checks}
  return line, checks


def _tensorboard_without_tensorflow() -> None:
  """The training pipeline's summaries reach TensorBoard where it is
  installed, and TensorBoard imports TensorFlow where that is installed,
  which loads JAX. TensorBoard takes its TensorFlow stub instead when the
  module `tensorboard.compat.notf` exists: the run provides it, as it
  would set a library's switch in the environment to keep JAX out. The
  program's summaries go to TensorBoard all the same."""
  import types
  name = "tensorboard.compat.notf"
  sys.modules.setdefault(name, types.ModuleType(name))


def _join_children() -> None:
  """Waits for every child process this run started, ending any that
  outlives a grace period."""
  import multiprocessing
  for child in multiprocessing.active_children():
    child.join(timeout=30)
    if child.is_alive():
      child.terminate()
      child.join()


if __name__ == "__main__":
  sys.exit(main(sys.argv[1:]))
