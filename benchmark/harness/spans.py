"""The program's spans over a traced window.

corenet_tpu_torch/utils/tracing.py records the program's spans while
torch.profiler runs, stamped with `time.time_ns()`, the clock of the
profiler's events. The readers here take the spans that overlap the
trace's own extent (from the earliest to the latest of its device and
host events), each cut to it, so that spans of set-up or of an earlier
window never count. A program without the registry records no spans: the
readers then find nothing, and the metrics that read them are left out.

A span of the main thread is one the program opened on the thread that
runs the window (the step loop, the request loop); the data loader's
producer is another thread.
"""

from __future__ import annotations

import bisect
import functools
import threading
from typing import Dict, Iterable, List, Optional, Tuple

# CUDA runtime and driver calls that put work on the device or move data
# to or from it, by the names torch.profiler gives them.
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
            "cudaGraphLaunch", "cudaMemcpy", "cudaMemcpyAsync",
            "cudaMemcpy2DAsync", "cudaMemset", "cudaMemsetAsync")

# The spans that hold a whole step or a whole request.
ROOTS = ("train.step", "serve.request")

Interval = Tuple[int, int]


# The readers of one run share what they compute from its trace.
_per_trace = functools.lru_cache(maxsize=1)


@_per_trace
def extent(trace) -> Optional[Interval]:
  """The earliest start and latest end of the trace's events."""
  events = trace.device_ops + trace.host_ops
  if not events:
    return None
  return (min(s for _, s, _ in events), max(e for _, _, e in events))


def program_spans(trace) -> list:
  """The program's closed spans that overlap the trace's extent."""
  if trace is None:
    return []
  try:
    from corenet_tpu_torch.utils import tracing
  except ImportError:
    return []
  bounds = extent(trace)
  if bounds is None:
    return []
  lo, hi = bounds
  return [s for s in tracing.spans()
          if s.end is not None and s.end > lo and s.start < hi]


def main_thread(spans: Iterable) -> list:
  ident = threading.main_thread().ident
  return [s for s in spans if s.thread == ident]


def cut(spans: Iterable, bounds: Interval) -> List[Interval]:
  lo, hi = bounds
  return [(max(s.start, lo), min(s.end, hi)) for s in spans]


def merge(intervals: Iterable[Interval]) -> List[Interval]:
  out: List[List[int]] = []
  for s, e in sorted(intervals):
    if e <= s:
      continue
    if out and s <= out[-1][1]:
      out[-1][1] = max(out[-1][1], e)
    else:
      out.append([s, e])
  return [(s, e) for s, e in out]


@_per_trace
def idle(trace) -> List[Interval]:
  """The device's idle intervals inside the trace's extent."""
  lo, hi = extent(trace)
  out, at = [], lo
  for s, e in trace.merged():
    if s > at:
      out.append((at, s))
    at = max(at, e)
  if hi > at:
    out.append((at, hi))
  return out


def overlap_by(pieces: List[Tuple[int, int, str]],
               intervals: List[Interval]) -> Dict[str, int]:
  """The length of `intervals` (sorted, disjoint) inside each named piece
  (sorted, disjoint), summed by name."""
  out: Dict[str, int] = {}
  i = j = 0
  while i < len(pieces) and j < len(intervals):
    s = max(pieces[i][0], intervals[j][0])
    e = min(pieces[i][1], intervals[j][1])
    if e > s:
      out[pieces[i][2]] = out.get(pieces[i][2], 0) + e - s
    if pieces[i][1] < intervals[j][1]:
      i += 1
    else:
      j += 1
  return out


def per_unit(run) -> Optional[float]:
  """1 / the window's units (steps or requests), or None."""
  units = run.window.get("units") if run.window else None
  return 1.0 / units if units else None


def total_ms(run, names) -> Optional[float]:
  """Milliseconds a unit of the window spent in spans of `names`, each
  cut to the trace's extent; None where no such span lies inside it."""
  scale = per_unit(run)
  spans = [s for s in program_spans(run.trace) if s.name in names]
  if scale is None or not spans:
    return None
  inside = cut(spans, extent(run.trace))
  return sum(e - s for s, e in inside) / 1e6 * scale


@_per_trace
def launch_times(trace) -> List[int]:
  return sorted(s for n, s, _ in trace.host_ops if n in LAUNCHES)


def count_inside(times: List[int], intervals: List[Interval]) -> int:
  """How many of the sorted `times` lie in the merged `intervals`, each
  taken as [start, end)."""
  return sum(bisect.bisect_left(times, e) - bisect.bisect_left(times, s)
             for s, e in intervals)


def innermost(spans: list, bounds: Interval) -> List[Tuple[int, int, str]]:
  """The timeline of one thread's nested spans inside `bounds`: pieces
  (start, end, name of the innermost open span, or "none")."""
  edges = []
  for k, s in enumerate(spans):
    edges.append((s.start, 1, k))
    edges.append((s.end, 0, k))
  edges.sort()
  lo, hi = bounds
  pieces, stack, at = [], [], lo
  for t, opens, k in edges:
    t = min(max(t, lo), hi)
    if t > at:
      pieces.append((at, t, spans[stack[-1]].name if stack else "none"))
      at = t
    if opens:
      stack.append(k)
    elif k in stack:
      stack.remove(k)
  if hi > at:
    pieces.append((at, hi, "none"))
  return pieces


def breakdown(run) -> Dict:
  """Where the window's idle device time and its launches lie, by the
  innermost main-thread span open at the time; the share of the launches
  inside a step or request span; each span's milliseconds and each
  counter per unit."""
  spans = program_spans(run.trace)
  scale = per_unit(run)
  if not spans or scale is None:
    return {}
  bounds = extent(run.trace)
  main = main_thread(spans)
  pieces = innermost(main, bounds)
  gaps = idle(run.trace)
  idle_by = overlap_by(pieces, gaps)
  times = launch_times(run.trace)
  launches_by: Dict[str, int] = {}
  for s, e, name in pieces:
    n = count_inside(times, [(s, e)])
    if n:
      launches_by[name] = launches_by.get(name, 0) + n
  roots = merge(cut([s for s in main if s.name in ROOTS], bounds))
  span_ms: Dict[str, float] = {}
  counts: Dict[str, float] = {}
  for s in spans:
    ns = min(s.end, bounds[1]) - max(s.start, bounds[0])
    span_ms[s.name] = span_ms.get(s.name, 0.0) + ns / 1e6 * scale
    for k, v in (s.counts or {}).items():
      counts[k] = counts.get(k, 0.0) + v * scale
  idle_total = sum(e - s for s, e in gaps)
  calls: Dict[str, int] = {}
  for n, _, _ in run.trace.host_ops:
    calls[n] = calls.get(n, 0) + 1
  return {
      "units": run.window["units"],
      "idle_ms_by_span": {k: v / 1e6 * scale for k, v in idle_by.items()},
      "idle_share_by_span": {k: 100.0 * v / idle_total
                             for k, v in idle_by.items()} if idle_total
                            else {},
      "launches_by_span": {k: v * scale for k, v in launches_by.items()},
      "launches_in_roots": count_inside(times, roots),
      "launches": len(times),
      "span_ms": span_ms,
      "counts": counts,
      "host_calls": sorted(calls.items(), key=lambda kv: -kv[1])[:20],
  }
