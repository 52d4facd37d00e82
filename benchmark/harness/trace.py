"""The traced window: torch.profiler over the window, reduced to the device
activity that the per-layer metrics read.

`Trace` holds the window's device operations (kernels, copies and sets:
name, start, end in ns) and the host's operations, on the profiler's one
clock. Its busy time is the union of the device intervals; the idle gaps
are the spaces between them, each named by the innermost host operation
that was running at its middle (on the card: CUDA's runtime call, or
none while the host ran Python).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np

Interval = Tuple[str, int, int]


class Trace:

  def __init__(self, device_ops: List[Interval], host_ops: List[Interval],
               window_s: float):
    self.device_ops = device_ops
    self.host_ops = host_ops
    self.window_s = window_s

  def merged(self) -> List[Tuple[int, int]]:
    spans = sorted((s, e) for _, s, e in self.device_ops if e > s)
    out: List[List[int]] = []
    for s, e in spans:
      if out and s <= out[-1][1]:
        out[-1][1] = max(out[-1][1], e)
      else:
        out.append([s, e])
    return [(s, e) for s, e in out]

  def busy_s(self) -> float:
    return sum(e - s for s, e in self.merged()) / 1e9

  def device_s(self, match) -> float:
    """Device seconds in operations whose name satisfies `match`."""
    return sum(e - s for n, s, e in self.device_ops if match(n)) / 1e9

  def top_ops(self, count: int = 10) -> List[list]:
    totals: Dict[str, int] = {}
    for n, s, e in self.device_ops:
      totals[n] = totals.get(n, 0) + (e - s)
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:count]
    return [[n[:200], t / 1e9] for n, t in top]

  def idle_gaps(self, count: int = 10) -> List[list]:
    spans = self.merged()
    gaps = sorted(((spans[i + 1][0] - spans[i][1], spans[i][1],
                    spans[i + 1][0]) for i in range(len(spans) - 1)),
                  reverse=True)[:count]
    if not self.host_ops:
      return [["unknown", g / 1e9] for g, _, _ in gaps]
    starts = np.array([s for _, s, _ in self.host_ops], np.int64)
    ends = np.array([e for _, _, e in self.host_ops], np.int64)
    out = []
    for g, s, e in gaps:
      mid = (s + e) // 2
      inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
      if len(inside):
        k = inside[np.argmin(ends[inside] - starts[inside])]
        name = self.host_ops[k][0]
      else:
        name = "no host operation"
      out.append([name[:200], g / 1e9])
    return out


@contextlib.contextmanager
def profiled(enabled: bool):
  """Yields a holder whose `events` are set after the block when
  `enabled`: the profiler's (device, host) operations over the block."""
  holder = type("Holder", (), {"events": None})()
  if not enabled:
    yield holder
    return
  import torch
  from torch.profiler import ProfilerActivity, profile
  # On the card the device's activity alone: recording every host
  # operation as well slows the host-bound loops by a third. The host's
  # side is then CUDA's runtime calls (launches, copies, synchronizes).
  activities = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                else [ProfilerActivity.CPU])
  prof = profile(activities=activities)
  prof.start()
  try:
    yield holder
  finally:
    prof.stop()
  holder.events = _events(prof)


def _events(prof) -> Tuple[List[Interval], List[Interval]]:
  from torch.autograd import DeviceType
  device, host = [], []
  for ev in prof.profiler.kineto_results.events():
    start = ev.start_ns()
    end = start + ev.duration_ns()
    item = (ev.name(), start, end)
    if ev.is_user_annotation():
      continue  # a range that the program named, not device work
    if ev.device_type() == DeviceType.CUDA:
      device.append(item)
    else:
      host.append(item)
  return device, host


def from_holder(holder, window_s: float) -> Optional[Trace]:
  events = holder.events
  if events is None:
    return None
  return Trace(events[0], events[1], window_s)
