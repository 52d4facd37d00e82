"""The program's spans and counters: one registry for the process.

`span(name, id=None)` marks a range of host time where the program does
one thing. It records only while a torch.profiler records: then it keeps
the span in memory (name, id, parent span, thread, start and end, the
counts taken inside it) and enters `torch.profiler.record_function(name)`
too, so an exported trace shows the same ranges. Otherwise it returns one
shared no-op context: no allocation, no clock read, no synchronize. There
is no switch of its own; profiling is the switch (the train CLI's
`--profile_dir`, the benchmark's `--trace 1`). The test is torch's
process-wide flag (`torch.autograd.profiler._is_profiler_enabled`, set
while a profiler runs), which every thread sees: torch's per-thread state
never reaches a thread started before the profiler, such as the data
loader's producer.

Times are `time.time_ns()`, Unix-epoch nanoseconds, the clock of
torch.profiler's events, so a span lines up with the trace's device
operations and CUDA runtime calls.

A span without an id takes its parent's, so the spans of one step or one
request share the id. `count(name, n)` adds to a cumulative total, read
by `counters()` whether or not tracing is on, and while tracing also to
the counts of the calling thread's innermost open span (a count belongs
to that one span, not to its parents).

The spans:
  train.step (id: the global step before it), on the training thread,
    with its children train.loader_wait, train.to_device, train.gt (with
    one fill.sync for each adaptive fill round's flag read),
    train.forward, train.loss, train.backward (the gradient all-reduce
    included) and train.optimizer;
  loader.collate, on the data loader's producer thread;
  serve.request (id: the request's number), with serve.to_device,
    serve.encode, serve.decode and serve.assemble.
The counters: <op>.launches for each hand-written kernel of ops/,
skip_gather.backward_launches, fill.rounds, mesh.collectives,
gt.route.space_shared and gt.route.replicated.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List, Optional

from torch.autograd import profiler as _profiler

# Spans kept at most; later ones are not recorded.
MAX_SPANS = 1 << 18


class Span:
  """One recorded span, and the context manager that records it. `end` is
  None while it is open; `counts` is None until something is counted
  inside it."""

  __slots__ = ("name", "id", "parent", "thread", "start", "end", "counts",
               "_range")

  def __init__(self, name: str, id):
    self.name, self.id = name, id
    self.parent: Optional[Span] = None
    self.thread = self.start = self.end = None
    self.counts: Optional[Dict[str, int]] = None

  def __enter__(self):
    stack = _stack()
    if stack:
      self.parent = stack[-1]
      if self.id is None:
        self.id = self.parent.id
    self.thread = threading.get_ident()
    self.start = time.time_ns()
    _spans.append(self)
    stack.append(self)
    self._range = _profiler.record_function(self.name)
    self._range.__enter__()
    return self

  def __exit__(self, *exc):
    self._range.__exit__(*exc)
    self._range = None
    self.end = time.time_ns()
    _stack().pop()
    return False


_OFF = contextlib.nullcontext()
_spans: List[Span] = []
_totals: Dict[str, int] = {}
_lock = threading.Lock()
_local = threading.local()


def _stack() -> List[Span]:
  """The calling thread's open spans, innermost last."""
  stack = getattr(_local, "stack", None)
  if stack is None:
    stack = _local.stack = []
  return stack


def span(name: str, id=None):
  """A context manager over the range `name` (see the module docstring)."""
  if not _profiler._is_profiler_enabled or len(_spans) >= MAX_SPANS:
    return _OFF
  return Span(name, id)


def count(name: str, n: int = 1) -> None:
  """Adds `n` to the counter `name`, and while tracing to the calling
  thread's innermost open span."""
  with _lock:
    _totals[name] = _totals.get(name, 0) + n
  if _profiler._is_profiler_enabled:
    stack = getattr(_local, "stack", None)
    if stack:
      counts = stack[-1].counts
      if counts is None:
        counts = stack[-1].counts = {}
      counts[name] = counts.get(name, 0) + n


def spans() -> List[Span]:
  """The recorded spans, in the order they opened."""
  return list(_spans)


def clear() -> None:
  """Forgets the recorded spans (the counters keep their totals)."""
  del _spans[:]


def counters() -> "collections.Counter[str]":
  """Every counter's total since the process started (0 for a name never
  counted)."""
  with _lock:
    return collections.Counter(_totals)
