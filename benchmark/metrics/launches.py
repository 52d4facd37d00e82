"""Host calls that put work on the device or move data (kernel launches,
copies and sets: benchmark/harness/spans.py's LAUNCHES, by the profiler's
names) made while a main-thread program span was open, over the traced
window, per step or request. Reads `launches.train` and
`launches.serve`."""

from benchmark.harness import spans


def read(run):
  scale = spans.per_unit(run)
  main = spans.main_thread(spans.program_spans(run.trace))
  if scale is None or not main:
    return None
  lo, hi = spans.extent(run.trace)
  inside = spans.merge(spans.cut(main, (lo, hi)))
  return scale * spans.count_inside(spans.launch_times(run.trace), inside)
