"""The share of the device's idle time, inside the traced window, during
which no main-thread program span was open: idle time that no span of
the program names. Reads `idle_unspanned.train` and
`idle_unspanned.serve`."""

from benchmark.harness import spans


def read(run):
  main = spans.main_thread(spans.program_spans(run.trace))
  if not main:
    return None
  gaps = spans.idle(run.trace)
  total = sum(e - s for s, e in gaps)
  if total == 0:
    return None
  pieces = spans.innermost(main, spans.extent(run.trace))
  return 100.0 * spans.overlap_by(pieces, gaps).get("none", 0) / total
