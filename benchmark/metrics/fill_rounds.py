"""Rounds of the adaptive interior fill per training step, each one host
sync: the program's `fill.rounds` counts, taken inside its spans over the
traced window, per step. Reads `fill_rounds.train`."""

from benchmark.harness import spans


def read(run):
  scale = spans.per_unit(run)
  found = spans.program_spans(run.trace)
  if scale is None or not found:
    return None
  return scale * sum((s.counts or {}).get("fill.rounds", 0) for s in found)
