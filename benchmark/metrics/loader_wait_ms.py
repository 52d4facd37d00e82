"""Milliseconds a training step waits for the loader's batch: the
program's `train.loader_wait` spans (the step blocked on the loader's
queue) over the traced window, per step. Reads `loader_wait_ms.train`."""

from benchmark.harness import spans


def read(run):
  return spans.total_ms(run, ("train.loader_wait",))
