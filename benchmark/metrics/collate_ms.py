"""Milliseconds of batch assembly per training step: the program's
`loader.collate` spans (`batching.batch` and the batch transform, on the
loader's producer thread) over the traced window, per step. Reads
`collate_ms.train`."""

from benchmark.harness import spans


def read(run):
  return spans.total_ms(run, ("loader.collate",))
