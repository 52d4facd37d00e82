"""Host milliseconds a training step spends merging a labeled grid's mesh
slots into labels (unpack, multiply by each slot's class, max over the
slots): the program's `gt.labels` spans over the traced window, per
step. Reads `label_merge_ms.train`."""

from benchmark.harness import spans


def read(run):
  return spans.total_ms(run, ("gt.labels",))
