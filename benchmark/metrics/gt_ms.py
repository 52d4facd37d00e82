"""Host milliseconds a training step spends producing its labels: the
program's `train.gt` spans (the ground truth voxelized in the step, its
fill's host syncs included) over the traced window, per step. Reads
`gt_ms.train`."""

from benchmark.harness import spans


def read(run):
  return spans.total_ms(run, ("train.gt",))
