"""Host milliseconds a training step spends in the two factors of the
SEMANTIC loss, the class-agnostic IoU and the cross-entropy: the
program's `loss.iou` and `loss.xent` spans over the traced window, per
step. Reads `semantic_loss_ms.train`."""

from benchmark.harness import spans


def read(run):
  return spans.total_ms(run, ("loss.iou", "loss.xent"))
