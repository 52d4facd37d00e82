"""Host milliseconds a unit of work takes to put the model's work on the
device: in training the program's `train.forward`, `train.loss`,
`train.backward` and `train.optimizer` spans per step, in serving its
`serve.request` spans per request, over the traced window. Reads
`dispatch_ms.train` and `dispatch_ms.serve`."""

from benchmark.harness import spans

NAMES = ("train.forward", "train.loss", "train.backward", "train.optimizer",
         "serve.request")


def read(run):
  return spans.total_ms(run, NAMES)
