"""Device milliseconds a training step spends in NCCL's kernels (the
collectives: BatchRenorm's statistics, the loss's means, the gradient
all-reduce), by name from rank 0's trace over the window, per step.
Reads `nccl_ms.train`."""


def read(run):
  units = run.window.get("units") if run.window else None
  if run.trace is None or not units:
    return None
  seconds = run.trace.device_s(lambda n: "nccl" in n.lower())
  if seconds == 0:
    return None
  return 1e3 * seconds / units
