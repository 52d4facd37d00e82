"""The device's idle share of the traced window: 100 × (1 − the union of
its device operations' intervals / the window), from the profiler.
Reads `idle_share.train` and `idle_share.serve`."""


def read(run):
  if run.trace is None or not run.trace.device_ops:
    return None
  return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
