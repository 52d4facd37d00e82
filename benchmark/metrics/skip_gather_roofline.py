"""The skip gather's share of its roofline over the window: its bytes
bound for the window's requests (benchmark/counts/gather.py) over the
device time of the gather's kernel, from the profiler."""

KERNEL = "gather_rows"


def read(run):
  if run.trace is None or not run.counts.get("gather_bound_s"):
    return None
  seconds = run.trace.device_s(lambda n: KERNEL in n)
  if seconds == 0:
    return None
  return 100.0 * run.counts["gather_bound_s"] / seconds
