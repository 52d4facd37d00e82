"""The blocked rasterizer's share of its roofline over the window: the
least time its batches need (benchmark/counts/raster.py) over the device
time of the kernel that does the work, from the profiler."""

KERNEL = "blocked_raster_kernel"


def read(run):
  if run.trace is None or not run.counts.get("raster_bound_s"):
    return None
  seconds = run.trace.device_s(lambda n: KERNEL in n)
  if seconds == 0:
    return None
  return 100.0 * run.counts["raster_bound_s"] / seconds
