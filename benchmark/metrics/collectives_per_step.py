"""Collectives that rank 0 issues per training step: the program's
`mesh.collectives` counter over the window (the driver's count of its
change, which includes the backward's all-reduces on autograd's own
thread), per step. Reads `collectives_per_step.train`."""


def read(run):
  units = run.window.get("units") if run.window else None
  count = run.counts.get("collectives")
  if not units or count is None:
    return None
  return count / units
