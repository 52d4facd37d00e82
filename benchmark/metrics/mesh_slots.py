"""Mesh slots that the device ground truth voxelizes per training step
(B·M a call): the program's `gt.mesh_slots` counts, taken inside its
spans over the traced window, per step. Reads `mesh_slots.train`."""

from benchmark.harness import spans


def read(run):
  scale = spans.per_unit(run)
  found = [s for s in spans.program_spans(run.trace)
           if "gt.mesh_slots" in (s.counts or {})]
  if scale is None or not found:
    return None
  return scale * sum(s.counts["gt.mesh_slots"] for s in found)
