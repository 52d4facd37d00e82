"""The blocked rasterizer's least time for a batch: its operations bound
(every sample of a valid triangle's 4·irm × 4·irm window takes 36 float32
operations in the kernel's loop: the sample's coordinate 2, three edge
functions 12, the double area 2, the coverage test 7, the area's test 1,
the division 1, the depth 8, its range 2, its floor 1) against its bytes
bound (the triangles, slots, validity and the scene's matrix read once,
the packed grid written once), at the H100's float32 and HBM peaks."""

from benchmark.counts.peaks import F32_FLOPS, HBM_BYTES_PER_S

OPS_PER_SAMPLE = 36


def bound_s(valid_triangles: int, batch: int, padded: int, m: int,
            irm: int) -> float:
  """Seconds for one launch over `batch` scenes padded to `padded`
  triangles each, `valid_triangles` of them real, into one mesh slot of
  an m³ grid."""
  samples = valid_triangles * (4 * irm) ** 2
  nbytes = batch * padded * (36 + 4 + 1) + batch * 64 + batch * m * m * m // 8
  return max(samples * OPS_PER_SAMPLE / F32_FLOPS, nbytes / HBM_BYTES_PER_S)
