"""The skip gather's least time: its bytes bound. A launch reads each
distinct pixel that its indices name once (a row of C values), reads the
two int32 indices of every voxel and writes every voxel's row, at the
H100's HBM peak."""

import torch

from benchmark.counts.peaks import HBM_BYTES_PER_S
from benchmark.reference.model import pixel_indices


def distinct_pixels(matrix: torch.Tensor, offset: torch.Tensor, res: int,
                    h2: int) -> int:
  """Distinct (scene, pixel) pairs that a skip's voxels read: matrix
  [B, 4, 4] voxel → NDC at the skip's grid, offset [B, 3], a res³ grid,
  an h2 × h2 padded map."""
  px, py = pixel_indices(matrix, offset, (res,) * 3, h2 - 2, h2 - 2)
  rows = torch.arange(px.shape[0], device=px.device)[:, None]
  return int(torch.unique(rows * h2 * h2 + py * h2 + px).numel())


def launch_bytes(batch: int, res: int, channels: int, element: int,
                 pixels: int) -> int:
  return batch * res ** 3 * (channels * element + 8) + pixels * channels * element


def bound_s(nbytes: int) -> float:
  return nbytes / HBM_BYTES_PER_S
