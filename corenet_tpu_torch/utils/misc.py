"""Small helpers shared across the port (numpy, host side).

The port's own copy of the parts of corenet_tpu/utils/misc.py it needs:
round_up, dynamic_tile_np, safe_div.
"""

from __future__ import annotations

import numpy as np


def dynamic_tile_np(partition_lengths: np.ndarray) -> np.ndarray:
  """Returns [0]*len[0] + [1]*len[1] + ... as one int32 vector."""
  partition_lengths = np.asarray(partition_lengths, np.int64)
  return np.repeat(
      np.arange(len(partition_lengths), dtype=np.int32),
      partition_lengths)


def safe_div(x, y):
  """x/y where y != 0, else 0."""
  return np.where(y != 0, x / np.where(y == 0, 1, y), 0)


def round_up(n: int, div: int) -> int:
  """Rounds n up to the nearest multiple of div."""
  return ((n + div - 1) // div) * div
