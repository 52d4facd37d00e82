"""Scalar and image summaries: a JSONL file always, TensorBoard when it
imports.

Counterpart of corenet_tpu/utils/summary.py. Scalars go to
`<log_dir>/scalars.jsonl` (one JSON object per line: tag, value, step,
time); images go to `<log_dir>/<tag>_<step>.png` through utils/png.py;
both are mirrored to TensorBoard when `torch.utils.tensorboard` imports
(it needs the `tensorboard` package, which is imported only here, when a
writer is made).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from corenet_tpu_torch.utils import fs
from corenet_tpu_torch.utils.png import encode_png


def _try_tensorboard(log_dir: str):
  try:
    from torch.utils.tensorboard import SummaryWriter  # type: ignore
  except ImportError:
    return None
  return SummaryWriter(log_dir=log_dir)


class SummaryWriter:
  """Append-only scalar and image summaries under a log dir."""

  def __init__(self, log_dir: str, use_tensorboard: bool = True):
    self.log_dir = log_dir
    fs.makedirs(log_dir)
    self._jsonl_path = fs.join(log_dir, "scalars.jsonl")
    self._buffer = []
    self._tb = _try_tensorboard(log_dir) if use_tensorboard else None

  def add_scalar(self, tag: str, value: float, global_step: int):
    self._buffer.append(json.dumps({
        "tag": tag, "value": float(value), "step": int(global_step),
        "time": time.time()}))
    if self._tb is not None:
      self._tb.add_scalar(tag, value, global_step)

  def add_image(self, tag: str, image: np.ndarray, global_step: int):
    """image: uint8[H, W, 3]."""
    safe_tag = tag.replace("/", "_")
    fs.write_bytes(fs.join(self.log_dir, f"{safe_tag}_{global_step}.png"),
                   encode_png(image))
    if self._tb is not None:
      self._tb.add_image(tag, image, global_step, dataformats="HWC")

  def flush(self):
    if self._buffer:
      mode = "a" if os.path.exists(self._jsonl_path) else "w"
      with open(self._jsonl_path, mode) as f:
        f.write("\n".join(self._buffer) + "\n")
      self._buffer = []
    if self._tb is not None:
      self._tb.flush()

  def close(self):
    self.flush()
    if self._tb is not None:
      self._tb.close()
