"""The device an entry point runs on: the card unless the caller asks for
the CPU."""

from __future__ import annotations

import torch


def checked_device(device) -> torch.device:
  """torch.device(device); a CUDA device without a card raises, so that no
  run falls back to the CPU unasked."""
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
  return device
