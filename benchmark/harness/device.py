"""The card: what the run may use, what it is, and what the process has
loaded."""

from __future__ import annotations

import subprocess
import sys
from typing import List

# Top-level module names that no run may have loaded: JAX and the JAX
# package that the measured port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "corenet_tpu")


def cards_missing(chips: int) -> str:
  """Why this process cannot run a cell of `chips` cards, or ''."""
  import torch
  if not torch.cuda.is_available():
    return "no CUDA device"
  if torch.cuda.device_count() < chips:
    return (f"the cell needs {chips} CUDA devices, "
            f"{torch.cuda.device_count()} present")
  return ""


def describe() -> List[str]:
  """The cards' names, power limits and clocks, from nvidia-smi."""
  try:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout
  except (OSError, subprocess.TimeoutExpired) as e:
    return [f"nvidia-smi: {e}"]
  return [f"card {line}" for line in out.strip().splitlines()]


def forbidden_modules() -> List[str]:
  """Forbidden top-level names in sys.modules, compared whole."""
  loaded = {name.split(".")[0] for name in list(sys.modules)}
  return sorted(loaded.intersection(FORBIDDEN))
