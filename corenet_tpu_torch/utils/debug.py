"""Debugging helpers: a compact one-line description of an array or a
tensor, compact tensor printing, and a quick image dump.

Counterpart of corenet_tpu/utils/debug.py. `array_summary` gives the JAX
package's strings for numpy inputs, and takes tensors too (bf16 through
float32). `install_compact_array_repr` sets torch's print options where
the JAX package patches `jax.Array.__repr__`. `save_debug_image` writes
its PNG through utils/png.py, without PIL.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from corenet_tpu_torch.utils import fs
from corenet_tpu_torch.utils.png import encode_png


def _as_numpy(x: Any) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
      x = x.float()
    return x.numpy()
  return np.asarray(x)


def array_summary(x: Any) -> str:
  """Compact one-line description of an array-like or a tensor."""
  try:
    a = _as_numpy(x)
  except Exception:
    return repr(x)
  if a.size == 0:
    return f"{a.dtype}{list(a.shape)} (empty)"
  if a.dtype == bool:
    return f"bool{list(a.shape)} true={int(a.sum())}/{a.size}"
  if np.issubdtype(a.dtype, np.floating):
    finite = np.isfinite(a)
    extra = "" if finite.all() else f" nonfinite={int((~finite).sum())}"
    af = a[finite] if not finite.all() else a
    if af.size == 0:
      return f"{a.dtype}{list(a.shape)} all-nonfinite"
    return (f"{a.dtype}{list(a.shape)} μ={af.mean():.4g} σ={af.std():.4g} "
            f"[{af.min():.4g}, {af.max():.4g}]{extra}")
  return f"{a.dtype}{list(a.shape)} [{a.min()}, {a.max()}]"


def install_compact_array_repr() -> None:
  """Prints tensors compactly: 4 significant digits, two items at each
  edge of a dimension, and a summary from 64 elements on."""
  torch.set_printoptions(precision=4, threshold=64, edgeitems=2,
                         linewidth=120)


def save_debug_image(image: Any, path: str = "debug.png") -> str:
  """Writes an [H, W, 3] or [H, W] (grey) image as a PNG for quick
  inspection and returns the path. uint8 is written as it is; any other
  dtype is scaled from its range to 0..255."""
  a = _as_numpy(image)
  if a.dtype != np.uint8:
    lo, hi = float(a.min()), float(a.max())
    a = ((a - lo) / (hi - lo + 1e-12) * 255).astype(np.uint8)
  if a.ndim == 2:
    a = np.stack([a] * 3, -1)
  directory = fs.dirname(path)
  if directory:
    fs.makedirs(directory)
  fs.write_bytes(path, encode_png(a))
  return path
