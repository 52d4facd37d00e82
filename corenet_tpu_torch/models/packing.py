"""Space-to-depth (×2 per axis) execution of the 3D decoder's convolutions.

Counterpart of corenet_tpu/models/packing.py in the port's (N, C, D, H, W)
layout. A packed activation holds each 2×2×2 block of fine voxels in its
channels, phase-major:

  packed[b, p·C + c, Z, Y, X] = fine[b, c, 2Z + pz, 2Y + py, 2X + px],
  p = (pz·2 + py)·2 + px.

Per axis, fine index m = 2M + r with packed cell M and phase r:

* stride-1 convolution (pad p, kernel k):
    y[2M + r] = Σ_{dJ, a} x_packed[M + dJ, a] · W[2dJ + a − r + p]
  → one packed convolution with 3 taps per axis for k = 3 and k = 5.
* stride-2 transposed convolution (pad p, output padding 1), packed in and
  packed out: fine output n = 2q + c with q = 2J + rm,
    y[2q + c] = Σ_dj x[q + dj] · W[p + c − 2dj],  dj = 2dJ + a − rm
  → one packed convolution emitting (rm, c) × C_out channels, 64·C_out in
  all, then a packed-space depth-to-space of rm.

Every function takes the fine weight in the port's layouts ((out, in,
k, k, k) for a convolution, (in, out, k, k, k) for a transposed one). The
packed kernels are gathers of it by static indices (cached per device)
into a copy of the fine weight with one zero appended, which the invalid
taps read: exact, and differentiable into the same parameter, so a packed
model has the fine model's state_dict. The expansion runs in the weight's
dtype and the packed kernel is cast to the input's afterwards, so a bf16
layer's weight gradient sums its taps in float32 and rounds once, as the
JAX package's expansion (a one-hot matmul, around TPU gathers) does.

The packed convolutions run as plain `F.conv3d`. Where a plan's padding
is asymmetric (the stride-2 plan of kernel 3), the convolution pads both
sides by the larger amount and the output is cropped: no padded copy of
the activation and no zero taps.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
  """fine (B, C, D, H, W) → packed (B, 8C, D/2, H/2, W/2), phase-major."""
  b, c, d, h, w = x.shape
  if d % 2 or h % 2 or w % 2:
    raise ValueError(f"space_to_depth needs even D, H, W, got {(d, h, w)}")
  x = x.reshape(b, c, d // 2, 2, h // 2, 2, w // 2, 2)
  x = x.permute(0, 3, 5, 7, 1, 2, 4, 6)
  return x.reshape(b, 8 * c, d // 2, h // 2, w // 2)


def depth_to_space(x: torch.Tensor, c: int) -> torch.Tensor:
  """packed (B, 8C, D2, H2, W2) → fine (B, C, 2·D2, 2·H2, 2·W2)."""
  b, pc, d2, h2, w2 = x.shape
  if pc != 8 * c:
    raise ValueError(f"{pc} packed channels are not 8 × {c}")
  x = x.reshape(b, 2, 2, 2, c, d2, h2, w2)
  x = x.permute(0, 4, 5, 1, 6, 2, 7, 3)
  return x.reshape(b, c, 2 * d2, 2 * h2, 2 * w2)


def _conv_cropped(x: torch.Tensor, weight: torch.Tensor, lo: int, hi: int,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Stride-1 `F.conv3d` padded by `lo` cells below and `hi` above on every
  axis, which may differ: it pads by the larger of the two and crops the
  output's extra rows (a view)."""
  pad = max(lo, hi)
  y = F.conv3d(x, weight, bias, 1, pad)
  if lo != hi:
    for axis in (2, 3, 4):
      size = x.shape[axis] + lo + hi - weight.shape[axis] + 1
      y = y.narrow(axis, pad - lo, size)
  return y


def _conv_taps(k: int, p: int) -> Tuple[int, int]:
  """(dJ_lo, dJ_hi) of the packed stride-1 plan: for output phase r and tap
  (dJ, a), the fine kernel index 2dJ + a − r + p lies in [0, k)."""
  los, his = [], []
  for r in (0, 1):
    for a in (0, 1):
      los.append(-(-(r - a - p) // 2))
      his.append((k - 1 - a + r - p) // 2)
  return min(los), max(his)


def _conv_transpose_taps(k: int, p: int) -> Tuple[int, int]:
  """(dJ_lo, dJ_hi) of the packed stride-2 plan: 0 ≤ p + c − 4dJ − 2a +
  2rm ≤ k − 1 for some output phase c, input phase a, parity rm."""
  los, his = [], []
  for c in (0, 1):
    for a in (0, 1):
      for rm in (0, 1):
        los.append(-(-(p + c - 2 * a + 2 * rm - (k - 1)) // 4))
        his.append((p + c - 2 * a + 2 * rm) // 4)
  return min(los), max(his)


def _flat_index(w0, w1, w2, k):
  """Index into a fine weight flattened over its k³ taps, with one zero
  appended: taps outside [0, k) on any axis read the zero at k³."""
  valid = ((w0 >= 0) & (w0 < k) & (w1 >= 0) & (w1 < k)
           & (w2 >= 0) & (w2 < k))
  flat = (w0 * k + w1) * k + w2
  return np.where(valid, flat, k ** 3).reshape(-1)


def _device_index(idx: np.ndarray, device: torch.device) -> torch.Tensor:
  """The index on `device`, made outside inference mode: it is cached, and
  a tensor made under inference mode could not be used by autograd."""
  with torch.inference_mode(False):
    return torch.from_numpy(idx).to(device)


@functools.lru_cache(maxsize=None)
def _conv_index(k: int, p: int, device: torch.device) -> torch.Tensor:
  """Flat tap index of the packed conv kernel, in the order (r, a, t0, t1,
  t2): output phase r = (r0, r1, r2), input phase a, taps t."""
  lo, hi = _conv_taps(k, p)
  t = np.arange(hi - lo + 1)
  ph = np.arange(2)
  r0, r1, r2, a0, a1, a2, t0, t1, t2 = np.meshgrid(
      ph, ph, ph, ph, ph, ph, t, t, t, indexing="ij")

  def w(tt, aa, rr):
    return 2 * (lo + tt) + aa - rr + p

  return _device_index(_flat_index(w(t0, a0, r0), w(t1, a1, r1),
                                   w(t2, a2, r2), k), device)


@functools.lru_cache(maxsize=None)
def _conv_transpose_index(k: int, p: int,
                          device: torch.device) -> torch.Tensor:
  """Flat tap index of the packed transposed-conv kernel, in the order
  (rm, c, a, t0, t1, t2): output parity rm = (rm0, rm1, rm2), output phase
  c, input phase a, taps t."""
  lo, hi = _conv_transpose_taps(k, p)
  t = np.arange(hi - lo + 1)
  ph = np.arange(2)
  (rm0, rm1, rm2, c0, c1, c2, a0, a1, a2, t0, t1,
   t2) = np.meshgrid(ph, ph, ph, ph, ph, ph, ph, ph, ph, t, t, t,
                     indexing="ij")

  def w(tt, aa, rr, cc):
    return p + cc - 4 * (lo + tt) - 2 * aa + 2 * rr

  return _device_index(_flat_index(w(t0, a0, rm0, c0), w(t1, a1, rm1, c1),
                                   w(t2, a2, rm2, c2), k), device)


def _gather_taps(weight: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """weight (o, i, k, k, k) → (o, i, len(idx)): the taps idx names, zero
  where idx is k³."""
  o, i = weight.shape[:2]
  flat = F.pad(weight.reshape(o, i, -1), (0, 1))
  return flat.index_select(2, idx)


def packed_conv(x_packed: torch.Tensor, weight: torch.Tensor, padding: int,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Stride-1 convolution on packed activations.

  Args:
    x_packed: (B, 8·Cin, D2, H2, W2).
    weight: the fine weight (Cout, Cin, k, k, k), odd k, padding = k // 2
      (fine output size = fine input size).
    bias: optional (8·Cout,) added inside the convolution.
  Returns: (B, 8·Cout, D2, H2, W2), phase-major.
  """
  cout, cin, k = weight.shape[:3]
  if weight.shape[2:] != (k, k, k) or padding != k // 2:
    raise ValueError(f"packed_conv takes a cubic odd kernel with padding "
                     f"k // 2, got {tuple(weight.shape)} padding {padding}")
  lo, hi = _conv_taps(k, padding)
  taps = hi - lo + 1
  kk = _gather_taps(weight, _conv_index(k, padding, weight.device))
  kk = kk.reshape(cout, cin, 8, 8, taps, taps, taps)
  kk = kk.permute(2, 0, 3, 1, 4, 5, 6)  # (r, co, a, ci, taps)
  kk = kk.reshape(8 * cout, 8 * cin, taps, taps, taps)
  return _conv_cropped(x_packed, kk.to(x_packed.dtype), -lo, hi, bias)


def packed_conv_transpose(x_packed: torch.Tensor, weight: torch.Tensor,
                          padding: int, output_padding: int,
                          phase_output: bool = False,
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
  """Stride-2 transposed convolution, packed input → packed output (the
  fine and the packed sizes double).

  Args:
    x_packed: (B, 8·Cin, S0, S1, S2).
    weight: the fine weight (Cin, Cout, k, k, k).
    phase_output: return the convolution's raw output (B, 64·Cout, S0, S1,
      S2), channel order (rm0, rm1, rm2, pz, py, px, c): fine index
      4·J + 2·rm + pz per axis. Without it, rm goes into space:
      (B, 8·Cout, 2·S0, 2·S1, 2·S2).
    bias: optional (64·Cout,) added inside the convolution.
  """
  cin, cout, k = weight.shape[:3]
  if weight.shape[2:] != (k, k, k):
    raise ValueError(f"packed_conv_transpose takes a cubic kernel, got "
                     f"{tuple(weight.shape)}")
  sizes = x_packed.shape[2:]
  for s in sizes:
    fine_out = (2 * s - 1) * 2 - 2 * padding + k + output_padding
    if fine_out != 4 * s:
      raise ValueError("packed_conv_transpose needs fine output = 2 × fine "
                       f"input (got {fine_out} from {2 * s})")
  lo, hi = _conv_transpose_taps(k, padding)
  taps = hi - lo + 1
  kk = _gather_taps(weight.transpose(0, 1),
                    _conv_transpose_index(k, padding, weight.device))
  kk = kk.reshape(cout, cin, 64, 8, taps, taps, taps)
  kk = kk.permute(2, 0, 3, 1, 4, 5, 6)  # ((rm, c), co, a, ci, taps)
  kk = kk.reshape(64 * cout, 8 * cin, taps, taps, taps)
  y = _conv_cropped(x_packed, kk.to(x_packed.dtype), -lo, hi, bias)
  if phase_output:
    return y
  b = y.shape[0]
  j0, j1, j2 = y.shape[2:]
  y = y.reshape(b, 2, 2, 2, 8 * cout, j0, j1, j2)
  y = y.permute(0, 4, 5, 1, 6, 2, 7, 3)
  return y.reshape(b, 8 * cout, 2 * j0, 2 * j1, 2 * j2)
