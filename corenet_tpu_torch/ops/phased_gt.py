"""Bit-packed occupancy → phase-major ground truth: a CUDA kernel for CUDA
tensors, its plain PyTorch version for CPU tensors.

Counterpart of corenet_tpu/ops/phased_gt.py::phased_gt. The phase-loss
training step pairs the decoder's phase-major logits [B, D/s, H/s, W/s,
s³·C] with labels in the same order; this emits them straight from the
packed words of the on-device ground truth. For s ∈ {2, 4}:

  packed int32[B, H, W, NW] → uint8[B, D/s, H/s, (W/s)·s³] of 0/1,

lane jx·s³ + zpart[zc] + ypart[yc] + xpart[xc] holding voxel
(s·jz + zc, s·jy + yc, s·jx + xc), channel order (z1, y1, x1, z2, y2, x2)
with c = 2·c1 + c2 for s = 4: the digit weights are z 4, y 2, x 1 for
s = 2 and z (32, 4), y (16, 2), x (8, 1) for s = 4. That is the
training step's permutation of the unpacked grid for factors 8 (s = 2)
and 64 (s = 4), which `phased_gt_reference` computes. The JAX package's
kernel emits float32 (a Mosaic store limit); the values are the same. The
kernel is `csrc/phased_gt.cu`; its note says what bounds it.
"""

from __future__ import annotations

import ctypes

import torch

from corenet_tpu_torch import kernels
from corenet_tpu_torch.voxel.packed import unpack_grid

# Launches of the CUDA kernel in this process. Incremented only where the
# kernel is launched, so a run can show that its path went through it.
launch_count = 0

_SIGNATURES = {
    "phased_gt_fwd": ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p], ctypes.c_int),
    "phased_gt_error_string": ([ctypes.c_int], ctypes.c_char_p),
}
_MAX_SHARED_BYTES = 48 * 1024  # the kernel's shared-memory tile, at most


def phase_permute(grid: torch.Tensor, s: int) -> torch.Tensor:
  """The training step's permutation of labels [B, D, H, W] into the
  phase-major [B, D/s, H/s, (W/s)·s³] (corenet_tpu/train/step.py:179-187)."""
  b, d, h, w = grid.shape
  dq, hq, wq = d // s, h // s, w // s
  if s == 2:
    g = grid.reshape(b, dq, 2, hq, 2, wq, 2).permute(0, 1, 3, 5, 2, 4, 6)
  else:
    g = grid.reshape(b, dq, 2, 2, hq, 2, 2, wq, 2, 2)
    g = g.permute(0, 1, 4, 7, 2, 5, 8, 3, 6, 9)
  return g.reshape(b, dq, hq, wq * s ** 3)


def phased_gt_reference(packed: torch.Tensor, s: int) -> torch.Tensor:
  """The plain version: unpack to uint8 [B, D, H, W], then the step's
  permutation."""
  return phase_permute(unpack_grid(packed, dtype=torch.uint8), s)


def _check(packed: torch.Tensor, s: int):
  if s not in (2, 4):
    raise ValueError(f"phase factor s must be 2 or 4, got {s}")
  if packed.dtype != torch.int32 or packed.dim() != 4:
    raise ValueError(f"packed must be int32 [B, H, W, NW], got "
                     f"{packed.dtype} {tuple(packed.shape)}")
  _, h, w, _ = packed.shape
  if h % s or w % s:
    raise ValueError(f"H {h} and W {w} must be multiples of s = {s}")
  if packed.device.type not in ("cpu", "cuda"):
    raise ValueError(f"phased_gt runs on CPU or CUDA tensors, not "
                     f"{packed.device}")
  if not packed.is_contiguous():
    raise ValueError("packed must be contiguous")


def phased_gt_forward(packed: torch.Tensor, s: int) -> torch.Tensor:
  """The phasing on checked inputs: the CUDA kernel on the current stream
  for a CUDA input, the plain version for a CPU one."""
  if packed.device.type == "cpu":
    return phased_gt_reference(packed, s)
  b, h, w, nw = packed.shape
  staged = s * w * (nw if s == 2 else 1)
  if 4 * staged > _MAX_SHARED_BYTES:
    raise ValueError(f"phased_gt's kernel holds a block's packed words in "
                     f"shared memory: {staged} words exceed "
                     f"{_MAX_SHARED_BYTES // 4}")
  d = 32 * nw
  out = torch.empty((b, d // s, h // s, (w // s) * s ** 3),
                    dtype=torch.uint8, device=packed.device)
  if out.numel() == 0:
    return out
  lib = kernels.library("phased_gt", _SIGNATURES)
  with torch.cuda.device(packed.device):
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = lib.phased_gt_fwd(packed.data_ptr(), out.data_ptr(), b, h, w, nw,
                            s, stream)
  if err != 0:
    msg = lib.phased_gt_error_string(err).decode()
    raise RuntimeError(f"phased_gt kernel launch failed: CUDA error {err} "
                       f"({msg})")
  global launch_count
  launch_count += 1
  return out


def phased_gt(packed: torch.Tensor, s: int) -> torch.Tensor:
  """int32[B, H, W, NW] packed occupancy → uint8[B, D/s, H/s, (W/s)·s³]
  of 0/1 (D = 32·NW). Looks up `phased_gt_forward` at call time.

  A CUDA input launches the kernel on the current stream, or raises: it
  never takes the plain version. A CPU input takes the plain version."""
  _check(packed, s)
  return phased_gt_forward(packed, s)
