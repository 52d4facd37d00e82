"""The FG_BG soft-IoU loss sums: a CUDA kernel for CUDA tensors, its plain
PyTorch version for CPU tensors.

Counterpart of corenet_tpu/ops/fgbg_loss.py::fgbg_sums. From the logit
difference diff = logit1 − logit0 and the labels of each scene,

  inter[b] = Σ_{gt=1} σ(diff)      union[b] = Σ_{gt=1} 1 + Σ_{gt≠1} σ(diff)

summed in f64, returned in f32. The kernel is `csrc/fgbg_sums.cu`; its note says what bounds it
and why its sums are the same from run to run. The gradient is elementwise,
d diff = σ'(diff)·(gt = 1 ? d_inter : d_union), and, as in the JAX
package, plain tensor code rather than a kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from corenet_tpu_torch import kernels

# Launches of the CUDA kernel in this process. Incremented only where the
# kernel is launched, so a run can show that its path went through it.
launch_count = 0

_SIGNATURES = {
    "fgbg_sums_fwd": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int] + [ctypes.c_void_p] * 4, ctypes.c_int),
    "fgbg_sums_error_string": ([ctypes.c_int], ctypes.c_char_p),
}
# The kernel's type codes.
_DIFF_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_GT_TYPES = {torch.int32: 0, torch.uint8: 1, torch.float32: 2}
# Blocks of the streaming pass for all scenes together: about four waves
# of 256-thread blocks on the H100's 132 SMs.
_TARGET_BLOCKS = 1024
_THREADS = 256


def fgbg_sums_reference(diff: torch.Tensor, gt: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The plain version: sigmoid in f32, where, and a sum per scene in f64,
  rounded to f32 once, as the kernel sums its partials. (An f32 sum parts
  from the kernel's in the last bits; in a bf16 training step that moves
  the rounding of the logits' gradient, which the backward carries on.)"""
  b = diff.shape[0]
  pred = torch.sigmoid(diff.float()).reshape(b, -1)
  fg = (gt == 1).reshape(b, -1)
  inter = torch.where(fg, pred, 0.0).sum(dim=1, dtype=torch.float64)
  union = torch.where(fg, 1.0, pred).sum(dim=1, dtype=torch.float64)
  return inter.float(), union.float()


def _check(diff: torch.Tensor, gt: torch.Tensor):
  if diff.dtype not in _DIFF_TYPES:
    raise TypeError(f"diff must be float32 or bfloat16, got {diff.dtype}")
  if gt.dtype not in _GT_TYPES:
    raise TypeError(f"gt must be int32, uint8 or float32, got {gt.dtype}")
  if diff.dim() < 2 or gt.shape != diff.shape:
    raise ValueError(f"diff and gt must both be [B, ...], got "
                     f"{tuple(diff.shape)} and {tuple(gt.shape)}")
  if gt.device != diff.device:
    raise ValueError(f"gt is on {gt.device}, diff on {diff.device}")
  if diff.device.type not in ("cpu", "cuda"):
    raise ValueError(f"fgbg_sums runs on CPU or CUDA tensors, not "
                     f"{diff.device}")
  for name, t in (("diff", diff), ("gt", gt)):
    if not t.is_contiguous():
      raise ValueError(f"{name} must be contiguous")


def fgbg_sums_forward(diff: torch.Tensor, gt: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The sums without autograd: the CUDA kernel on the current stream for
  a CUDA input, the plain version for a CPU one."""
  device = diff.device
  if device.type == "cpu":
    return fgbg_sums_reference(diff, gt)
  b = diff.shape[0]
  n = diff.numel() // b
  inter = torch.empty(b, dtype=torch.float32, device=device)
  union = torch.empty(b, dtype=torch.float32, device=device)
  if n == 0:
    return inter.zero_(), union.zero_()
  blocks = max(1, min(-(-n // (4 * _THREADS)), _TARGET_BLOCKS // b))
  partials = torch.empty((b, blocks, 2), dtype=torch.float64, device=device)
  lib = kernels.library("fgbg_sums", _SIGNATURES)
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.fgbg_sums_fwd(diff.data_ptr(), _DIFF_TYPES[diff.dtype],
                            gt.data_ptr(), _GT_TYPES[gt.dtype], b, n, blocks,
                            partials.data_ptr(), inter.data_ptr(),
                            union.data_ptr(), stream)
  if err != 0:
    msg = lib.fgbg_sums_error_string(err).decode()
    raise RuntimeError(f"fgbg_sums kernel launch failed: CUDA error {err} "
                       f"({msg})")
  global launch_count
  launch_count += 1
  return inter, union


class FgbgSums(torch.autograd.Function):
  """The sums, differentiable in diff. The forward looks up the module's
  `fgbg_sums_forward` at call time; the backward is elementwise."""

  @staticmethod
  def forward(ctx, diff, gt):
    ctx.save_for_backward(diff, gt)
    return fgbg_sums_forward(diff, gt)

  @staticmethod
  def backward(ctx, d_inter, d_union):
    diff, gt = ctx.saved_tensors
    shape = (diff.shape[0],) + (1,) * (diff.dim() - 1)
    s = torch.sigmoid(diff.float())
    sel = torch.where(gt == 1, d_inter.reshape(shape), d_union.reshape(shape))
    return (sel * s * (1.0 - s)).to(diff.dtype), None


def fgbg_sums(diff: torch.Tensor,  # float32 or bfloat16 [B, ...]
              gt: torch.Tensor,    # int32, uint8 or exact-0/1 float32
              ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Per-scene (intersection, union) soft-IoU sums, f32 [B] each;
  differentiable in diff. Any element count per scene.

  A CUDA input launches the kernel on the current stream, or raises: it
  never takes the plain version. A CPU input takes the plain version."""
  _check(diff, gt)
  return FgbgSums.apply(diff, gt)


def use_fgbg_kernel(logits: torch.Tensor,
                    weights: Optional[torch.Tensor]) -> bool:
  """Whether iou_fgbg takes the sums: two classes and no weights. (The
  JAX package's further rule, 1024 | voxels per scene, was a TPU tiling
  limit.)"""
  return weights is None and logits.shape[-1] == 2
