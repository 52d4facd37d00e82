"""The ray-traced skip connection's pixel gather: a CUDA kernel for CUDA
tensors, its plain PyTorch version for CPU tensors.

Counterpart of corenet_tpu/ops/skip_gather.py::skip_gather (forward). The
kernel is `csrc/skip_gather.cu`; its note says what bounds it and how it
is laid out. The backward (the TPU kernel's `_bwd_kernel`, a scatter-add)
comes with the training step: until then a CUDA input that requires grad
is refused rather than differentiated through another path.
"""

from __future__ import annotations

import ctypes

import torch

from corenet_tpu_torch import kernels

# Launches of the CUDA kernel in this process. Incremented only where the
# kernel is launched, so a run can show that its path went through it.
launch_count = 0

_SIGNATURES = {
    "skip_gather_fwd": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p], ctypes.c_int),
    "skip_gather_error_string": ([ctypes.c_int], ctypes.c_char_p),
}
_DTYPES = (torch.float32, torch.bfloat16)


def skip_gather_reference(fmap_padded: torch.Tensor, px: torch.Tensor,
                          py: torch.Tensor) -> torch.Tensor:
  """The plain version: one flat `torch.gather` over py * W2 + px."""
  b, h2, w2, c = fmap_padded.shape
  flat = fmap_padded.reshape(b, h2 * w2, c)
  idx = (py.long() * w2 + px.long())[:, :, None].expand(-1, -1, c)
  return torch.gather(flat, 1, idx)


def _check(fmap_padded: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
  if fmap_padded.dim() != 4:
    raise ValueError(f"fmap_padded must be [B, H2, W2, C], got "
                     f"{tuple(fmap_padded.shape)}")
  if fmap_padded.dtype not in _DTYPES:
    raise TypeError(f"fmap_padded must be float32 or bfloat16, got "
                    f"{fmap_padded.dtype}")
  b = fmap_padded.shape[0]
  for name, t in (("px", px), ("py", py)):
    if t.dtype != torch.int32:
      raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != b or t.shape != px.shape:
      raise ValueError(f"px and py must both be [B={b}, N], got "
                       f"{tuple(px.shape)} and {tuple(py.shape)}")
    if t.device != fmap_padded.device:
      raise ValueError(f"{name} is on {t.device}, fmap_padded on "
                       f"{fmap_padded.device}")
  for name, t in (("fmap_padded", fmap_padded), ("px", px), ("py", py)):
    if not t.is_contiguous():
      raise ValueError(f"{name} must be contiguous")


def skip_gather(fmap_padded: torch.Tensor,  # [B, H2, W2, C] f32 or bf16
                px: torch.Tensor,           # [B, N] int32, in [0, W2)
                py: torch.Tensor,           # [B, N] int32, in [0, H2)
                ) -> torch.Tensor:
  """Gathers fmap_padded[b, py, px, :] for each index pair → [B, N, C] in
  fmap_padded's dtype.

  A CUDA input launches the kernel on the current stream, or raises: it
  never takes the plain version. A CPU input takes the plain version."""
  _check(fmap_padded, px, py)
  device = fmap_padded.device
  if device.type == "cpu":
    return skip_gather_reference(fmap_padded, px, py)
  if device.type != "cuda":
    raise ValueError(f"skip_gather runs on CPU or CUDA tensors, not {device}")
  if fmap_padded.requires_grad:
    raise RuntimeError(
        "skip_gather has no CUDA backward yet; run it under "
        "torch.inference_mode() or torch.no_grad()")
  b, h2, w2, c = fmap_padded.shape
  n = px.shape[1]
  out = torch.empty((b, n, c), dtype=fmap_padded.dtype, device=device)
  if out.numel() == 0:
    return out
  lib = kernels.library("skip_gather", _SIGNATURES)
  elem = fmap_padded.element_size()
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.skip_gather_fwd(fmap_padded.data_ptr(), px.data_ptr(),
                              py.data_ptr(), out.data_ptr(), b, n, h2, w2,
                              c * elem, elem, stream)
  if err != 0:
    msg = lib.skip_gather_error_string(err).decode()
    raise RuntimeError(f"skip_gather kernel launch failed: CUDA error "
                       f"{err} ({msg})")
  global launch_count
  launch_count += 1
  return out
