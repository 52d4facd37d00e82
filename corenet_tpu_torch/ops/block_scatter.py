"""OR-scatter of per-triangle packed voxel blocks into bit-packed grids: a
CUDA kernel for CUDA tensors, its plain PyTorch version for CPU tensors.

Counterpart of corenet_tpu/ops/block_scatter.py::block_scatter_or, phase
B of the blocked rasterizer (voxel/raster_fast.py). For each triangle
with origins[b, t] = (slot·H + oy)·W + ox ≥ 0, its 8 × (8·NW) block of
z-words pw[b, t] (lane dx·NW + w) is ORed into out[b, slot, oy + dy,
(ox + dx)·NW + w] of a zeroed int32[B, M, H, W·NW] (voxel/packed.py's
layout once reshaped to [B, M, H, W, NW]). Origins of −1, and origins
whose block would leave the grid, are skipped. The words are int32
holding uint32 bit patterns. The kernel is `csrc/block_scatter.cu`; its
note says what bounds it and how it is laid out. The result is exact.
"""

from __future__ import annotations

import ctypes

import torch

from corenet_tpu_torch import kernels

DB = 8  # voxel block extent per axis

# Launches of the CUDA kernel in this process. Incremented only where the
# kernel is launched, so a run can show that its path went through it.
launch_count = 0

_SIGNATURES = {
    "block_scatter_or_fwd": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                             + [ctypes.c_void_p], ctypes.c_int),
    "block_scatter_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def _target_index(origins: torch.Tensor, *, meshes: int, h: int, w: int,
                  nw: int):
  """The flat index into out of every pw word, and whether its triangle
  is scattered (origin ≥ 0 and its block inside the grid)."""
  b = origins.shape[0]
  dev = origins.device
  o = origins.long()
  ox, oy, slot = o % w, (o // w) % h, o // (w * h)
  ok = (o >= 0) & (slot < meshes) & (oy <= h - DB) & (ox <= w - DB)
  row0 = (torch.arange(b, device=dev)[:, None] * meshes + slot) * h + oy
  rows = torch.arange(DB, device=dev)[:, None]
  lanes = torch.arange(DB * nw, device=dev)
  index = ((row0[..., None, None] + rows) * (w * nw)
           + ox[..., None, None] * nw + lanes)  # [B, T, 8, 8·NW]
  return torch.where(ok[..., None, None], index, 0), ok


def block_scatter_or_reference(origins: torch.Tensor, pw: torch.Tensor, *,
                               meshes: int, h: int, w: int,
                               nw: int) -> torch.Tensor:
  """The plain version: each of the 32 bit planes scattered with amax (the
  OR of bits), then repacked."""
  b = origins.shape[0]
  index, ok = _target_index(origins, meshes=meshes, h=h, w=w, nw=nw)
  index = index.reshape(-1)
  words = torch.where(ok[..., None, None], pw, 0).reshape(-1)
  size = b * meshes * h * w * nw
  out = torch.zeros(size, dtype=torch.int32, device=pw.device)
  for bit in range(32):
    plane = ((words >> bit) & 1).to(torch.uint8)
    hit = torch.zeros(size, dtype=torch.uint8, device=pw.device)
    hit.scatter_reduce_(0, index, plane, "amax")
    out |= hit.to(torch.int32) << bit
  return out.reshape(b, meshes, h, w * nw)


def _check(origins: torch.Tensor, pw: torch.Tensor, meshes: int, h: int,
           w: int, nw: int):
  if origins.dtype != torch.int32 or pw.dtype != torch.int32:
    raise TypeError(f"origins and pw must be int32, got {origins.dtype} and "
                    f"{pw.dtype}")
  if origins.dim() != 2 or pw.shape != origins.shape + (DB, DB * nw):
    raise ValueError(f"origins must be [B, T] and pw [B, T, {DB}, {DB * nw}]"
                     f", got {tuple(origins.shape)} and {tuple(pw.shape)}")
  if min(meshes, h - DB + 1, w - DB + 1, nw) <= 0:
    raise ValueError(f"bad grid: meshes {meshes}, h {h}, w {w}, nw {nw}")
  if pw.device != origins.device:
    raise ValueError(f"pw is on {pw.device}, origins on {origins.device}")
  if origins.device.type not in ("cpu", "cuda"):
    raise ValueError(f"block_scatter_or runs on CPU or CUDA tensors, not "
                     f"{origins.device}")
  for name, t in (("origins", origins), ("pw", pw)):
    if not t.is_contiguous():
      raise ValueError(f"{name} must be contiguous")


def block_scatter_or_forward(origins: torch.Tensor, pw: torch.Tensor, *,
                             meshes: int, h: int, w: int,
                             nw: int) -> torch.Tensor:
  """The scatter on checked inputs: the CUDA kernel on the current stream
  for a CUDA input, the plain version for a CPU one."""
  if origins.device.type == "cpu":
    return block_scatter_or_reference(origins, pw, meshes=meshes, h=h, w=w,
                                      nw=nw)
  b, t = origins.shape
  out = torch.zeros((b, meshes, h, w * nw), dtype=torch.int32,
                    device=origins.device)
  if t == 0:
    return out
  lib = kernels.library("block_scatter", _SIGNATURES)
  with torch.cuda.device(origins.device):
    stream = torch.cuda.current_stream(origins.device).cuda_stream
    err = lib.block_scatter_or_fwd(origins.data_ptr(), pw.data_ptr(),
                                   out.data_ptr(), b, t, meshes, h, w, nw,
                                   stream)
  if err != 0:
    msg = lib.block_scatter_error_string(err).decode()
    raise RuntimeError(f"block_scatter_or kernel launch failed: CUDA error "
                       f"{err} ({msg})")
  global launch_count
  launch_count += 1
  return out


def block_scatter_or(origins: torch.Tensor,  # int32[B, T]
                     pw: torch.Tensor,       # int32[B, T, 8, 8·NW]
                     *,
                     meshes: int,
                     h: int,
                     w: int,
                     nw: int) -> torch.Tensor:
  """Returns int32[B, meshes, h, w·nw], the OR of every block at its
  origin into zeroed grids. Looks up `block_scatter_or_forward` at call
  time.

  A CUDA input launches the kernel on the current stream, or raises: it
  never takes the plain version. A CPU input takes the plain version."""
  _check(origins, pw, meshes, h, w, nw)
  return block_scatter_or_forward(origins, pw, meshes=meshes, h=h, w=w,
                                  nw=nw)
