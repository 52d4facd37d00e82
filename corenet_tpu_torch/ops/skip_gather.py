"""The ray-traced skip connection's pixel gather and its gradient: CUDA
kernels for CUDA tensors, their plain PyTorch versions for CPU tensors.

Counterpart of corenet_tpu/ops/skip_gather.py::skip_gather, forward and
backward. Both kernels are in `csrc/skip_gather.cu`; its note says what
bounds them and how they are laid out. `skip_gather` is differentiable in
the map through `SkipGather`, whose forward is `skip_gather_forward` and
whose backward is `skip_gather_backward`, a scatter-add with f32
accumulation that reads the gradient in whatever layout autograd hands
over; indices get no gradient.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from corenet_tpu_torch import kernels

# Launches of the forward and the backward CUDA kernel in this process.
# Incremented only where a kernel is launched, so a run can show that its
# path went through it.
launch_count = 0
backward_launch_count = 0

_SIGNATURES = {
    "skip_gather_fwd": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p], ctypes.c_int),
    "skip_gather_bwd": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                        + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3
                        + [ctypes.c_void_p], ctypes.c_int),
    "skip_gather_error_string": ([ctypes.c_int], ctypes.c_char_p),
}
_DTYPES = (torch.float32, torch.bfloat16)
GridResolution = Tuple[int, int, int]


def skip_gather_reference(fmap_padded: torch.Tensor, px: torch.Tensor,
                          py: torch.Tensor) -> torch.Tensor:
  """The plain version: one flat `torch.gather` over py * W2 + px."""
  b, h2, w2, c = fmap_padded.shape
  flat = fmap_padded.reshape(b, h2 * w2, c)
  idx = (py.long() * w2 + px.long())[:, :, None].expand(-1, -1, c)
  return torch.gather(flat, 1, idx)


def skip_gather_backward_reference(dout: torch.Tensor, px: torch.Tensor,
                                   py: torch.Tensor, h2: int, w2: int
                                   ) -> torch.Tensor:
  """The plain version of the gradient: `index_add_` of dout ([B, N, C],
  or [B, P, N/P, C] for P phases) over the flat b·H2·W2 + py·W2 + px
  index into a zeroed f32 buffer, cast to dout's dtype."""
  dout = dout.reshape(dout.shape[0], -1, dout.shape[-1])
  b, n, c = dout.shape
  base = torch.arange(b, device=dout.device)[:, None] * (h2 * w2)
  flat = (base + py.long() * w2 + px.long()).reshape(-1)
  acc = torch.zeros((b * h2 * w2, c), dtype=torch.float32,
                    device=dout.device)
  acc.index_add_(0, flat, dout.reshape(b * n, c).float())
  return acc.reshape(b, h2, w2, c).to(dout.dtype)


def _check_indices(b: int, device: torch.device, px: torch.Tensor,
                   py: torch.Tensor):
  for name, t in (("px", px), ("py", py)):
    if t.dtype != torch.int32:
      raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != b or t.shape != px.shape:
      raise ValueError(f"px and py must both be [B={b}, N], got "
                       f"{tuple(px.shape)} and {tuple(py.shape)}")
    if t.device != device:
      raise ValueError(f"{name} is on {t.device}, the features on {device}")
    if not t.is_contiguous():
      raise ValueError(f"{name} must be contiguous")


def _check(fmap_padded: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
  if fmap_padded.dim() != 4:
    raise ValueError(f"fmap_padded must be [B, H2, W2, C], got "
                     f"{tuple(fmap_padded.shape)}")
  if fmap_padded.dtype not in _DTYPES:
    raise TypeError(f"fmap_padded must be float32 or bfloat16, got "
                    f"{fmap_padded.dtype}")
  if not fmap_padded.is_contiguous():
    raise ValueError("fmap_padded must be contiguous")
  _check_indices(fmap_padded.shape[0], fmap_padded.device, px, py)
  if fmap_padded.device.type not in ("cpu", "cuda"):
    raise ValueError(f"skip_gather runs on CPU or CUDA tensors, not "
                     f"{fmap_padded.device}")


def _raise_on(lib, err: int, what: str):
  if err != 0:
    msg = lib.skip_gather_error_string(err).decode()
    raise RuntimeError(f"skip_gather {what} kernel launch failed: CUDA error "
                       f"{err} ({msg})")


def skip_gather_forward(fmap_padded: torch.Tensor, px: torch.Tensor,
                        py: torch.Tensor) -> torch.Tensor:
  """The gather without autograd: the CUDA kernel on the current stream
  for a CUDA input, the plain version for a CPU one."""
  device = fmap_padded.device
  if device.type == "cpu":
    return skip_gather_reference(fmap_padded, px, py)
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
  _raise_on(lib, err, "forward")
  global launch_count
  launch_count += 1
  return out


def channel_vector(c: int) -> int:
  """Channels per vector atomic of the backward kernel: the widest of 4,
  2, 1 that divides C."""
  return 4 if c % 4 == 0 else 2 if c % 2 == 0 else 1


def columns(n: int, grid_resolution: GridResolution) -> Tuple[int, int]:
  """(depth, columns) of n voxels in (z, y, x) order: (D, H·W) for a
  (D, H, W) grid. Voxels without column structure are the grid (1, 1, n):
  every voxel its own column."""
  d, h, w = grid_resolution
  if min(d, h, w) <= 0 or d * h * w != n:
    raise ValueError(f"grid_resolution {tuple(grid_resolution)} does not "
                     f"hold the {n} voxels")
  return d, h * w


def z_chunk(depth: int) -> int:
  """Voxels along z that one thread of the backward kernel walks: a
  quarter of the column. Longer chunks end fewer runs at their ends but
  leave fewer threads to fill the card; a quarter was the fastest at all
  four h7 skips on the H100 (PERF.md)."""
  return max(1, depth // 4)


def skip_gather_backward(dout: torch.Tensor, px: torch.Tensor,
                         py: torch.Tensor, h2: int, w2: int,
                         grid_resolution: GridResolution) -> torch.Tensor:
  """d fmap_padded [B, H2, W2, C] in dout's dtype from dout [B, N, C], or
  [B, P, N/P, C] for voxels in P phases, of any strides: the CUDA kernel on
  the current stream for a CUDA input, the plain version for a CPU one.
  `grid_resolution` (D, H, W) says that voxel n of a phase is
  (z·H + y)·W + x, which lets the kernel sum along depth columns; (1, 1, N)
  for voxels in no such order."""
  if dout.dim() == 3:
    dout = dout[:, None]
  if dout.dim() != 4 or dout.dtype not in _DTYPES:
    raise ValueError(f"dout must be float32 or bfloat16 [B, N, C] or "
                     f"[B, P, N/P, C], got {dout.dtype} {tuple(dout.shape)}")
  b, phases, n, c = dout.shape
  _check_indices(b, dout.device, px, py)
  if px.shape[1] != phases * n:
    raise ValueError(f"dout has {phases} x {n} voxels, the indices "
                     f"{px.shape[1]}")
  depth, cols = columns(n, grid_resolution)
  device = dout.device
  if device.type == "cpu":
    return skip_gather_backward_reference(dout, px, py, h2, w2)
  if device.type != "cuda":
    raise ValueError(f"skip_gather runs on CPU or CUDA tensors, not {device}")
  acc = torch.empty((b, h2, w2, c), dtype=torch.float32, device=device)
  dfmap = acc if dout.dtype == torch.float32 else torch.empty_like(
      acc, dtype=dout.dtype)
  if dout.numel() == 0:
    return dfmap.zero_()
  lib = kernels.library("skip_gather", _SIGNATURES)
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.skip_gather_bwd(dout.data_ptr(), px.data_ptr(), py.data_ptr(),
                              acc.data_ptr(), dfmap.data_ptr(), b, phases, n,
                              h2, w2, c, *dout.stride(), depth,
                              z_chunk(depth), dout.element_size(), stream)
  _raise_on(lib, err, "backward")
  global backward_launch_count
  backward_launch_count += 1
  return dfmap


class SkipGather(torch.autograd.Function):
  """The gather, differentiable in the map. Both directions look up the
  module's `skip_gather_forward` / `skip_gather_backward` at call time."""

  @staticmethod
  def forward(ctx, fmap_padded, px, py, grid_resolution, phases):
    ctx.save_for_backward(px, py)
    ctx.map_hw = tuple(fmap_padded.shape[1:3])
    ctx.grid_resolution = grid_resolution
    out = skip_gather_forward(fmap_padded, px, py)
    if phases == 1:
      return out
    # Split, never merged again: the gradient reaches the backward in the
    # layout of the consumer's own gradient, whatever its strides.
    return out.view(out.shape[0], phases, -1, out.shape[-1])

  @staticmethod
  def backward(ctx, dout):
    # dout comes as autograd gives it, usually a channel slice of the
    # decoder's concatenated gradient; the kernel reads any strides.
    px, py = ctx.saved_tensors
    return (skip_gather_backward(dout, px, py, *ctx.map_hw,
                                 grid_resolution=ctx.grid_resolution),
            None, None, None, None)


def skip_gather(fmap_padded: torch.Tensor,  # [B, H2, W2, C] f32 or bf16
                px: torch.Tensor,           # [B, N] int32, in [0, W2)
                py: torch.Tensor,           # [B, N] int32, in [0, H2)
                grid_resolution: GridResolution,
                phases: int = 1,
                ) -> torch.Tensor:
  """Gathers fmap_padded[b, py, px, :] for each index pair → [B, N, C] in
  fmap_padded's dtype; differentiable in fmap_padded. `grid_resolution`
  (D, H, W), where the N voxels are a grid in (z, y, x) order, lets the
  backward kernel sum along depth columns; (1, 1, N) for voxels in no such
  order. With `phases` P > 1 the voxels are P such grids, one after
  another (the packed decoder's skips), and the result is
  [B, P, N/P, C].

  A CUDA input launches the kernels (forward, and backward when a
  gradient flows) on the current stream, or raises: it never takes the
  plain versions. A CPU input takes the plain versions."""
  _check(fmap_padded, px, py)
  if phases < 1 or px.shape[1] % phases:
    raise ValueError(f"{px.shape[1]} voxels do not split into {phases} "
                     "phases")
  columns(px.shape[1] // phases, grid_resolution)
  return SkipGather.apply(fmap_padded, px, py, grid_resolution, phases)
