"""Bit-packed voxel grids: z-column occupancy as 32-bit words, and a packed
interior flood fill.

Counterpart of corenet_tpu/voxel/packed.py. Layout: `packed` [..., H, W,
NW] where bit b of word w at (y, x) is the occupancy of voxel
z = 32·w + b (NW = D / 32).

The words are int32 tensors holding the JAX package's uint32 bit patterns
(`.view(np.uint32)` of a numpy copy gives them back): torch's uint32 lacks
shifts and arithmetic on the CPU. int32 `>>` copies the sign bit, so
every right shift of a word whose bit 31 can be set goes through
`shift_right`, a logical shift. `<<`, `&`, `|`, `~` and the wrapping
`+ 1` / `- 1` of two's-complement int32 give the uint32 bits unchanged.

`fill_inside_packed` fills the empty regions that are not 6-connected to
the grid's boundary (the reference's fill_voxels_cpu.cc:74-155): output
bit = 1 where occupied or enclosed.
"""

from __future__ import annotations

from typing import Optional

import torch

# Rounds of the adaptive fill run in this process (the fixpoint reads one
# flag from the device per round).
round_count = 0


def as_int32(word: int) -> int:
  """The int32 value of the 32-bit pattern `word` (0 ≤ word < 2³²)."""
  return word - (1 << 32) if word >= 1 << 31 else word


def shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
  """Logical right shift of int32 words by a constant k ∈ [0, 31]."""
  if k == 0:
    return x
  return (x >> k) & ((1 << (32 - k)) - 1)


def pack_grid(grid: torch.Tensor) -> torch.Tensor:
  """numeric[..., D, H, W] (occupied iff > 0) → int32[..., H, W, D/32]."""
  d = grid.shape[-3]
  if d % 32:
    raise ValueError(f"depth {d} must be a multiple of 32")
  occ = torch.movedim(grid > 0, -3, -1)  # [..., H, W, D]
  occ = occ.reshape(occ.shape[:-1] + (d // 32, 32)).to(torch.int32)
  shifts = torch.arange(32, dtype=torch.int32, device=grid.device)
  # Distinct bits: their sum is their OR, and int32 sums wrap as uint32's.
  return (occ << shifts).sum(dim=-1, dtype=torch.int32)


def unpack_grid(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
  """int32[..., H, W, NW] → dtype[..., NW·32, H, W] of 0/1."""
  nw = packed.shape[-1]
  words = torch.movedim(packed, -1, -3)  # [..., NW, H, W]
  shifts = torch.arange(32, dtype=torch.int32,
                        device=packed.device).reshape(32, 1, 1)
  bits = (words[..., None, :, :] >> shifts) & 1  # [..., NW, 32, H, W]
  return bits.reshape(bits.shape[:-4] + (nw * 32,) +
                      bits.shape[-2:]).to(dtype)


def _trailing_ones(e: torch.Tensor) -> torch.Tensor:
  """Mask of the run of 1-bits starting at bit 0: ((e + 1) & ~e) − 1,
  wrapping as uint32 does (e = all ones gives all ones)."""
  return ((e + 1) & ~e) - 1


def _leading_ones(e: torch.Tensor) -> torch.Tensor:
  """Mask of the run of 1-bits ending at bit 31."""
  x = e
  for k, top in ((1, 0x80000000), (2, 0xC0000000), (4, 0xF0000000),
                 (8, 0xFF000000), (16, 0xFFFF0000)):
    x = x & (shift_right(x, k) | as_int32(top))
  return x


def _kog_up(r: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
  """Segmented Kogge-Stone, LSB → MSB: bit i set iff some j ≤ i has r[j]
  and e[k] for all j ≤ k ≤ i. Assumes r ⊆ e."""
  f = e
  for k in (1, 2, 4, 8, 16):
    r = r | ((r << k) & f)
    f = f & (f << k)
  return r


def _kog_down(r: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
  """Segmented Kogge-Stone, MSB → LSB."""
  f = e
  for k in (1, 2, 4, 8, 16):
    r = r | (shift_right(r, k) & f)
    f = f & shift_right(f, k)
  return r


def shift_along(x: torch.Tensor, dim: int, s: int,
                down: bool) -> torch.Tensor:
  """x moved by s along dim, zeros shifted in: value i comes from i − s
  (down) or i + s."""
  n = x.shape[dim]
  zeros = torch.zeros_like(x.narrow(dim, 0, s))
  if down:
    return torch.cat([zeros, x.narrow(dim, 0, n - s)], dim=dim)
  return torch.cat([x.narrow(dim, s, n - s), zeros], dim=dim)


def _sweep_spatial(r: torch.Tensor, e: torch.Tensor, dim: int,
                   down: bool) -> torch.Tensor:
  """Gated prefix-OR along a spatial (unpacked) dim by log-doubling; the
  bitwise ops act on all 32 z-lanes of a word at once."""
  n = r.shape[dim]
  f = e
  shift = 1
  while shift < n:
    r = r | (shift_along(r, dim, shift, down) & f)
    f = f & shift_along(f, dim, shift, down)
    shift *= 2
  return r


def _sweep_z(r: torch.Tensor, e: torch.Tensor, up: bool) -> torch.Tensor:
  """Gated prefix-OR along z (the packed axis): Kogge-Stone inside each
  word and a carry chain across the NW words."""
  nw = r.shape[-1]
  zero = torch.zeros((), dtype=r.dtype, device=r.device)
  words_e = list(e.unbind(-1))
  if up:
    words_r = list(_kog_up(r, e).unbind(-1))
    for w in range(1, nw):
      carry = shift_right(words_r[w - 1], 31)  # bit 31 reached
      spread = torch.where(carry > 0, _trailing_ones(words_e[w]), zero)
      words_r[w] = _kog_up(words_r[w] | spread, words_e[w])
    return torch.stack(words_r, dim=-1)
  words_r = list(_kog_down(r, e).unbind(-1))
  for w in range(nw - 2, -1, -1):
    carry = words_r[w + 1] & 1
    spread = torch.where(carry > 0, _leading_ones(words_e[w]), zero)
    words_r[w] = _kog_down(words_r[w] | spread, words_e[w])
  return torch.stack(words_r, dim=-1)


def fill_inside_packed(packed: torch.Tensor,
                       fill_rounds: Optional[int] = None) -> torch.Tensor:
  """Interior fill of int32[..., H, W, NW] occupancy words.

  fill_rounds: None runs rounds until one changes nothing (the adaptive
  fixpoint; each round reads one flag from the device, and adds one to
  `round_count`); an int runs exactly that many rounds.

  Returns int32[..., H, W, NW]: bit = 1 where occupied or enclosed."""
  global round_count
  if packed.dim() < 3:
    raise ValueError(f"packed must be [..., H, W, NW], got "
                     f"{tuple(packed.shape)}")
  e = ~packed  # empty bits
  h, w, nw = packed.shape[-3:]
  dev = packed.device

  # Boundary seeds: the z = 0 and z = D − 1 bits, the y and x boundary
  # rows. (Built with kernels only, no host copies, so that a CUDA graph
  # can capture the fill.)
  word = torch.arange(nw, device=dev)
  zmask = (torch.where(word == 0, 1, 0)
           | torch.where(word == nw - 1, as_int32(0x80000000), 0))
  y = torch.arange(h, device=dev)[:, None, None]
  x = torch.arange(w, device=dev)[:, None]
  edge = (y == 0) | (y == h - 1) | (x == 0) | (x == w - 1)
  seed = (e & zmask.to(torch.int32)) | torch.where(edge, e, 0)

  y_dim, x_dim = packed.dim() - 3, packed.dim() - 2

  def round_fn(outside):
    outside = outside | _sweep_z(outside, e, up=True)
    outside = outside | _sweep_z(outside, e, up=False)
    for dim in (y_dim, x_dim):
      for down in (False, True):
        outside = outside | (e & _sweep_spatial(outside, e, dim, down))
    return outside

  outside = seed
  if fill_rounds is not None:
    for _ in range(fill_rounds):
      outside = round_fn(outside)
    return ~outside
  while True:
    new = round_fn(outside)
    round_count += 1
    changed = bool((new != outside).any())
    outside = new
    if not changed:
      return ~outside
