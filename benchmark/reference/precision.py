"""The controls' lower precisions, as roundings of a layer's operands.

A control is the reference computed one step below the precision that the
configuration states: TF32 for float32 with TF32 off (serving), and fp8
for bf16 (training). Each is written as the rounding that the lower
precision applies to a product's operands, with the accumulation left in
float32 as the tensor cores keep it, so that the control reads the same on
the CPU and on the card.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def tf32(t: torch.Tensor) -> torch.Tensor:
  """float32 rounded to TF32's 10 mantissa bits, to nearest (ties away)."""
  bits = t.float().contiguous().view(torch.int32)
  bits = (bits + 0x1000) & ~0x1FFF
  return bits.view(torch.float32).to(t.dtype)


def fp8(t: torch.Tensor) -> torch.Tensor:
  """t rounded to float8 e4m3 under one scale for the whole tensor, its
  largest magnitude mapped to the format's largest value, and back. The
  gradient passes the rounding unchanged (the product's backward still
  reads the rounded operands)."""
  scale = t.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
  q = (t.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
  return t + (q.to(t.dtype) - t).detach()


CONTROLS = {"tf32": tf32, "fp8": fp8}
