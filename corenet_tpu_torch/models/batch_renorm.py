"""Batch renormalization (Ioffe 2017).

Counterpart of corenet_tpu/models/batch_renorm.py with the same parameter
and statistic names: parameters `scale`, `bias`; buffers `mean`, `var`
(float32) and `steps` (int32).

Eval mode normalizes with the running statistics, in the JAX package's
order of operations:

  y = (x · inv − mean · inv) · scale + bias,  inv = 1 / √(var + eps).

Train mode (`module.train()`) normalizes with the batch statistics,
corrected by r and d, whose clips ramp with the `steps` counter from the
ramp start (r_max → 3 over steps s..s+35k, d_max → 5 over s..s+20k):

  y = (x · r/σ_B + d − μ_B · r/σ_B) · scale + bias,
  r = clip(sg(σ_B)/σ, 1/r_max, r_max),  d = clip((sg(μ_B) − μ)/σ, ±d_max)

where sg stops the gradient, σ = √(var + eps) and σ_B = √(var_B + eps)
with the biased batch variance. It then updates the running statistics
with momentum 0.01, "unbiasing" the variance by channels/(channels − 1)
(the reference model's quirk, kept for its training dynamics), and counts
the step. Statistics are taken over this process's batch. Float32 only:
the bf16 one-pass variance comes with the bf16 port.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

# Step at which the r/d clips start to open (the reference's 5000).
# Process-wide, shared by every layer, as in the JAX package; read at each
# train-mode call.
_RAMP_START = 5000
_MOMENTUM = 0.01


def set_ramp_start(steps: int) -> None:
  global _RAMP_START
  _RAMP_START = int(steps)


def ramp_start() -> int:
  return _RAMP_START


class BatchRenorm(nn.Module):
  """Normalizes channel dim 1 of (N, C, spatial...) inputs. eps = 1e-3 is
  what every CoreNet layer uses."""

  def __init__(self, num_channels: int, eps: float = 1e-3,
               device: Optional[torch.device] = None):
    super().__init__()
    self.eps = eps
    self.scale = nn.Parameter(torch.ones(num_channels, device=device))
    self.bias = nn.Parameter(torch.zeros(num_channels, device=device))
    self.register_buffer("mean", torch.zeros(num_channels, device=device))
    self.register_buffer("var", torch.ones(num_channels, device=device))
    self.register_buffer("steps",
                         torch.zeros((), dtype=torch.int32, device=device))

  @torch.no_grad()
  def reset_parameters(self, generator: Optional[torch.Generator] = None
                       ) -> None:
    del generator  # the initial state is constant
    self.scale.fill_(1.0)
    self.bias.zero_()
    self.mean.zero_()
    self.var.fill_(1.0)
    self.steps.zero_()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if self.training:
      scale_eff, shift_eff = self._train_statistics(x)
      y = x * scale_eff.view(shape) + shift_eff.view(shape)
    else:
      inv = 1.0 / torch.sqrt(self.var + self.eps)
      y = x * inv.view(shape) + (-self.mean * inv).view(shape)
    return y * self.scale.view(shape) + self.bias.view(shape)

  def _train_statistics(self, x: torch.Tensor):
    """(r/σ_B, d − μ_B·r/σ_B) per channel, then the running-statistics
    update."""
    if x.dtype != torch.float32:
      raise NotImplementedError(
          f"BatchRenorm train mode is ported for float32 only, got {x.dtype}")
    nt = self.steps.float()
    s = float(_RAMP_START)
    d_max = torch.clamp(5.0 * (nt - s) / 20000.0, 0.0, 5.0)
    r_max = 1.0 + torch.clamp(2.0 * (nt - s) / 35000.0, 0.0, 2.0)

    shape = (1, -1) + (1,) * (x.dim() - 2)
    dims = (0,) + tuple(range(2, x.dim()))
    b_mean = x.mean(dim=dims)
    b_var = torch.square(x - b_mean.view(shape)).mean(dim=dims)
    b_std = torch.sqrt(b_var + self.eps)

    running_std = torch.sqrt(self.var + self.eps)
    r = torch.clamp(b_std.detach() / running_std, 1.0 / r_max, r_max)
    d = torch.clamp((b_mean.detach() - self.mean) / running_std, -d_max,
                    d_max)
    scale_eff = r / b_std
    shift_eff = d - b_mean * r / b_std

    with torch.no_grad():
      c = x.shape[1]
      unbiased_var = b_var * c / (c - 1)
      self.var += _MOMENTUM * (unbiased_var - self.var)
      self.mean += _MOMENTUM * (b_mean - self.mean)
      self.steps += 1
    return scale_eff, shift_eff
