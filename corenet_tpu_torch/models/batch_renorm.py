"""Batch renormalization, inference mode.

Counterpart of corenet_tpu/models/batch_renorm.py with the same parameter
and statistic names: parameters `scale`, `bias`; buffers `mean`, `var`
(float32) and `steps` (int32). In eval mode it normalizes with the running
statistics, in the JAX package's order of operations:

  y = (x · inv − mean · inv) · scale + bias,  inv = 1 / √(var + eps).

Train mode (the r/d ramps and the running-variance quirk) belongs to the
training step, which the port does not have yet; a module in train mode
raises instead of normalizing some other way.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


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
    if self.training:
      raise NotImplementedError(
          "BatchRenorm train mode is not ported yet; call .eval()")
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = 1.0 / torch.sqrt(self.var + self.eps)
    y = x * inv.view(shape) + (-self.mean * inv).view(shape)
    return y * self.scale.view(shape) + self.bias.view(shape)
