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
the step.

Statistics are taken over the global batch, as the JAX package takes
them over its sharded batch: under a process group (parallel/mesh.py)
each rank reduces its shard to per-channel means, folded when packed,
and `mesh.mean_over_ranks` averages them over the ranks, an all-reduce
whose backward carries the gradient across ranks. Float32 makes two
reduces (the mean, then the variance around it), bf16 one (both shifted
moments as one [2, C] tensor); so a train-mode layer launches 4 or 2
all-reduces per step, its backward's included. The mean of per-rank
means is the global mean only for shards of equal size: each layer
checks that its count per channel is the same on every rank, once per
count it sees. Without a group nothing is reduced.

Activations may be float32 or bfloat16. The statistics are float32 either
way; the elementwise passes run in the input's dtype, with the
per-channel vectors cast to it. For bfloat16 inputs train mode takes the
JAX package's shifted one-pass statistics, E[(x − c)²] − E[x − c]² with
c the running mean (no gradient), clamped at 0: the shift keeps the
subtraction free of cancellation when the variance is far below the
squared mean. Float32 keeps the two-pass form.

Packed (space-to-depth) activations, `phase_packing` P = 8
(models/packing.py), have P·C channels, phase-major. Statistics are reduced
per packed channel, folded to the fine channels (the phase mean: phases
hold equal counts, so it is the joint mean), and the per-channel vectors
are tiled back; parameters and running statistics stay per fine channel,
so a packed layer has the fine layer's state.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from corenet_tpu_torch.parallel import mesh

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
               phase_packing: int = 1,
               device: Optional[torch.device] = None):
    super().__init__()
    self.eps = eps
    self.num_channels = num_channels
    self.phase_packing = phase_packing
    self.scale = nn.Parameter(torch.ones(num_channels, device=device))
    self.bias = nn.Parameter(torch.zeros(num_channels, device=device))
    self.register_buffer("mean", torch.zeros(num_channels, device=device))
    self.register_buffer("var", torch.ones(num_channels, device=device))
    self.register_buffer("steps",
                         torch.zeros((), dtype=torch.int32, device=device))
    self._checked_count = None  # the count per channel checked across ranks

  @torch.no_grad()
  def reset_parameters(self, generator: Optional[torch.Generator] = None
                       ) -> None:
    del generator  # the initial state is constant
    self.scale.fill_(1.0)
    self.bias.zero_()
    self.mean.zero_()
    self.var.fill_(1.0)
    self.steps.zero_()

  def _fold(self, v: torch.Tensor) -> torch.Tensor:
    """Per packed channel [P·C] → per fine channel [C]."""
    p = self.phase_packing
    return v if p == 1 else v.view(p, -1).mean(0)

  def _tile(self, v: torch.Tensor) -> torch.Tensor:
    """Per fine channel [C] → per packed channel [P·C]."""
    p = self.phase_packing
    return v if p == 1 else v.repeat(p)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    shape = (1, -1) + (1,) * (x.dim() - 2)

    def tile(v):  # a per-channel vector, tiled, then cast to x's dtype
      return self._tile(v).to(x.dtype).view(shape)

    if self.training:
      scale_eff, shift_eff = self._train_statistics(x)
      y = x * tile(scale_eff) + tile(shift_eff)
    else:
      inv = 1.0 / torch.sqrt(self.var + self.eps)
      y = x * tile(inv) + tile(-self.mean * inv)
    return y * tile(self.scale) + tile(self.bias)

  def _train_statistics(self, x: torch.Tensor):
    """(r/σ_B, d − μ_B·r/σ_B) per fine channel in float32, then the
    running-statistics update."""
    if x.dtype not in (torch.float32, torch.bfloat16):
      raise NotImplementedError(
          f"BatchRenorm train mode takes float32 or bfloat16, got {x.dtype}")
    nt = self.steps.float()
    s = float(_RAMP_START)
    d_max = torch.clamp(5.0 * (nt - s) / 20000.0, 0.0, 5.0)
    r_max = 1.0 + torch.clamp(2.0 * (nt - s) / 35000.0, 0.0, 2.0)

    shape = (1, -1) + (1,) * (x.dim() - 2)
    dims = (0,) + tuple(range(2, x.dim()))
    fold = self._fold
    if mesh.is_initialized():
      count = x.numel() // x.shape[1]
      if count != self._checked_count:
        mesh.assert_equal_across_ranks(count,
                                       "BatchRenorm's count per channel")
        self._checked_count = count
    if x.dtype == torch.bfloat16:
      shift = self.mean  # no gradient: a buffer; the same on every rank
      xf = x.float() - self._tile(shift).view(shape)
      moments = (fold(xf.mean(dim=dims)),
                 fold(torch.square(xf).mean(dim=dims)))
      if mesh.is_initialized():
        moments = mesh.mean_over_ranks(torch.stack(moments)).unbind()
      m_shift, mean_square = moments
      b_mean = m_shift + shift
      b_var = torch.clamp(mean_square - torch.square(m_shift), min=0.0)
    else:
      b_mean = mesh.mean_over_ranks(fold(x.mean(dim=dims)))
      b_var = mesh.mean_over_ranks(fold(
          torch.square(x - self._tile(b_mean).view(shape)).mean(dim=dims)))
    b_std = torch.sqrt(b_var + self.eps)

    running_std = torch.sqrt(self.var + self.eps)
    r = torch.clamp(b_std.detach() / running_std, 1.0 / r_max, r_max)
    d = torch.clamp((b_mean.detach() - self.mean) / running_std, -d_max,
                    d_max)
    scale_eff = r / b_std
    shift_eff = d - b_mean * r / b_std

    with torch.no_grad():
      c = self.num_channels
      unbiased_var = b_var * c / (c - 1)
      self.var += _MOMENTUM * (unbiased_var - self.var)
      self.mean += _MOMENTUM * (b_mean - self.mean)
      self.steps += 1
    return scale_eff, shift_eff
