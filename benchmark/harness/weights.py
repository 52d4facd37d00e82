"""CoreNet weights from a seed, made on the device in a few large calls.

The shapes are the model's, listed here from its published architecture
(benchmark/reference/model.py's constants) under the state dict's keys;
the program loads the dict strictly, so a key or a shape it does not have
stops the run. Kernels are drawn as one normal tensor and one uniform
tensor and cut into leaves: the encoder's with He scaling (√(2/fan_in)),
the decoder's uniform in ±1/√fan_in (a transposed convolution's fan_in
counted over its output channels). BatchRenorm starts at scale 1, bias 0,
with running statistics drawn as mean ~ N(0, 0.3²) and var ~ U(0.5, 2),
so that eval mode normalizes by statistics of a trained-looking spread.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Tuple

import torch

from benchmark.reference.model import RESNET_STAGES, SKIPS, TOWERS

Shapes = "OrderedDict[str, Tuple[Tuple[int, ...], str, int]]"


def shapes(resolution: Tuple[int, int, int], num_classes: int,
           latent: int, skip_fraction: float, luf: int) -> Shapes:
  """name → (shape, kind, fan_in); kind is 'he', 'uniform', 'bn' or one
  of BatchRenorm's buffers 'mean', 'var', 'steps'."""
  out = OrderedDict()

  def conv(name, cin, cout, k, kind, dims=2):
    out[name + ".weight"] = ((cout, cin) + (k,) * dims, kind, cin * k ** dims)
    out[name + ".bias"] = ((cout,), "uniform", cin * k ** dims)

  def bn(name, c):
    for leaf, kind in (("scale", "one"), ("bias", "zero"), ("mean", "mean"),
                       ("var", "var"), ("steps", "steps")):
      out[f"{name}.{leaf}"] = (() if leaf == "steps" else (c,), kind, 0)

  conv("encoder.stage1_conv", 3, 64, 7, "he")
  bn("encoder.stage1_bn", 64)
  cin = 64
  for stage, blocks, (f1, f2, f3), _ in RESNET_STAGES:
    for block in blocks:
      n = f"encoder.stage{stage}{block}"
      if block == "a":
        conv(n + ".conv_shortcut", cin, f3, 1, "he")
        bn(n + ".bn_shortcut", f3)
      conv(n + ".conv_a", cin, f1, 1, "he")
      bn(n + ".bn_a", f1)
      conv(n + ".conv_b", f1, f2, 3, "he")
      bn(n + ".bn_b", f2)
      conv(n + ".conv_c", f2, f3, 1, "he")
      bn(n + ".bn_c", f3)
      cin = f3
  ir = resolution[0] // (16 * luf)
  out["decoder.stage_0.weight"] = ((latent, 2048), "uniform", 2048)
  out["decoder.stage_0.bias"] = ((latent,), "uniform", 2048)
  bn("decoder.stage_1_bn", latent + 3)
  out["decoder.stage_1_t.weight"] = ((latent + 3, 256) + (ir,) * 3,
                                     "uniform", 256 * ir ** 3)
  out["decoder.stage_1_t.bias"] = ((256,), "uniform", 256 * ir ** 3)
  channels = 256
  for stage, cc, k, tout, tk, _, _ in TOWERS:
    tout = num_classes if tout is None else tout
    n = f"decoder.stage_{stage}"
    bn(n + "_bn1", channels)
    conv(n + "_c", channels, cc, k, "uniform", dims=3)
    bn(n + "_bn2", cc)
    out[n + "_t.weight"] = ((cc, tout) + (tk,) * 3, "uniform", tout * tk ** 3)
    out[n + "_t.bias"] = ((tout,), "uniform", tout * tk ** 3)
    channels = tout
    if stage in SKIPS:
      tap_channels = {5: 2048, 4: 1024, 3: 512, 2: 256}[SKIPS[stage][1]]
      sc = round(SKIPS[stage][0] * skip_fraction)
      conv(f"decoder.rt_skip_{stage}.compress_channels", tap_channels + 3,
           sc, 1, "uniform")
      channels += sc
  return out


@torch.no_grad()
def make(spec: Shapes, seed: int, device) -> Dict[str, torch.Tensor]:
  """The weights of `spec` from `seed`, float32 on `device` (steps
  int32), drawn by one generator on the device."""
  gen = torch.Generator(device=device).manual_seed(seed)
  sizes = {k: math.prod(s) for k, (s, _, _) in spec.items()}
  normal = torch.randn(sum(sizes.values()), generator=gen, device=device)
  uniform = torch.rand(sum(sizes.values()), generator=gen,
                       device=device) * 2 - 1
  out = {}
  offset = 0
  for k, (s, kind, fan_in) in spec.items():
    n = sizes[k]
    z = normal[offset:offset + n].view(s)
    u = uniform[offset:offset + n].view(s)
    offset += n
    if kind == "he":
      out[k] = z * math.sqrt(2.0 / fan_in)
    elif kind == "uniform":
      out[k] = u / math.sqrt(fan_in)
    elif kind == "one":
      out[k] = torch.ones(s, device=device)
    elif kind == "zero":
      out[k] = torch.zeros(s, device=device)
    elif kind == "mean":
      out[k] = z * 0.3
    elif kind == "var":
      out[k] = u * 0.75 + 1.25
    else:
      out[k] = torch.zeros(s, dtype=torch.int32, device=device)
  return out
