"""Plain PyTorch reference of the CoreNet model: ResNet-50, BatchRenorm in
train and eval mode, the fine decoder with ray-traced skips gathered by
indexing, and the FG_BG soft-IoU loss.

Written from the model's published description (CoreNet, Popov et al.,
ECCV 2020) and the layer arithmetic that the weights' state dict implies:
keys are those of `CoreNet.state_dict()`. Functional: every layer reads
its tensors from one dict `p` (parameters and running statistics), and
train mode writes the running statistics back into it. No kernel, no
packing, no phase-major layout: the decoder runs fine and its logits come
out as [B, D, H, W, C].

`dtype` None computes in float32; torch.bfloat16 casts each convolution's
and linear layer's input and weight to bf16 with float32 parameters and
statistics, as the configuration's bf16 training states. `low` is a cast
applied to each convolution's operands on top of that: the control of a
lower precision (benchmark/reference/precision.py).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

EPS = 1e-3
MOMENTUM = 0.01
RAMP_START = 5000
# (stage, blocks, filters, stride of the first block)
RESNET_STAGES = ((2, "abc", (64, 64, 256), 1),
                 (3, "abcd", (128, 128, 512), 2),
                 (4, "abcdef", (256, 256, 1024), 2),
                 (5, "abc", (512, 512, 2048), 2))
# (stage, conv features, conv kernel, transposed features, kernel, padding,
# output padding)
TOWERS = ((2, 256, 3, 128, 3, 1, 1),
          (3, 128, 5, 64, 7, 3, 1),
          (4, 64, 5, 32, 7, 3, 1),
          (5, 32, 5, 16, 7, 3, 1),
          (6, 16, 5, None, 7, 3, 1))
# skip after tower s: (channels before the skip fraction, encoder tap)
SKIPS = {2: (128, 5), 3: (64, 4), 4: (32, 3), 5: (16, 2)}


class Precision:
  """How a layer computes: `dtype` for its operands (None = float32) and
  `low`, an extra rounding of each operand (identity unless a control)."""

  def __init__(self, dtype: Optional[torch.dtype] = None,
               low: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    self.dtype = dtype
    self.low = low or (lambda t: t)

  def operands(self, x, w):
    if self.dtype is not None:
      x, w = x.to(self.dtype), w.to(self.dtype)
    return self.low(x), self.low(w)


def conv(p: Params, name: str, x, prec: Precision, stride=1, padding=0):
  w, b = p[name + ".weight"], p[name + ".bias"]
  fn = F.conv2d if x.dim() == 4 else F.conv3d
  xc, wc = prec.operands(x, w)
  if prec.dtype is None:
    return fn(xc, wc, b, stride, padding)
  y = fn(xc, wc, None, stride, padding)
  return (y.float() + b.view((-1,) + (1,) * (x.dim() - 2))).to(y.dtype)


def conv_t(p: Params, name: str, x, prec: Precision, stride, padding,
           output_padding):
  w, b = p[name + ".weight"], p[name + ".bias"]
  xc, wc = prec.operands(x, w)
  if prec.dtype is None:
    return F.conv_transpose3d(xc, wc, b, stride, padding, output_padding)
  y = F.conv_transpose3d(xc, wc, None, stride, padding, output_padding)
  return y + b.to(y.dtype).view(-1, 1, 1, 1)


def linear(p: Params, name: str, x, prec: Precision):
  w, b = p[name + ".weight"], p[name + ".bias"]
  xc, wc = prec.operands(x, w)
  if prec.dtype is None:
    return F.linear(xc, wc, b)
  return F.linear(xc, wc) + b.to(prec.dtype)


def batch_renorm(p: Params, name: str, x, train: bool):
  """Batch renormalization over dim 1 (Ioffe 2017), eps 1e-3. Train mode
  takes the batch statistics corrected by r and d, whose clips open from
  step 5000, and updates the running statistics in `p` (momentum 0.01,
  the variance scaled by C/(C − 1)); bf16 inputs take the one-pass
  moments shifted by the running mean."""
  scale, bias = p[name + ".scale"], p[name + ".bias"]
  mean, var = p[name + ".mean"], p[name + ".var"]
  shape = (1, -1) + (1,) * (x.dim() - 2)

  def cast(v):
    return v.to(x.dtype).view(shape)

  if not train:
    inv = 1.0 / torch.sqrt(var + EPS)
    y = x * cast(inv) + cast(-mean * inv)
    return y * cast(scale) + cast(bias)
  steps = p[name + ".steps"].float()
  d_max = torch.clamp(5.0 * (steps - RAMP_START) / 20000.0, 0.0, 5.0)
  r_max = 1.0 + torch.clamp(2.0 * (steps - RAMP_START) / 35000.0, 0.0, 2.0)
  dims = (0,) + tuple(range(2, x.dim()))
  if x.dtype == torch.bfloat16:
    xf = x.float() - mean.view(shape)
    m_shift = xf.mean(dim=dims)
    b_mean = m_shift + mean
    b_var = torch.clamp(torch.square(xf).mean(dim=dims)
                        - torch.square(m_shift), min=0.0)
  else:
    b_mean = x.mean(dim=dims)
    b_var = torch.square(x - b_mean.view(shape)).mean(dim=dims)
  b_std = torch.sqrt(b_var + EPS)
  running_std = torch.sqrt(var + EPS)
  r = torch.clamp(b_std.detach() / running_std, 1.0 / r_max, r_max)
  d = torch.clamp((b_mean.detach() - mean) / running_std, -d_max, d_max)
  scale_eff = r / b_std
  shift_eff = d - b_mean * r / b_std
  with torch.no_grad():
    c = x.shape[1]
    p[name + ".var"] = var + MOMENTUM * (b_var * c / (c - 1) - var)
    p[name + ".mean"] = mean + MOMENTUM * (b_mean - mean)
    p[name + ".steps"] = p[name + ".steps"] + 1
  y = x * cast(scale_eff) + cast(shift_eff)
  return y * cast(scale) + cast(bias)


def preprocess(image: torch.Tensor) -> torch.Tensor:
  """uint8 RGB [B, H, W, 3] → float32 BGR with the Caffe means added, as
  the model's published preprocessing is implemented."""
  image = image.float().flip(-1)
  return image + torch.tensor([103.939, 116.779, 123.68],
                              device=image.device)


def resnet50(p: Params, image: torch.Tensor, train: bool, prec: Precision):
  """uint8 [B, H, W, 3] → (taps {1..5} as (N, C, H, W), global average
  [B, 2048]). Tap 1 is the first convolution's output, taps 2..5 each
  stage's last pre-ReLU residual sum."""
  def bn(name, x):
    return batch_renorm(p, name, x, train)

  x = preprocess(image).permute(0, 3, 1, 2).contiguous()
  x = tap1 = conv(p, "encoder.stage1_conv", x, prec, 2, 3)
  x = F.relu(bn("encoder.stage1_bn", x))
  x = F.max_pool2d(x, 3, 2, 1)
  taps = {1: tap1}
  for stage, blocks, _, stride in RESNET_STAGES:
    for block in blocks:
      n = f"encoder.stage{stage}{block}"
      if block == "a":
        s = bn(n + ".bn_shortcut", conv(p, n + ".conv_shortcut", x, prec,
                                        stride))
        y = F.relu(bn(n + ".bn_a", conv(p, n + ".conv_a", x, prec, stride)))
        y = F.relu(bn(n + ".bn_b", conv(p, n + ".conv_b", y, prec, 1, 1)))
        x = F.relu(bn(n + ".bn_c", conv(p, n + ".conv_c", y, prec)) + s)
      else:
        y = F.relu(bn(n + ".bn_a", conv(p, n + ".conv_a", x, prec)))
        y = F.relu(bn(n + ".bn_b", conv(p, n + ".conv_b", y, prec, 1, 1)))
        pre = bn(n + ".bn_c", conv(p, n + ".conv_c", y, prec)) + x
        taps[stage] = pre
        x = F.relu(pre)
  average = x.mean(dim=(2, 3), dtype=torch.float32).to(x.dtype)
  return taps, average


def compute_v2s(camera: torch.Tensor, v2x: torch.Tensor) -> torch.Tensor:
  """voxel → screen = camera @ v2x⁻¹ for a diagonal v2x: a column
  scaling by the reciprocal diagonal."""
  inv = torch.cat([1.0 / torch.diagonal(v2x[..., :3, :3], dim1=-2,
                                        dim2=-1),
                   torch.ones_like(v2x[..., :1, 0])], dim=-1)
  return camera * inv[..., None, :]


def pixel_indices(matrix: torch.Tensor, offset: torch.Tensor,
                  res: Tuple[int, int, int], height: int, width: int):
  """(px, py) int [B, D·H·W] into the 1-pixel padded map of each voxel
  centre (x + ox, y + oy, z + oz), voxels in (z, y, x) order, projected by
  `matrix` (voxel → NDC). Indices truncate toward zero; points behind the
  camera read pixel (0, 0), a pad cell."""
  gd, gh, gw = res
  b = matrix.shape[0]
  dev = matrix.device
  xs = (torch.arange(gw, dtype=torch.float32, device=dev)[None]
        + offset[:, 0:1]).view(b, 1, 1, gw)
  ys = (torch.arange(gh, dtype=torch.float32, device=dev)[None]
        + offset[:, 1:2]).view(b, 1, gh, 1)
  zs = (torch.arange(gd, dtype=torch.float32, device=dev)[None]
        + offset[:, 2:3]).view(b, gd, 1, 1)

  def row(i):
    r = matrix[:, i].view(b, 4, 1, 1, 1)
    return r[:, 0] * xs + r[:, 1] * ys + r[:, 2] * zs + r[:, 3]

  hx, hy, hz, hw = (row(i) for i in range(4))
  fx = (hx / hw) / 2.0 + 0.5
  fy = (hy / hw) / 2.0 + 0.5
  ix = (fx * width).clamp(-1.0, width + 1.0).to(torch.int32)
  iy = (fy * height).clamp(-1.0, height + 1.0).to(torch.int32)
  px = (ix + 1).clamp(0, width + 1)
  py = (iy + 1).clamp(0, height + 1)
  behind = hz < 0
  px = torch.where(behind, 0, px)
  py = torch.where(behind, 0, py)
  return px.reshape(b, -1), py.reshape(b, -1)


def skip(p: Params, stage: int, tap, v2s, offset, res, prec: Precision):
  """The ray-traced skip after tower `stage`: the tap with the offsets
  appended, compressed by a 1×1 convolution, zero-padded by one pixel and
  gathered at every voxel's projected pixel → (N, C, D, H, W)."""
  b, _, h, w = tap.shape
  o = offset[:, :, None, None].expand(b, 3, h, w)
  src = torch.cat([tap, o], dim=1)
  comp = conv(p, f"decoder.rt_skip_{stage}.compress_channels", src, prec)
  comp = F.pad(comp.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))
  px, py = pixel_indices(v2s, offset, res, h, w)
  rows = torch.arange(b, device=comp.device)[:, None]
  out = comp[rows, py.long(), px.long()]  # [B, N, C]
  return out.reshape((b,) + tuple(res) + (-1,)).permute(0, 4, 1, 2, 3)


def decoder(p: Params, taps, average, v2s, offset, resolution,
            train: bool, prec: Precision, luf: int = 2):
  """The fine 3D decoder → float32 logits [B, D, H, W, C]."""
  def bn(name, x):
    return batch_renorm(p, name, x, train)

  ir = resolution[0] // (16 * luf)
  x = linear(p, "decoder.stage_0", average, prec).float()
  x = torch.cat([x, offset], dim=-1)[:, :, None, None, None]
  x = conv_t(p, "decoder.stage_1_t", bn("decoder.stage_1_bn", F.relu(x)),
             prec, ir, 0, 0)
  layer_res = ir
  for stage, _, k, _, tk, tpad, top in TOWERS:
    stride = luf if stage == 6 else 2
    n = f"decoder.stage_{stage}"
    x = bn(n + "_bn1", F.relu(x))
    x = conv(p, n + "_c", x, prec, 1, k // 2)
    x = bn(n + "_bn2", F.relu(x))
    x = conv_t(p, n + "_t", x, prec, stride, tpad, top)
    layer_res *= stride
    if stage in SKIPS:
      ratio = torch.cat([
          torch.tensor(resolution, dtype=torch.float32, device=v2s.device)
          / torch.tensor([layer_res] * 3, dtype=torch.float32,
                         device=v2s.device),
          torch.ones(1, device=v2s.device)])
      s = skip(p, stage, taps[SKIPS[stage][1]], v2s * ratio, offset,
               (layer_res,) * 3, prec)
      x = torch.cat([x, s], dim=1)
  return x.permute(0, 2, 3, 4, 1).float()


def forward(p: Params, image, v2s, offset, resolution, train: bool,
            prec: Precision):
  taps, average = resnet50(p, image, train, prec)
  return decoder(p, taps, average, v2s, offset, resolution, train, prec)


def fgbg_loss(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
  """1 − the batch's mean soft IoU of the foreground: sigmoid of the
  logits' difference, summed per scene in float64."""
  b = logits.shape[0]
  pred = torch.sigmoid(logits[..., 1] - logits[..., 0]).reshape(b, -1)
  fg = (labels == 1).reshape(b, -1)
  inter = torch.where(fg, pred, 0.0).sum(1, dtype=torch.float64).float()
  union = torch.where(fg, 1.0, pred).sum(1, dtype=torch.float64).float()
  iou = inter / torch.where(union == 0, 1.0, union)
  return 1.0 - iou.mean()


def trainable(p: Params):
  """The names of the parameters Adam updates, in the state dict's
  order: every tensor that is not a running statistic."""
  return [k for k in p if not k.endswith((".mean", ".var", ".steps"))]


class Adam:
  """torch's Adam algebra: lr · m/(1 − β1ᵗ) / (√v/√(1 − β2ᵗ) + eps)."""

  def __init__(self, lr: float, eps: float, b1: float = 0.9,
               b2: float = 0.999):
    self.lr, self.eps, self.b1, self.b2 = lr, eps, b1, b2
    self.t = 0
    self.m, self.v = {}, {}

  @torch.no_grad()
  def step(self, p: Params, grads: Params) -> None:
    self.t += 1
    c1 = 1 - self.b1 ** self.t
    c2 = math.sqrt(1 - self.b2 ** self.t)
    for k, g in grads.items():
      m = self.m.get(k, torch.zeros_like(g)) * self.b1 + (1 - self.b1) * g
      v = self.v.get(k, torch.zeros_like(g)) * self.b2 + (1 - self.b2) * g * g
      self.m[k], self.v[k] = m, v
      p[k] = p[k] - (self.lr / c1) * m / (v.sqrt() / c2 + self.eps)
