"""The model's required floating-point operations, counted from its shapes.

Each convolution, transposed convolution and linear layer counts 2
operations per multiply-add that the layer's definition requires: per
axis, the pairs of an output position and a kernel tap that land on an
input position (taps on the zero padding and, for a transposed
convolution, on cropped outputs do not count), times the input and output
channels. Elementwise work (BatchRenorm, ReLU, softmax, pooling, the
gather) is not counted. So execution choices that compute more, such as
the packed decoder's expanded kernels with their zero taps, or recomputed
work, count nothing extra. A training step counts 3 × its forward.
"""

from __future__ import annotations

from typing import Tuple

from benchmark.reference.model import RESNET_STAGES, SKIPS, TOWERS


def conv_pairs(size: int, k: int, stride: int, pad: int) -> Tuple[int, int]:
  """(output size, valid (output, tap) pairs) of a convolution axis."""
  out = (size + 2 * pad - k) // stride + 1
  pairs = sum(1 for n in range(out) for t in range(k)
              if 0 <= n * stride - pad + t < size)
  return out, pairs


def conv_t_pairs(size: int, k: int, stride: int, pad: int,
                 out_pad: int) -> Tuple[int, int]:
  """(output size, valid (input, tap) pairs) of a transposed convolution
  axis: input j and tap t reach output s·j + t − pad."""
  out = (size - 1) * stride - 2 * pad + k + out_pad
  pairs = sum(1 for j in range(size) for t in range(k)
              if 0 <= stride * j + t - pad < out)
  return out, pairs


def resnet50(height: int, width: int) -> Tuple[int, dict]:
  """Forward operations of one image, and the (H, W) of each tap."""
  ops = 0

  def conv(h, w, cin, cout, k, s, p):
    nonlocal ops
    oh, ph = conv_pairs(h, k, s, p)
    ow, pw = conv_pairs(w, k, s, p)
    ops += 2 * ph * pw * cin * cout
    return oh, ow

  h, w = conv(height, width, 3, 64, 7, 2, 3)
  taps = {1: (h, w)}
  h, w = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1  # max pool 3, 2, 1
  cin = 64
  for stage, blocks, (f1, f2, f3), stride in RESNET_STAGES:
    for block in blocks:
      s = stride if block == "a" else 1
      if block == "a":
        conv(h, w, cin, f3, 1, s, 0)
      h2, w2 = conv(h, w, cin, f1, 1, s, 0)
      conv(h2, w2, f1, f2, 3, 1, 1)
      conv(h2, w2, f2, f3, 1, 1, 0)
      h, w, cin = h2, w2, f3
    taps[stage] = (h, w)
  return ops, taps


def decoder(resolution: int, num_classes: int, latent: int,
            skip_fraction: float, luf: int, taps: dict) -> int:
  """Forward operations of one fine decode at a cubic resolution."""
  ir = resolution // (16 * luf)
  ops = 2 * 2048 * latent
  ops += 2 * (latent + 3) * 256 * ir ** 3  # kernel = stride = ir on 1³
  size, channels = ir, 256
  tap_channels = {5: 2048, 4: 1024, 3: 512, 2: 256}
  for stage, cc, k, tout, tk, tpad, top in TOWERS:
    tout = num_classes if tout is None else tout
    _, pairs = conv_pairs(size, k, 1, k // 2)
    ops += 2 * pairs ** 3 * channels * cc
    stride = luf if stage == 6 else 2
    out, pairs = conv_t_pairs(size, tk, stride, tpad, top)
    ops += 2 * pairs ** 3 * cc * tout
    size, channels = out, tout
    if stage in SKIPS:
      tap = SKIPS[stage][1]
      sc = round(SKIPS[stage][0] * skip_fraction)
      h, w = taps[tap]
      ops += 2 * h * w * (tap_channels[tap] + 3) * sc
      channels += sc
  return ops


def forward(image_hw: int, resolution: int, num_classes: int, latent: int,
            skip_fraction: float, luf: int, decodes_per_image: int = 1
            ) -> int:
  """One image's forward: its encoding and `decodes_per_image` decodes
  (super-resolution's m³ passes)."""
  enc, taps = resnet50(image_hw, image_hw)
  return enc + decodes_per_image * decoder(resolution, num_classes, latent,
                                           skip_fraction, luf, taps)
