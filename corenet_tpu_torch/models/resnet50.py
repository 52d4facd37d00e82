"""Keras-layout ResNet-50 feature extractor.

Counterpart of corenet_tpu/models/resnet50.py, with the same six taps:
the stage-1 conv output (before its BatchRenorm and ReLU), the pre-ReLU
residual outputs of stages 2..5, and the global average of the last
stage. BatchRenorm uses eps = 1e-3 throughout. Submodule names follow the
flax scopes (`stage1_conv`, `stage2a.conv_a`, `stage2a.bn_shortcut`, …).

Inside, activations are (N, C, H, W). At the public boundary the image is
channel-last and the features are channel-last views of the (N, C, H, W)
tensors (no copy), so they compare directly with the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from corenet_tpu_torch.models import layers
from corenet_tpu_torch.models.batch_renorm import BatchRenorm


class ResNet50Features(NamedTuple):
  stage1_64: torch.Tensor      # [B, H/2, W/2, 64]
  stage2_256: torch.Tensor     # [B, H/4, W/4, 256]
  stage3_512: torch.Tensor     # [B, H/8, W/8, 512]
  stage4_1024: torch.Tensor    # [B, H/16, W/16, 1024]
  stage5_2048: torch.Tensor    # [B, H/32, W/32, 2048]
  global_average_2048: torch.Tensor  # [B, 2048]


def _conv(in_features, features, kernel_size, stride=1, padding=0,
          device=None):
  return layers.Conv(in_features, features, kernel_size, ndim=2,
                     stride=stride, padding=padding,
                     kernel_init_mode="kaiming_normal", device=device)


class IdentityBlock(nn.Module):

  def __init__(self, in_features: int, kernel_size: int,
               filters: Tuple[int, int, int],
               device: Optional[torch.device] = None):
    super().__init__()
    f1, f2, f3 = filters
    self.conv_a = _conv(in_features, f1, 1, device=device)
    self.bn_a = BatchRenorm(f1, device=device)
    self.conv_b = _conv(f1, f2, kernel_size, padding=kernel_size // 2,
                        device=device)
    self.bn_b = BatchRenorm(f2, device=device)
    self.conv_c = _conv(f2, f3, 1, device=device)
    self.bn_c = BatchRenorm(f3, device=device)

  def forward(self, x: torch.Tensor):
    """Returns (output, pre-ReLU output)."""
    inp = x
    x = F.relu(self.bn_a(self.conv_a(x)))
    x = F.relu(self.bn_b(self.conv_b(x)))
    before_relu = self.bn_c(self.conv_c(x)) + inp
    return F.relu(before_relu), before_relu


class DownscaleBlock(nn.Module):

  def __init__(self, in_features: int, kernel_size: int,
               filters: Tuple[int, int, int], stride: int = 2,
               device: Optional[torch.device] = None):
    super().__init__()
    f1, f2, f3 = filters
    self.conv_shortcut = _conv(in_features, f3, 1, stride=stride,
                               device=device)
    self.bn_shortcut = BatchRenorm(f3, device=device)
    self.conv_a = _conv(in_features, f1, 1, stride=stride, device=device)
    self.bn_a = BatchRenorm(f1, device=device)
    self.conv_b = _conv(f1, f2, kernel_size, padding=kernel_size // 2,
                        device=device)
    self.bn_b = BatchRenorm(f2, device=device)
    self.conv_c = _conv(f2, f3, 1, device=device)
    self.bn_c = BatchRenorm(f3, device=device)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    s = self.bn_shortcut(self.conv_shortcut(x))
    x = F.relu(self.bn_a(self.conv_a(x)))
    x = F.relu(self.bn_b(self.conv_b(x)))
    x = self.bn_c(self.conv_c(x))
    return F.relu(x + s)


# (stage, blocks, filters, stride of the first block)
_STAGES = ((2, "abc", (64, 64, 256), 1),
           (3, "abcd", (128, 128, 512), 2),
           (4, "abcdef", (256, 256, 1024), 2),
           (5, "abc", (512, 512, 2048), 2))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
  return x.permute(0, 2, 3, 1)


class ResNet50FeatureExtractor(nn.Module):

  def __init__(self, device: Optional[torch.device] = None):
    super().__init__()
    self.stage1_conv = _conv(3, 64, 7, stride=2, padding=3, device=device)
    self.stage1_bn = BatchRenorm(64, device=device)
    in_features = 64
    for stage, blocks, filters, stride in _STAGES:
      for block in blocks:
        name = f"stage{stage}{block}"
        if block == "a":
          module = DownscaleBlock(in_features, 3, filters, stride=stride,
                                  device=device)
        else:
          module = IdentityBlock(in_features, 3, filters, device=device)
        self.add_module(name, module)
        in_features = filters[2]

  def forward(self, image: torch.Tensor) -> ResNet50Features:
    """image: float32[B, H, W, 3], Caffe-preprocessed."""
    x = stage1 = self.stage1_conv(image.permute(0, 3, 1, 2).contiguous())
    x = F.relu(self.stage1_bn(x))
    x = layers.max_pool_2d(x, kernel=3, stride=2, padding=1)
    taps = {}
    for stage, blocks, _, _ in _STAGES:
      for block in blocks:
        module = getattr(self, f"stage{stage}{block}")
        if block == "a":
          x = module(x)
        else:
          x, taps[stage] = module(x)
    avg_pool = x.mean(dim=(2, 3))
    return ResNet50Features(_nhwc(stage1), _nhwc(taps[2]), _nhwc(taps[3]),
                            _nhwc(taps[4]), _nhwc(taps[5]), avg_pool)


def preprocess_image_caffe(image: torch.Tensor) -> torch.Tensor:
  """uint8[B, H, W, 3] RGB → float32 BGR with the reference's constants
  ADDED (not subtracted), exactly as the JAX package does."""
  if image.dtype != torch.uint8 or image.dim() != 4 or image.shape[-1] != 3:
    raise ValueError(f"expected uint8[B, H, W, 3], got {image.dtype} "
                     f"{tuple(image.shape)}")
  image = image.float().flip(-1)  # RGB → BGR
  return image + torch.tensor([103.939, 116.779, 123.68],
                              dtype=torch.float32, device=image.device)
