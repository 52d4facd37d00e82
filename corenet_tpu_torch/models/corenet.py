"""Top-level CoreNet model: image → 3D voxel-grid logits.

Counterpart of corenet_tpu/models/corenet.py. Inputs are channel-last:
uint8 image [B, H, W, 3], voxel → screen matrix [B, 4, 4], grid sampling
offsets [B, 3]. Output: float32 logits [B, D, H, W, C].
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from corenet_tpu_torch.models.decoder import ReconstructionDecoder
from corenet_tpu_torch.models.resnet50 import (
    ResNet50FeatureExtractor,
    ResNet50Features,
    preprocess_image_caffe,
)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
  """Decoder hyper-parameters (the JAX package's DecoderConfig)."""
  resolution: Tuple[int, int, int]  # (depth, height, width)
  num_output_channels: int
  last_upscale_factor: int = 2
  latent_channels: int = 64
  skip_fraction: float = 0.75


@dataclasses.dataclass(frozen=True)
class CoreNetConfig:
  decoder: DecoderConfig


class CoreNet(nn.Module):
  """ResNet-50 encoder + ray-traced-skip 3D decoder. Submodules `encoder`
  and `decoder` match the flax scopes, so models/convert.py maps a JAX
  parameter tree onto `state_dict()` key by key.

  Parameters are allocated uninitialized on `device`; load a state dict or
  call `reset_parameters(generator)`. `model.train()` is the JAX
  package's `apply(..., train=True)`: every BatchRenorm, the encoder's
  included, normalizes with batch statistics and updates its running
  statistics; `model.eval()` is `train=False`.

  phase_output (last_upscale_factor 2): the logits come phase-major,
  [B, D/2, H/2, W/2, 8·C] (models/decoder.py), for the phase-loss
  training step; with packed_decoder [B, D/4, H/4, W/4, 64·C]. A model
  with and one without it load the same state_dict.

  packed_decoder: the decoder's towers from pack_from_stage (2–6, default
  5) run on space-to-depth packed activations (models/packing.py); the
  same parameters and function. Like phase_output, it changes execution,
  not the state_dict.

  depth_shard: (index, count) = this process computes depth slab `index`
  of `count` of the decoder (models/decoder.py), for the 'space' axis
  (parallel/mesh.py): the logits are that slab. None (or count 1) = the
  whole grid. Like phase_output, it changes execution, not the
  state_dict.

  compute_dtype: None = float32 everywhere; torch.bfloat16 = convolutions
  and matmuls in bf16 with float32 parameters, statistics, parameter
  gradients and fine logits (phase-major logits stay bf16). Like
  phase_output it changes execution, not the state_dict.
  """

  def __init__(self, config: CoreNetConfig, phase_output: bool = False,
               compute_dtype: Optional[torch.dtype] = None,
               packed_decoder: bool = False, pack_from_stage: int = 5,
               depth_shard: Optional[Tuple[int, int]] = None,
               device: Optional[torch.device] = None):
    super().__init__()
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
      raise ValueError(f"compute_dtype must be None, torch.float32 or "
                       f"torch.bfloat16, got {compute_dtype}")
    if compute_dtype == torch.float32:
      compute_dtype = None
    self.config = config
    self.phase_output = phase_output
    self.compute_dtype = compute_dtype
    self.packed_decoder = packed_decoder
    self.pack_from_stage = pack_from_stage
    dc = config.decoder
    self.encoder = ResNet50FeatureExtractor(compute_dtype=compute_dtype,
                                            device=device)
    self.decoder = ReconstructionDecoder(
        resolution=tuple(dc.resolution),
        num_output_channels=dc.num_output_channels,
        last_upscale_factor=dc.last_upscale_factor,
        latent_channels=dc.latent_channels,
        skip_fraction=dc.skip_fraction,
        phase_output=phase_output,
        packed=packed_decoder,
        pack_from_stage=pack_from_stage,
        depth_shard=depth_shard,
        compute_dtype=compute_dtype,
        device=device)
    self.depth_shard = self.decoder.depth_shard

  def reset_parameters(self, generator: torch.Generator) -> None:
    """The JAX package's initializers (models/layers.py), drawn from a CPU
    `generator` in module order: a seed gives the same weights anywhere."""
    for module in self.modules():
      if module is not self and hasattr(module, "reset_parameters"):
        module.reset_parameters(generator)

  def forward(self, image: torch.Tensor,
              voxel_projection_matrix: torch.Tensor,
              voxel_sample_locations: torch.Tensor) -> torch.Tensor:
    """uint8[B, H, W, 3] image, float32[B, 4, 4] voxel → screen, float32
    [B, 3] in-voxel offsets → float32[B, D, H, W, C] logits."""
    return self.decode(self.encode(image), voxel_projection_matrix,
                       voxel_sample_locations)

  def encode(self, image: torch.Tensor) -> ResNet50Features:
    """The offset-invariant half: uint8 image → ResNet50Features. Multi-pass
    inference (super-resolution's m³ offsets) encodes once and decodes per
    offset."""
    return self.encoder(preprocess_image_caffe(image))

  def decode(self, features: ResNet50Features,
             voxel_projection_matrix: torch.Tensor,
             voxel_sample_locations: torch.Tensor) -> torch.Tensor:
    """ResNet50Features + voxel → screen + in-voxel offsets → logits."""
    return self.decoder(features, voxel_projection_matrix,
                        voxel_sample_locations)
