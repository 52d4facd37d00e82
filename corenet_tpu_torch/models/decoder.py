"""3D reconstruction decoder with ray-traced skip connections.

Counterpart of corenet_tpu/models/decoder.py: latent 2048 → L linear,
concat of the (x, y, z) grid offsets, a
ConvTranspose3d with kernel = stride = ir to the initial ir³ grid, and
five {ReLU, BN, Conv3d, ReLU, BN, ConvTranspose3d} towers doubling the
resolution, with ray-traced skips concatenating round(C · skip_fraction)
channels sampled from ResNet stages 5/5/4/3/2 after stages 2..5 (stage 1's
skip is disabled, as in the reference), and a last ConvTranspose3d with
stride last_upscale_factor to the output channels. With `phase_output`
(last_upscale_factor 2) that last layer's output stays phase-major,
[B, D/2, H/2, W/2, 8·C] in channel order (pz, py, px, c), which the
phase-loss training step pairs with phase-major labels; the parameters
are the same.

`packed` runs the towers from `pack_from_stage` (2–6, default 5) on
space-to-depth packed activations (models/packing.py), with the same
parameters: the activation is packed right before that tower, each
packed skip (models/skip.py) is concatenated per phase, so a packed
activation is always one phase-major interleave of the fine channels in
the fine concatenation's order, and the logits are unpacked at the end.
With `phase_output` the packed last layer skips its interleave too and
the logits come as [B, D/4, H/4, W/4, 64·C], channel order (rm0, rm1,
rm2, pz, py, px, c), fine index 4·coarse + 2·rm + phase per axis. It
needs last_upscale_factor 2 and an even grid at the packing point. The
JAX package concatenates a packed skip as a block [8·Cx | 8·Cs] and lets
the next convolution and BatchRenorm undo that through their
input_groups and phase_groups; the per-phase interleave needs neither,
so the port has neither, and costs the same single copy as the fine
concatenation.

`compute_dtype` (None = float32; torch.bfloat16) runs every convolution,
the latent linear layer and the skips' compressions in that dtype, as the
JAX decoder does: the latent returns to float32 before stage 1's
BatchRenorm, the towers run in the compute dtype, and the fine logits
return to float32. Phase-major logits stay in the compute dtype (the
loss takes their difference in float32).

Module names follow the flax scopes (`stage_0`, `stage_1_bn`, `stage_2_c`,
`rt_skip_5.compress_channels`, …). Activations are (N, C, D, H, W) inside;
the features come in channel-last and the logits go out as
float32[B, D, H, W, C].
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from corenet_tpu_torch.models import layers, packing
from corenet_tpu_torch.models.batch_renorm import BatchRenorm
from corenet_tpu_torch.models.resnet50 import ResNet50Features
from corenet_tpu_torch.models.skip import SampleGrid2d

# Towers: (stage, conv features, conv kernel, transposed-conv features,
# its kernel, padding, output padding); strides are 2, the last tower's
# last_upscale_factor.
_TOWERS = ((2, 256, 3, 128, 3, 1, 1),
           (3, 128, 5, 64, 7, 3, 1),
           (4, 64, 5, 32, 7, 3, 1),
           (5, 32, 5, 16, 7, 3, 1),
           (6, 16, 5, None, 7, 3, 1))
# Skips after towers 2..5: stage → (channels before the skip fraction,
# ResNet50Features field it samples, that field's channels).
_SKIPS = {2: (128, "stage5_2048", 2048),
          3: (64, "stage4_1024", 1024),
          4: (32, "stage3_512", 512),
          5: (16, "stage2_256", 256)}


def packed_eligible(resolution: Tuple[int, int, int],
                    last_upscale_factor: int, pack_from_stage: int) -> bool:
  """Whether a decoder can run packed from `pack_from_stage`: stride-2
  stages (last_upscale_factor 2) and an even grid at the packing point.
  At pack_from_stage 2 that is an even seed grid, the rule by which the
  JAX package's TrainPipeline chooses packed execution."""
  if last_upscale_factor != 2 or not 2 <= pack_from_stage <= 6:
    return False
  return all(v % 32 == 0 and v // 32 * 2 ** (pack_from_stage - 2) % 2 == 0
             for v in resolution)


def require_packed_eligible(resolution: Tuple[int, int, int],
                            last_upscale_factor: int,
                            pack_from_stage: int) -> None:
  """Raises ValueError unless packed_eligible."""
  if not packed_eligible(resolution, last_upscale_factor, pack_from_stage):
    # pack_from_stage 2 packs every tower, 6 only the last.
    seed = tuple(v // (16 * last_upscale_factor) for v in resolution)
    raise ValueError(
        "packed decoding needs pack_from_stage in [2, 6], stride-2 stages "
        "and an even grid at the packing point (stage "
        f"{pack_from_stage}, last_upscale_factor {last_upscale_factor}, "
        f"seed grid {seed})")


class ReconstructionDecoder(nn.Module):

  def __init__(self, resolution: Tuple[int, int, int],
               num_output_channels: int, last_upscale_factor: int = 2,
               latent_channels: int = 64, skip_fraction: float = 0.75,
               phase_output: bool = False, packed: bool = False,
               pack_from_stage: int = 5,
               compute_dtype: Optional[torch.dtype] = None,
               device: Optional[torch.device] = None):
    super().__init__()
    if phase_output and last_upscale_factor != 2:
      raise ValueError("phase_output needs last_upscale_factor 2, got "
                       f"{last_upscale_factor}")
    self.phase_output = phase_output
    self.num_output_channels = num_output_channels
    self.resolution = tuple(resolution)
    div = 16 * last_upscale_factor
    if any(v % div for v in self.resolution):
      raise ValueError(f"resolution {self.resolution} must be divisible by "
                       f"16 · last_upscale_factor = {div}")
    ir = tuple(v // div for v in self.resolution)
    if packed:
      require_packed_eligible(self.resolution, last_upscale_factor,
                              pack_from_stage)
    self.packed = packed
    self.pack_from_stage = pack_from_stage if packed else 7

    self.skip_channels = {}
    if round(16 * skip_fraction) != 0:
      for stage, (c, _, _) in _SKIPS.items():
        if round(c * skip_fraction) != 0:
          self.skip_channels[stage] = round(c * skip_fraction)

    cd = dict(compute_dtype=compute_dtype, device=device)
    self.stage_0 = layers.Linear(2048, latent_channels, **cd)
    # stage_1: ReLU, BN, ConvT(latent + 3 → 256) emitting the ir³ seed grid
    # (kernel = stride = ir, the JAX package's generalization of the
    # reference's hard-coded 4).
    self.stage_1_bn = BatchRenorm(latent_channels + 3, device=device)
    self.stage_1_t = layers.ConvTranspose(latent_channels + 3, 256, ir,
                                          ndim=3, stride=ir, **cd)
    channels = 256
    layer_res = ir
    for stage, conv_c, conv_k, t_out, t_k, t_pad, t_op in _TOWERS:
      stride = last_upscale_factor if stage == 6 else 2
      t_out = num_output_channels if t_out is None else t_out
      tp = stage >= self.pack_from_stage
      phases = 8 if tp else 1
      self.add_module(f"stage_{stage}_bn1", BatchRenorm(
          channels, phase_packing=phases, device=device))
      self.add_module(f"stage_{stage}_c", layers.Conv(
          channels, conv_c, conv_k, ndim=3, padding=conv_k // 2,
          packed_io=tp, **cd))
      self.add_module(f"stage_{stage}_bn2", BatchRenorm(
          conv_c, phase_packing=phases, device=device))
      self.add_module(f"stage_{stage}_t", layers.ConvTranspose(
          conv_c, t_out, t_k, ndim=3, stride=stride, padding=t_pad,
          output_padding=t_op, phase_output=phase_output and stage == 6,
          packed_io=tp, **cd))
      channels = t_out
      layer_res = tuple(v * stride for v in layer_res)
      if stage in self.skip_channels:
        src_c = _SKIPS[stage][2]
        self.add_module(f"rt_skip_{stage}", SampleGrid2d(
            src_c + 3, self.skip_channels[stage], layer_res, packed=tp,
            **cd))
        channels += self.skip_channels[stage]
        # The skip's voxel → screen matrix is M @ diag(r, 1) with
        # r = resolution / layer resolution, divided in float32 as JAX
        # does. A buffer moves with the module, so no call copies it from
        # the host.
        r = (torch.tensor(self.resolution, dtype=torch.float32) /
             torch.tensor(layer_res, dtype=torch.float32))
        self.register_buffer(f"rt_skip_{stage}_scale",
                             torch.cat([r, torch.ones(1)]).to(device),
                             persistent=False)

  def _tower(self, x: torch.Tensor, stage: int) -> torch.Tensor:
    if stage == self.pack_from_stage:
      x = packing.space_to_depth(x)
    x = getattr(self, f"stage_{stage}_bn1")(F.relu(x))
    x = getattr(self, f"stage_{stage}_c")(x)
    x = getattr(self, f"stage_{stage}_bn2")(F.relu(x))
    return getattr(self, f"stage_{stage}_t")(x)

  def _skip(self, x: torch.Tensor, src2d: torch.Tensor, stage: int,
            voxel_projection_matrix: torch.Tensor,
            voxel_sample_locations: torch.Tensor) -> torch.Tensor:
    # src2d arrives channel-last; its (N, C, H, W) view is the tensor the
    # encoder computed, so this permute copies nothing.
    src = src2d.permute(0, 3, 1, 2)
    b, _, h, w = src.shape
    o = voxel_sample_locations[:, :, None, None].expand(b, 3, h, w)
    # bf16 features with the float32 offsets promote to float32, as
    # jnp.concatenate does; the compression casts back to its dtype.
    src = torch.cat([src, o], dim=1)
    # M @ diag(r, 1) as a column scaling: exact, and independent of the
    # matmul precision settings.
    layer_matrix = (voxel_projection_matrix *
                    getattr(self, f"rt_skip_{stage}_scale"))
    skip = getattr(self, f"rt_skip_{stage}")(src, layer_matrix,
                                            voxel_sample_locations)
    if stage < self.pack_from_stage:
      return torch.cat([x, skip], dim=1)
    # Per phase: [B, 8, Cx + Cs, ...], one phase-major interleave.
    b, _, d2, h2, w2 = x.shape
    x = torch.cat([x.view(b, 8, -1, d2, h2, w2), skip], dim=2)
    return x.view(b, -1, d2, h2, w2)

  def forward(self, image_features: ResNet50Features,
              voxel_projection_matrix: torch.Tensor,
              voxel_sample_locations: torch.Tensor) -> torch.Tensor:
    imf = image_features
    x = self.stage_0(imf.global_average_2048).float()
    x = torch.cat([x, voxel_sample_locations], dim=-1)
    x = x[:, :, None, None, None]  # [B, latent + 3, 1, 1, 1]
    x = self.stage_1_t(self.stage_1_bn(F.relu(x)))
    for stage, (_, field, _) in _SKIPS.items():
      x = self._tower(x, stage)
      if stage in self.skip_channels:
        x = self._skip(x, getattr(imf, field), stage,
                       voxel_projection_matrix, voxel_sample_locations)
    x = self._tower(x, 6)
    if self.phase_output:
      # [B, D/2, H/2, W/2, 8·C], or packed [B, D/4, H/4, W/4, 64·C];
      # phase-major, compute dtype.
      return x
    if self.packed:
      # Unpacked straight into the channel-last logits: one copy.
      b, _, d2, h2, w2 = x.shape
      x = x.view(b, 2, 2, 2, self.num_output_channels, d2, h2, w2)
      x = x.permute(0, 5, 1, 6, 2, 7, 3, 4).reshape(
          b, 2 * d2, 2 * h2, 2 * w2, self.num_output_channels)
      return x.float()
    return x.permute(0, 2, 3, 4, 1).float()
