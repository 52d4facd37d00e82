"""Training pipeline helpers.

Counterpart of corenet_tpu/train/pipeline.py. For now it holds the model
configuration's derivation from a training configuration, which the eval
and demo CLIs need to rebuild a model from a checkpoint's metadata;
`TrainPipeline` itself is not ported yet.
"""

from __future__ import annotations

from corenet_tpu_torch.config import config as cfg
from corenet_tpu_torch.models.corenet import CoreNetConfig, DecoderConfig


def model_config_from_train_config(config: cfg.TrainConfig,
                                   num_classes: int) -> CoreNetConfig:
  """Output channels = num_classes for SEMANTIC, 2 for FG_BG; the decoder's
  resolution is the voxelization resolution reversed (the identity for the
  cubic grids used in practice, kept as the JAX package has it)."""
  vc = config.data.voxelization_config
  num_channels = {
      cfg.TaskType.SEMANTIC: num_classes,
      cfg.TaskType.FG_BG: 2,
  }[vc.task_type]
  return CoreNetConfig(decoder=DecoderConfig(
      resolution=vc.resolution.as_tuple()[::-1],
      num_output_channels=num_channels,
      last_upscale_factor=config.last_upscale_factor,
      latent_channels=config.latent_channels,
      skip_fraction=config.skip_fraction))
