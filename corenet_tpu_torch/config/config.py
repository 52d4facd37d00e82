"""Typed configuration dataclasses ⇄ JSON, with string templates.

A near-copy of corenet_tpu/config/config.py with its imports renamed (the
port keeps its own copy of the host-side modules it needs): the same
config families (TrainPipeline/TrainConfig/DataPipeline/Dataset/
DataLoaderConfig/VoxelizationConfig/EvalConfig/RecurrentEvalConfig/
TfModelEvalPipeline), the same enums, defaults, and `{key}` string-template
substitution with CLI `-D key=value` overrides, so every
configs/models/*.json5 parses to the same values in both packages.
Serialization is hand-rolled (dataclasses + enums + lists). The model's
own configuration stays models/corenet.py's CoreNetConfig/DecoderConfig.
"""

from __future__ import annotations

import dataclasses
import enum
import types
import typing
from typing import Any, List, MutableMapping, Tuple, TypeVar

WITH_TEMPLATES_MARKER = "with_templates"


def templated_str_field(default: Any = dataclasses.MISSING):
  """Marks a string field for `{key}` template substitution."""
  if default is dataclasses.MISSING:
    return dataclasses.field(metadata={WITH_TEMPLATES_MARKER: True})
  return dataclasses.field(default=default,
                           metadata={WITH_TEMPLATES_MARKER: True})


class ShuffleType(enum.Enum):
  PER_EPOCH = "PER_EPOCH"  # train: per epoch; eval: per global step
  ONCE = "ONCE"            # fixed permutation (global seed)
  NEVER = "NEVER"


class TaskType(enum.Enum):
  FG_BG = "FG_BG"          # occupancy grid
  SEMANTIC = "SEMANTIC"    # per-class grid


@dataclasses.dataclass
class Dataset:
  """One dataset shard of a data pipeline."""
  dataset_path: str = templated_str_field()
  meshes_dir: str = templated_str_field()
  high_realism: bool = True
  shuffle: ShuffleType = ShuffleType.NEVER
  data_fraction: float = 1.0


@dataclasses.dataclass
class DataLoaderConfig:
  num_data_workers: int = 6
  batch_size: int = 4
  prefetch_factor: int = 2
  # Decode scenes in worker PROCESSES (GIL-free) instead of threads:
  # NPZ+WebP decode is Python/zlib-bound, so threads serialize on the
  # GIL. Falls back to threads automatically when the dataset cannot be
  # pickled to workers.
  worker_processes: bool = True


@dataclasses.dataclass
class Resolution:
  # Field order matters: (depth, height, width).
  depth: int
  height: int
  width: int

  def as_tuple(self) -> Tuple[int, int, int]:
    return (self.depth, self.height, self.width)


@dataclasses.dataclass
class VoxelizationConfig:
  """Volume sampling configuration."""
  task_type: TaskType
  resolution: Resolution
  sub_grid_sampling: bool = False
  conservative_rasterization: bool = True
  voxelization_image_resolution_multiplier: int = 5
  # 1 except for the paper's pre-trained h7 model, which used 2 (a bug kept
  # for bit-exact eval reproduction).
  voxelization_projection_depth_multiplier: int = 1
  # Interior-fill rounds for the raster GT: 0 = automatic (the adaptive
  # exact fixpoint on a single process), n > 0 = exactly n static rounds.
  # Deep-cavity datasets whose audit reports under-fill can raise this
  # without editing source.
  voxelization_fill_rounds: int = 0


@dataclasses.dataclass
class DataPipeline:
  datasets: List[Dataset]
  shuffle: ShuffleType
  data_loader: DataLoaderConfig
  voxelization_config: VoxelizationConfig


@dataclasses.dataclass
class EvalConfig:
  name: str
  data: DataPipeline
  num_qualitative_results: int = 40
  num_qualitative_results_in_tensor_board: int = 4


@dataclasses.dataclass
class StringTemplate:
  key: str
  value: str = templated_str_field()


@dataclasses.dataclass
class TfModelEvalPipeline:
  string_templates: List[StringTemplate]
  eval_config: EvalConfig
  frozen_graph_path: str = templated_str_field()
  output_path: str = templated_str_field()


@dataclasses.dataclass
class RecurrentEvalConfig:
  """Recurrent evaluation during training. Fires at the end of the train iteration crossing start_step + K*interval
  (StepEvent semantics)."""
  start_step: int
  interval: int
  persistent_checkpoint: bool
  config: EvalConfig


@dataclasses.dataclass
class TrainConfig:
  data: DataPipeline
  resnet50_imagenet_checkpoint: str = templated_str_field()
  checkpoint_interval: int = 16000
  persistent_checkpoint_interval: int = 100000
  tensorboard_log_interval: int = 1600
  initial_learning_rate: float = 0.01
  adam_epsilon: float = 1e-4
  random_grid_offset: bool = True
  # Cadence (global-step units, like the other intervals) of the static
  # interior-fill audit — the under-fill detector for datasets whose
  # cavities wind more turns than voxelization_fill_rounds. Independent
  # of the checkpoint cadence so a poisoned dataset is flagged within
  # ~1k steps; it also fires once on the very first step of every run.
  fill_audit_interval: int = 1000
  last_upscale_factor: int = 2
  latent_channels: int = 64
  skip_fraction: float = 0.75
  max_steps: int = -1  # trains forever if negative


@dataclasses.dataclass
class TrainPipeline:
  string_templates: List[StringTemplate]
  train: TrainConfig
  eval: List[RecurrentEvalConfig]
  output_path: str = templated_str_field()


# ------------------------------------------------------------- codec -------
T = TypeVar("T")


def _unwrap_optional(tp):
  origin = typing.get_origin(tp)
  if origin in (typing.Union, types.UnionType):
    args = [a for a in typing.get_args(tp) if a is not type(None)]
    if len(args) == 1:
      return args[0]
  return tp


def config_from_dict(cls: type, data: Any) -> Any:
  """Recursively builds a config dataclass from plain JSON data."""
  cls = _unwrap_optional(cls)
  origin = typing.get_origin(cls)
  if origin in (list, List):
    (elem,) = typing.get_args(cls)
    return [config_from_dict(elem, v) for v in data]
  if origin in (tuple, Tuple):
    args = typing.get_args(cls)
    if len(args) == 2 and args[1] is Ellipsis:
      return tuple(config_from_dict(args[0], v) for v in data)
    return tuple(config_from_dict(a, v) for a, v in zip(args, data))
  if isinstance(cls, type) and issubclass(cls, enum.Enum):
    return cls(data)
  if dataclasses.is_dataclass(cls):
    kwargs = {}
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
      if f.name in data:
        kwargs[f.name] = config_from_dict(hints[f.name], data[f.name])
    return cls(**kwargs)
  if cls is float and isinstance(data, int):
    return float(data)
  return data


def config_to_dict(obj: Any) -> Any:
  """Recursively converts a config dataclass to plain JSON data."""
  if isinstance(obj, enum.Enum):
    return obj.value
  if dataclasses.is_dataclass(obj):
    return {f.name: config_to_dict(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}
  if isinstance(obj, (list, tuple)):
    return [config_to_dict(v) for v in obj]
  return obj


def replace_templates(data: T, template_values: MutableMapping[str, str]) -> T:
  """Substitutes `{key}` templates in all templated_str_fields, collecting
  defaults from StringTemplate entries along the way (a StringTemplate's
  value registers as the default for its key unless overridden)."""
  if type(data) in (str, float, int, bool, type(None)) or isinstance(
      data, enum.Enum):
    return data
  if isinstance(data, list):
    return [replace_templates(v, template_values) for v in data]
  if isinstance(data, tuple):
    return tuple(replace_templates(v, template_values) for v in data)
  if dataclasses.is_dataclass(data):
    result = {}
    for f in dataclasses.fields(data):
      v = getattr(data, f.name)
      if WITH_TEMPLATES_MARKER in f.metadata:
        result[f.name] = v.format(**template_values)
      else:
        result[f.name] = replace_templates(v, template_values)
    out = type(data)(**result)
    if isinstance(out, StringTemplate):
      if out.key not in template_values:
        template_values[out.key] = out.value
    return out
  raise ValueError(f"Cannot handle config node of type {type(data)}")


def parse_template_mapping(template_mapping: List[str]) -> MutableMapping[str, str]:
  """Parses '-D key=value' strings into a template mapping."""
  result = {}
  for mapping in template_mapping:
    key, value = mapping.split("=", 1)
    result[key] = value
  return result
