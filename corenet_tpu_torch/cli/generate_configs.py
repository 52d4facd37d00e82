"""Generates the standard model configs and their JSON schemas.

Counterpart of corenet_tpu/cli/generate_configs.py, on the port's own
config/ (a near-copy of the JAX package's): it writes the same files,
byte for byte, as the JAX package's generator, which are the repository's
configs/. Train pipelines for h5/h7/m7/m9 (and the untested y1), the
paper-TF-model eval pipelines for h5/h7/m7/m9/y1, and the JSON schemas
for editor validation. The values: voxelization presets (h5/h7 FG_BG
128³ multiplier 8; y1 FG_BG 32³ sub-grid multiplier 31; m7/m9 SEMANTIC
128³; TF evals multiplier 4, with h7's projection_depth_multiplier=2
quirk), train hparams (lr 4e-4, adam_eps 1e-4, max_steps 16M, cpt every
10k / persistent every 500k), and the 4-tier recurrent eval schedule.

Usage: python -m corenet_tpu_torch.cli.generate_configs [--output_dir=configs]
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import json
import os
import typing
from typing import Dict, List

from corenet_tpu_torch.config import config as c
from corenet_tpu_torch.config.config import config_to_dict

# The 3×3 ShapeNet dataset grid: collection → split → Dataset. The
# single-object collections carry the Choy-class table; the multi-object
# ones the full class table.
_SPLITS = ("train", "val", "test")
_COLLECTIONS = ("single", "pairs", "triplets")

DatasetTable = Dict[str, Dict[str, c.Dataset]]


def dataset_table(high_realism: bool = True) -> DatasetTable:
  return {
      coll: {
          split: c.Dataset(
              dataset_path=(
                  f"{{data_dir}}/{coll}.{split}/"
                  + ("dataset.choy_classes.json" if coll == "single"
                     else "dataset.json")),
              meshes_dir="{meshes_dir}",
              high_realism=high_realism,
              shuffle=c.ShuffleType.ONCE,
              data_fraction=1.0)
          for split in _SPLITS
      }
      for coll in _COLLECTIONS
  }


def default_data_loader() -> c.DataLoaderConfig:
  return c.DataLoaderConfig(num_data_workers=6, batch_size=4)


def common_string_templates() -> List[c.StringTemplate]:
  return [
      c.StringTemplate(key="data_dir", value="data"),
      c.StringTemplate(key="meshes_dir", value="{data_dir}/shapenet_meshes"),
  ]


def create_evals(table: DatasetTable, collection: str,
                 vox: c.VoxelizationConfig) -> List[c.RecurrentEvalConfig]:
  """The 4-tier recurrent eval schedule: a stable slice of the train
  data and of the test data, a reshuffled tenth of the test data, and
  the whole test set with a persistent checkpoint."""
  ds_test = table[collection]["test"]
  ds_test_short = dataclasses.replace(ds_test, data_fraction=1e-2)
  ds_test_medium = dataclasses.replace(
      ds_test, data_fraction=1e-1, shuffle=c.ShuffleType.PER_EPOCH)
  ds_short_train = dataclasses.replace(
      table[collection]["val"], data_fraction=1e-2,
      shuffle=c.ShuffleType.ONCE)

  def pipeline(datasets, shuffle):
    return c.DataPipeline(datasets=datasets, shuffle=shuffle,
                          data_loader=default_data_loader(),
                          voxelization_config=vox)

  return [
      # Frequent, small, stably-shuffled slice of the train data.
      c.RecurrentEvalConfig(
          start_step=40000, interval=40000, persistent_checkpoint=False,
          config=c.EvalConfig(
              name="short_stable_train_eval",
              num_qualitative_results=40,
              num_qualitative_results_in_tensor_board=4,
              data=pipeline([ds_short_train], c.ShuffleType.ONCE))),
      # Frequent, small, stably-shuffled slice of the test data.
      c.RecurrentEvalConfig(
          start_step=40000, interval=40000, persistent_checkpoint=False,
          config=c.EvalConfig(
              name="short_stable_eval",
              num_qualitative_results=40,
              num_qualitative_results_in_tensor_board=4,
              data=pipeline([ds_test_short], c.ShuffleType.ONCE))),
      # Less frequent, 10% of test, reshuffled per run (unbiased).
      c.RecurrentEvalConfig(
          start_step=140000, interval=140000, persistent_checkpoint=False,
          config=c.EvalConfig(
              name="medium_eval",
              num_qualitative_results=100,
              num_qualitative_results_in_tensor_board=4,
              data=pipeline([ds_test_medium], c.ShuffleType.PER_EPOCH))),
      # Full test set, stable shuffle, with a persistent checkpoint.
      c.RecurrentEvalConfig(
          start_step=500000, interval=500000, persistent_checkpoint=True,
          config=c.EvalConfig(
              name="full_eval",
              num_qualitative_results=500,
              num_qualitative_results_in_tensor_board=0,
              data=pipeline([ds_test], c.ShuffleType.ONCE))),
  ]


def build_train_pipelines():
  templates = common_string_templates() + [
      c.StringTemplate(key="resnet_cpt",
                       value="{data_dir}/keras_resnet50_imagenet.npz"),
      c.StringTemplate(key="output_dir", value="output/models"),
  ]
  hi = dataset_table(high_realism=True)
  lo = dataset_table(high_realism=False)

  vox_fgbg_128 = c.VoxelizationConfig(
      task_type=c.TaskType.FG_BG, resolution=c.Resolution(128, 128, 128),
      sub_grid_sampling=False, conservative_rasterization=False,
      voxelization_image_resolution_multiplier=8)
  vox_fgbg_32_subgrid = c.VoxelizationConfig(
      task_type=c.TaskType.FG_BG, resolution=c.Resolution(32, 32, 32),
      sub_grid_sampling=True, conservative_rasterization=False,
      voxelization_image_resolution_multiplier=31)
  vox_sem_128 = dataclasses.replace(vox_fgbg_128,
                                    task_type=c.TaskType.SEMANTIC)

  common = dict(
      resnet50_imagenet_checkpoint="{resnet_cpt}",
      checkpoint_interval=10000,
      persistent_checkpoint_interval=500000,
      last_upscale_factor=2,
      latent_channels=64,
      skip_fraction=0.75,
      max_steps=16000000,
      tensorboard_log_interval=1000,
      initial_learning_rate=0.0004,
      adam_epsilon=0.0001,
  )

  def train_pipeline(name, table, collection, vox, eval_vox,
                     random_grid_offset):
    # Training consumes train + val of the collection, reshuffled each
    # epoch (test is held out for the eval tiers).
    train_datasets = [
        dataclasses.replace(table[collection][split],
                            shuffle=c.ShuffleType.PER_EPOCH)
        for split in ("train", "val")
    ]
    return c.TrainPipeline(
        string_templates=templates,
        train=c.TrainConfig(
            data=c.DataPipeline(
                datasets=train_datasets,
                data_loader=default_data_loader(),
                shuffle=c.ShuffleType.PER_EPOCH,
                voxelization_config=vox),
            random_grid_offset=random_grid_offset, **common),
        eval=create_evals(table, collection, eval_vox),
        output_path=f"{{output_dir}}/{name}")

  return {
      "h5": train_pipeline("h5", lo, "single", vox_fgbg_128, vox_fgbg_128,
                           False),
      "h7": train_pipeline("h7", hi, "single", vox_fgbg_128, vox_fgbg_128,
                           False),
      "y1": train_pipeline("y1", hi, "single", vox_fgbg_32_subgrid,
                           vox_fgbg_128, True),
      "m7": train_pipeline("m7", hi, "pairs", vox_sem_128, vox_sem_128,
                           False),
      "m9": train_pipeline("m9", hi, "triplets", vox_sem_128, vox_sem_128,
                           False),
  }


def build_tf_eval_pipelines():
  templates = common_string_templates() + [
      c.StringTemplate(key="paper_tf_models_dir",
                       value="{data_dir}/paper_tf_models"),
      c.StringTemplate(key="output_dir", value="output/paper_tf_models"),
  ]
  hi = dataset_table(high_realism=True)
  lo = dataset_table(high_realism=False)

  vox_fgbg = c.VoxelizationConfig(
      task_type=c.TaskType.FG_BG, resolution=c.Resolution(128, 128, 128),
      sub_grid_sampling=False, conservative_rasterization=False,
      voxelization_image_resolution_multiplier=4,
      voxelization_projection_depth_multiplier=1)
  # h7 was evaluated with depth multiplier 2 in the paper (a bug kept for
  # bit-exact reproduction).
  vox_h7 = dataclasses.replace(vox_fgbg,
                               voxelization_projection_depth_multiplier=2)
  vox_sem = dataclasses.replace(vox_fgbg, task_type=c.TaskType.SEMANTIC)
  loader = c.DataLoaderConfig(num_data_workers=6, batch_size=8)

  def tf_eval(name, dataset, vox):
    return c.TfModelEvalPipeline(
        string_templates=templates,
        eval_config=c.EvalConfig(
            name="full_eval", num_qualitative_results=40,
            num_qualitative_results_in_tensor_board=0,
            data=c.DataPipeline(
                datasets=[dataset], shuffle=c.ShuffleType.ONCE,
                data_loader=loader, voxelization_config=vox)),
        frozen_graph_path=f"{{paper_tf_models_dir}}/{name}.pb",
        output_path=f"{{output_dir}}/{name}")

  return {
      "h5": tf_eval("h5", lo["single"]["test"], vox_fgbg),
      "h7": tf_eval("h7", hi["single"]["test"], vox_h7),
      "m7": tf_eval("m7", hi["pairs"]["test"], vox_sem),
      "m9": tf_eval("m9", hi["triplets"]["test"], vox_sem),
      "y1": tf_eval("y1", lo["single"]["test"], vox_fgbg),
  }


# ------------------------------------------------------ JSON schema gen ----
def json_schema(cls) -> dict:
  """Minimal JSON-schema generation from the config dataclasses."""
  import types

  def type_schema(tp):
    origin = typing.get_origin(tp)
    if origin in (typing.Union, types.UnionType):
      args = [a for a in typing.get_args(tp) if a is not type(None)]
      return type_schema(args[0])
    if origin in (list, List):
      return {"type": "array", "items": type_schema(typing.get_args(tp)[0])}
    if origin is tuple:
      args = typing.get_args(tp)
      return {"type": "array",
              "items": [type_schema(a) for a in args if a is not Ellipsis]}
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
      return {"enum": [v.value for v in tp]}
    if dataclasses.is_dataclass(tp):
      return {"$ref": f"#/definitions/{tp.__name__}"}
    return {int: {"type": "integer"}, float: {"type": "number"},
            str: {"type": "string"}, bool: {"type": "boolean"}}.get(
                tp, {})

  definitions = {}

  def collect(tp):
    origin = typing.get_origin(tp)
    if origin is not None:
      for a in typing.get_args(tp):
        if a is not Ellipsis and a is not type(None):
          collect(a)
      return
    if isinstance(tp, type) and dataclasses.is_dataclass(tp):
      if tp.__name__ in definitions:
        return
      hints = typing.get_type_hints(tp)
      props, required = {}, []
      definitions[tp.__name__] = True  # placeholder vs recursion
      for f in dataclasses.fields(tp):
        props[f.name] = type_schema(hints[f.name])
        if (f.default is dataclasses.MISSING and
            f.default_factory is dataclasses.MISSING):
          required.append(f.name)
        collect(hints[f.name])
      definitions[tp.__name__] = {
          "type": "object", "properties": props, "required": required}

  collect(cls)
  root = definitions.pop(cls.__name__)
  return {"$schema": "http://json-schema.org/draft-07/schema#",
          **root, "definitions": definitions}


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--output_dir", default="configs")
  args = parser.parse_args(argv)

  def dump(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    d = config_to_dict(obj)
    with open(path, "w") as f:
      f.write("//Generated automatically, by generate_configs.py\n")
      json.dump(d, f, indent=2)
    print("wrote", path)

  for name, tp in build_train_pipelines().items():
    dump(os.path.join(args.output_dir, "models", f"{name}.json5"), tp)
  for name, tp in build_tf_eval_pipelines().items():
    dump(os.path.join(args.output_dir, "paper_tf_models", f"{name}.json5"),
         tp)

  schema_dir = os.path.join(args.output_dir, "schemas")
  os.makedirs(schema_dir, exist_ok=True)
  for cls, fname in [(c.TrainPipeline, "train_config.json"),
                     (c.TfModelEvalPipeline, "tf_model_eval_config.json")]:
    with open(os.path.join(schema_dir, fname), "w") as f:
      json.dump(json_schema(cls), f, sort_keys=True, indent=2)
    print("wrote schema", fname)


if __name__ == "__main__":
  main()
