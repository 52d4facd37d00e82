"""Imports a released PyTorch CoreNet checkpoint into a `.cpt`.

Counterpart of corenet_tpu/cli/import_corenet_checkpoint.py. The paper's
re-trained h5/h7/m7/m9 checkpoints are torch-saved `SavedState` objects
(or plain dicts) whose `model_state` is the original PyTorch CoreNet's
state dict. `convert_torch_state` maps every tensor onto the JAX
package's flat variable tree (OIHW → HWIO for 2D convolutions,
(I, O, kd, kh, kw) → DHWIO for transposed 3D ones, (O, I, kd, kh, kw) →
DHWIO for 3D ones, [out, in] → [in, out] for the latent linear, the
BatchRenorm buffers to 'batch_stats'), and models/convert.py maps that
tree onto the port's CoreNet (`reference_state_dict` is the inverse
mapping). `main` writes a `.cpt` (a fresh Adam
state) whose extra_metadata embeds the matching train pipeline config,
so `python -m corenet_tpu_torch.cli.eval` (or the JAX package's) serves
it directly.

Usage:
  python -m corenet_tpu_torch.cli.import_corenet_checkpoint \\
      --torch_checkpoint=h7.cpt --train_config=configs/models/h7.json5 \\
      --output_path=out/h7_imported.cpt [-D data_dir=...]
"""

from __future__ import annotations

import dataclasses
import io
import logging
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from corenet_tpu_torch.utils import flags, fs

log = logging.getLogger(__name__)

_STAGE_BLOCKS = {2: "abc", 3: "abcd", 4: "abcdef", 5: "abc"}
_OPS = {"op_a": "a", "op_b": "b", "op_c": "c", "shortcut": "shortcut"}
_CONV2D = (2, 3, 1, 0)       # [O, I, kh, kw] → HWIO
_CONV3D = (2, 3, 4, 1, 0)    # Conv3d [O, I, kd, kh, kw] → DHWIO
_CONV3D_T = (2, 3, 4, 0, 1)  # ConvTranspose3d [I, O, kd, kh, kw] → DHWIO
_LINEAR = (1, 0)             # [out, in] → [in, out]

# (flat key, released key, axes): flat = np.transpose(released, axes), or
# the released value itself where axes is None.
Entry = Tuple[str, str, Optional[Tuple[int, ...]]]


def _bn_entries(tprefix: str, prefix: str) -> List[Entry]:
  return [(f"params/{prefix}/scale", f"{tprefix}.weight", None),
          (f"params/{prefix}/bias", f"{tprefix}.bias", None),
          (f"batch_stats/{prefix}/mean", f"{tprefix}.running_mean", None),
          (f"batch_stats/{prefix}/var", f"{tprefix}.running_var", None),
          (f"batch_stats/{prefix}/steps", f"{tprefix}.num_batches_tracked",
           None)]


def _conv_entries(tprefix: str, prefix: str, axes) -> List[Entry]:
  return [(f"params/{prefix}/kernel", f"{tprefix}.weight", axes),
          (f"params/{prefix}/bias", f"{tprefix}.bias", None)]


def _entries(skip_stages) -> List[Entry]:
  """The mapping of a CoreNet whose ray-traced skips at `skip_stages`
  compress their channels (all four unless skip_fraction is 0)."""
  out = (_conv_entries("encoder.stage1.conv", "encoder/stage1_conv", _CONV2D)
         + _bn_entries("encoder.stage1_part2.bn", "encoder/stage1_bn"))
  for stage, blocks in _STAGE_BLOCKS.items():
    for block in blocks:
      for top, ours in _OPS.items():
        if top == "shortcut" and block != "a":
          continue
        tp = f"encoder.stage{stage}.{block}.{top}"
        mp = f"encoder/stage{stage}{block}"
        out += _conv_entries(f"{tp}.conv", f"{mp}/conv_{ours}", _CONV2D)
        out += _bn_entries(f"{tp}.bn", f"{mp}/bn_{ours}")
  out += _conv_entries("decoder.stage_0", "decoder/stage_0", _LINEAR)
  out += _bn_entries("decoder.stage_1.b1", "decoder/stage_1_bn")
  out += _conv_entries("decoder.stage_1.t1", "decoder/stage_1_t", _CONV3D_T)
  for stage in range(2, 7):
    tp = f"decoder.stage_{stage}"
    mp = f"decoder/stage_{stage}"
    out += _bn_entries(f"{tp}.b1", f"{mp}_bn1")
    out += _bn_entries(f"{tp}.b2", f"{mp}_bn2")
    out += _conv_entries(f"{tp}.c1", f"{mp}_c", _CONV3D)
    out += _conv_entries(f"{tp}.t1", f"{mp}_t", _CONV3D_T)
  for stage in sorted(skip_stages):
    out += _conv_entries(f"decoder.rt_skip_{stage}.compress_channels",
                         f"decoder/rt_skip_{stage}/compress_channels",
                         _CONV2D)
  return out


def convert_torch_state(torch_state: Mapping[str, Any]
                        ) -> Dict[str, np.ndarray]:
  """A released CoreNet state dict (tensors or arrays) → the JAX
  package's flat variable tree, "params/..." and "batch_stats/...", with
  the BatchRenorm step counters in int32."""
  t = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
       for k, v in torch_state.items()}
  skips = [s for s in range(2, 6)
           if f"decoder.rt_skip_{s}.compress_channels.weight" in t]
  out: Dict[str, np.ndarray] = {}
  for flat_key, key, axes in _entries(skips):
    value = t[key] if axes is None else np.transpose(t[key], axes)
    out[flat_key] = (np.asarray(value, np.int32)
                     if flat_key.endswith("/steps") else value)
  return out


def reference_state_dict(flat: Mapping[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
  """The inverse of `convert_torch_state`: the JAX package's flat tree →
  a state dict in the released CoreNet's names and layouts (the step
  counters in int64, as torch's BatchNorm keeps them)."""
  skips = [s for s in range(2, 6)
           if f"params/decoder/rt_skip_{s}/compress_channels/kernel" in flat]
  out = {}
  for flat_key, key, axes in _entries(skips):
    value = np.asarray(flat[flat_key])
    if axes is not None:
      value = np.transpose(value, np.argsort(axes))
    if flat_key.endswith("/steps"):
      value = value.astype(np.int64)
    out[key] = torch.from_numpy(np.array(value, order="C"))
  return out


def read_torch_checkpoint(data: bytes) -> Tuple[Dict[str, Any], int]:
  """(model state dict, global step) of a released checkpoint's bytes: a
  pickled `SavedState` (with `model_state` and `global_step`) or a plain
  dict, with or without "model_state"."""
  blob = torch.load(io.BytesIO(data), map_location="cpu",
                    weights_only=False)
  if hasattr(blob, "model_state"):
    return dict(blob.model_state), int(blob.global_step)
  return dict(blob.get("model_state", blob)), int(blob.get("global_step",
                                                           0))


@dataclasses.dataclass
class ProgramArgs:
  torch_checkpoint: str = flags.flag("Released CoreNet .cpt (torch-saved)")
  train_config: str = flags.flag(
      "Matching train pipeline JSON5 (e.g. configs/models/h7.json5)")
  output_path: str = flags.flag("Output .cpt path")
  template_value: List[str] = flags.flag("-D key=value template overrides",
                                         default=[], short_name="D",
                                         repeated=True)


def main(argv=None):
  logging.basicConfig(level=logging.INFO)
  args = flags.parse_flags(ProgramArgs, argv)

  from corenet_tpu_torch.cli.import_resnet50_checkpoint import (
      merge_variables)
  from corenet_tpu_torch.config import (
      TrainPipeline, config_to_dict, load_config_file,
      parse_template_mapping)
  from corenet_tpu_torch.data.manager import DatasetManager
  from corenet_tpu_torch.models.corenet import CoreNet
  from corenet_tpu_torch.train import checkpoint as cpt_lib
  from corenet_tpu_torch.train import state as state_lib
  from corenet_tpu_torch.train.pipeline import model_config_from_train_config

  model_state, global_step = read_torch_checkpoint(
      fs.read_bytes(args.torch_checkpoint))
  flat = convert_torch_state(model_state)

  config = load_config_file(
      args.train_config, TrainPipeline,
      template_overrides=parse_template_mapping(args.template_value))
  classes = DatasetManager(config.train.data).classes
  model = CoreNet(model_config_from_train_config(config.train, len(classes)))
  # Seeded weights for whatever the file does not hold (a released
  # checkpoint holds every entry); the strict merge checks each shape.
  model.reset_parameters(torch.Generator().manual_seed(0))
  model.load_state_dict(merge_variables(model.state_dict(), flat,
                                        args.torch_checkpoint))
  state = state_lib.create_train_state(
      model, config.train.initial_learning_rate, config.train.adam_epsilon,
      global_step=global_step, device="cpu")
  meta = {"train_config": config_to_dict(config.train),
          "full_config": config_to_dict(config),
          "classes": list(classes),
          "imported_from": args.torch_checkpoint}
  fs.makedirs(fs.dirname(args.output_path))
  fs.write_bytes(args.output_path, cpt_lib.encode_state(state, meta))
  log.info("Wrote %s (step %d, %d tensors)", args.output_path, global_step,
           len(flat))
  return state


if __name__ == "__main__":
  main()
