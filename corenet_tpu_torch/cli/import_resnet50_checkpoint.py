"""Reads an imported ResNet-50 encoder `.npz` into a CoreNet state dict.

Counterpart of the reading half of corenet_tpu/cli/import_resnet50_checkpoint.py,
numpy only. The file holds flat keys in the JAX package's tree and layouts:

  params/encoder/<module>/<name>       (kernel, bias, scale)
  batch_stats/encoder/<module>/<name>  (mean, var, steps)

`load_encoder_variables` maps them through models/convert.py onto the
port's state_dict keys and layouts. The Keras h5 importer that writes
such a file is not ported yet.
"""

from __future__ import annotations

import io
from typing import Dict, Mapping

import numpy as np
import torch

from corenet_tpu_torch.models.convert import state_dict_from_jax
from corenet_tpu_torch.utils import fs


def flat_tree_to_nested(flat: Mapping[str, np.ndarray]) -> Dict:
  """{"a/b/c": v} → {"a": {"b": {"c": v}}}."""
  nested: Dict = {}
  for key, value in flat.items():
    node = nested
    parts = key.split("/")
    for p in parts[:-1]:
      node = node.setdefault(p, {})
    node[parts[-1]] = value
  return nested


def load_encoder_variables(state_dict: Mapping[str, torch.Tensor],
                           path: str) -> Dict[str, torch.Tensor]:
  """A copy of `state_dict` (a CoreNet's) with the entries of the encoder
  `.npz` at `path` in place of its own, each in the entry's dtype and on
  its device. Every key of the file must name an entry of the model with
  the same shape."""
  flat = dict(np.load(io.BytesIO(fs.read_bytes(path))))
  nested = flat_tree_to_nested(flat)
  loaded = state_dict_from_jax({"params": nested.get("params", {}),
                                "batch_stats": nested.get("batch_stats",
                                                          {})})
  out = dict(state_dict)
  for key, value in loaded.items():
    if key not in out:
      raise KeyError(f"{path}: {key} is not in the model")
    if tuple(value.shape) != tuple(out[key].shape):
      raise ValueError(f"{path}: {key} has shape {tuple(value.shape)}, the "
                       f"model {tuple(out[key].shape)}")
    out[key] = value.to(out[key].device, out[key].dtype)
  return out
