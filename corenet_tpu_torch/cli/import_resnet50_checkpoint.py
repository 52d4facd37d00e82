"""Imports Keras ResNet-50 ImageNet weights into an encoder `.npz`, and
reads such a file into a CoreNet state dict.

Counterpart of corenet_tpu/cli/import_resnet50_checkpoint.py, numpy only
(h5py is imported when a Keras file is read, and only then).
`convert_keras_h5` maps the Keras h5 layer names (conv1/bn_conv1,
res{S}{B}_branch{1,2a,2b,2c}, bn{S}{B}_branch...) onto the JAX package's
flat encoder tree; Keras stores HWIO kernels, the JAX package's layout,
so nothing is transposed. The file holds:

  params/encoder/<module>/<name>       (kernel, bias, scale)
  batch_stats/encoder/<module>/<name>  (mean, var, steps)

with the BatchRenorm step counters at 0. `load_encoder_variables` maps
such a file through models/convert.py onto the port's state_dict keys
and layouts (TrainPipeline's `resnet50_imagenet_checkpoint`).

Usage:
  python -m corenet_tpu_torch.cli.import_resnet50_checkpoint \\
      --keras_h5=<resnet50 notop weights .h5> --output_path=out.npz
(The weights are the Keras release's
resnet50_weights_tf_dim_ordering_tf_kernels_notop.h5; supply the file
locally.)
"""

from __future__ import annotations

import argparse
import io
from typing import Dict, Mapping

import numpy as np
import torch

from corenet_tpu_torch.models.convert import state_dict_from_jax
from corenet_tpu_torch.utils import fs

# Stage → block letters in Keras ResNet-50.
_BLOCKS = {2: "abc", 3: "abcd", 4: "abcdef", 5: "abc"}
_BRANCHES = {"2a": "a", "2b": "b", "2c": "c", "1": "shortcut"}


def _conv_entries(out: Dict[str, np.ndarray], prefix: str, group):
  out[f"params/{prefix}/kernel"] = np.asarray(group["kernel:0"], np.float32)
  out[f"params/{prefix}/bias"] = np.asarray(group["bias:0"], np.float32)


def _bn_entries(out: Dict[str, np.ndarray], prefix: str, group):
  out[f"params/{prefix}/scale"] = np.asarray(group["gamma:0"], np.float32)
  out[f"params/{prefix}/bias"] = np.asarray(group["beta:0"], np.float32)
  out[f"batch_stats/{prefix}/mean"] = np.asarray(group["moving_mean:0"],
                                                 np.float32)
  out[f"batch_stats/{prefix}/var"] = np.asarray(group["moving_variance:0"],
                                                np.float32)
  out[f"batch_stats/{prefix}/steps"] = np.zeros([], np.int32)


def convert_keras_h5(h5_bytes: bytes) -> Dict[str, np.ndarray]:
  """The Keras notop ResNet-50 h5 → the flat encoder tree."""
  try:
    import h5py
  except ImportError as e:
    raise ImportError("reading a Keras .h5 needs h5py, which is not "
                      "installed") from e
  out: Dict[str, np.ndarray] = {}
  with h5py.File(io.BytesIO(h5_bytes), "r") as f:
    def grp(name):
      g = f[name]
      # Keras h5 nests layer weights under the layer name twice.
      return g[name] if name in g else g

    _conv_entries(out, "encoder/stage1_conv", grp("conv1"))
    _bn_entries(out, "encoder/stage1_bn", grp("bn_conv1"))

    for stage, blocks in _BLOCKS.items():
      for block in blocks:
        for keras_branch, ours in _BRANCHES.items():
          if keras_branch == "1" and block != "a":
            continue  # identity blocks have no shortcut conv
          prefix = f"encoder/stage{stage}{block}"
          _conv_entries(out, f"{prefix}/conv_{ours}",
                        grp(f"res{stage}{block}_branch{keras_branch}"))
          _bn_entries(out, f"{prefix}/bn_{ours}",
                      grp(f"bn{stage}{block}_branch{keras_branch}"))
  return out


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


def merge_variables(state_dict: Mapping[str, torch.Tensor],
                    flat: Mapping[str, np.ndarray],
                    source: str) -> Dict[str, torch.Tensor]:
  """A copy of `state_dict` (a CoreNet's) with the flat JAX-tree entries
  of `flat` in place of its own, each in the entry's dtype and on its
  device. Every entry must name one of the model's with the same shape;
  `source` names the entries' origin in the errors."""
  nested = flat_tree_to_nested(flat)
  loaded = state_dict_from_jax({"params": nested.get("params", {}),
                                "batch_stats": nested.get("batch_stats",
                                                          {})})
  out = dict(state_dict)
  for key, value in loaded.items():
    if key not in out:
      raise KeyError(f"{source}: {key} is not in the model")
    if tuple(value.shape) != tuple(out[key].shape):
      raise ValueError(f"{source}: {key} has shape {tuple(value.shape)}, "
                       f"the model {tuple(out[key].shape)}")
    out[key] = value.to(out[key].device, out[key].dtype)
  return out


def load_encoder_variables(state_dict: Mapping[str, torch.Tensor],
                           path: str) -> Dict[str, torch.Tensor]:
  """`merge_variables` of the encoder `.npz` at `path`."""
  return merge_variables(state_dict,
                         dict(np.load(io.BytesIO(fs.read_bytes(path)))), path)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--keras_h5", required=True,
                      help="Path to Keras ResNet-50 notop weights h5")
  parser.add_argument("--output_path", required=True)
  args = parser.parse_args(argv)

  flat = convert_keras_h5(fs.read_bytes(args.keras_h5))
  buf = io.BytesIO()
  np.savez(buf, **flat)
  fs.write_bytes(args.output_path, buf.getvalue())
  print(f"Wrote {len(flat)} tensors to {args.output_path}")
  return flat


if __name__ == "__main__":
  main()
