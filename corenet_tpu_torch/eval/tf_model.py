"""Inference through the paper's released frozen TensorFlow graphs.

Counterpart of corenet_tpu/eval/tf_model.py. `TfFrozenGraphModel` loads a
frozen GraphDef, reads its baked `output_resolution` constant, and wraps
`import_graph_def` in a tf.function mapping {input_image (float NHWC),
camera_transform, grid_offset, view_to_voxel_transform} → class_pdf. The
graphs emit channel-last PMFs ([B, D, H, W, C]), the port's public
layout, so nothing is transposed. TensorFlow runs on the host CPU, and is
imported when a graph is loaded (it is optional);
`super_resolution_from_tf_model` moves each PMF to the eval pipeline's
device, where super-resolution interleaves it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from corenet_tpu_torch.eval.super_resolution import SuperResolutionInference
from corenet_tpu_torch.utils import fs
from corenet_tpu_torch.utils.device import checked_device


def _host_array(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().float().numpy()
  return np.asarray(x, np.float32)


class TfFrozenGraphModel:
  """A multi-offset inference function over a frozen CoreNet TF graph."""

  def __init__(self, graph_path: str):
    graph_bytes = fs.read_bytes(graph_path)
    try:
      import tensorflow as tf
    except ImportError as e:
      raise ImportError("frozen TF graphs (.pb) need tensorflow, which is "
                        "not installed") from e
    self._tf = tf
    tf1 = tf.compat.v1
    graph_def = tf1.GraphDef.FromString(graph_bytes)
    resolution_node = [
        v.attr["value"] for v in graph_def.node
        if v.name == "output_resolution"][0].tensor
    if resolution_node.dtype != tf.int32.as_datatype_enum:
      raise ValueError(f"{graph_path}: output_resolution is not int32")
    # (depth, height, width, channels)
    self.output_shape: Tuple[int, ...] = tuple(
        int(v) for v in np.frombuffer(resolution_node.tensor_content,
                                      dtype=np.int32))

    @tf.function
    def call_graph(input_image, camera_transform, view_to_voxel_transform,
                   grid_offset):
      pmf, = tf1.import_graph_def(
          graph_def,
          input_map={
              "input_image": input_image,
              "camera_transform": camera_transform,
              "grid_offset": grid_offset,
              "view_to_voxel_transform": view_to_voxel_transform,
          },
          return_elements=["class_pdf:0"])
      return pmf

    self._call_graph = call_graph

  def __call__(self, input_image, camera_transform, view_to_voxel_transform,
               grid_offsets) -> np.ndarray:
    """image uint8/float [B, H, W, 3]; offsets float32[O, B, 3] (arrays or
    tensors) → pmf float32[O, B, d, h, w, C] on the host."""
    tf = self._tf
    image = tf.convert_to_tensor(_host_array(input_image))
    camera = tf.convert_to_tensor(_host_array(camera_transform))
    v2x = tf.convert_to_tensor(_host_array(view_to_voxel_transform))
    offsets = _host_array(grid_offsets)
    pmfs = [
        self._call_graph(image, camera, v2x,
                         tf.convert_to_tensor(offsets[i]))
        for i in range(offsets.shape[0])
    ]
    return np.stack([np.asarray(p) for p in pmfs], axis=0)


def super_resolution_from_tf_model(graph_path: str, device="cuda"
                                   ) -> SuperResolutionInference:
  """Super-resolution inference over a frozen graph at its baked
  resolution; the PMFs go to `device`."""
  device = checked_device(device)
  model = TfFrozenGraphModel(graph_path)

  def inference_fn(image, camera, v2x, offsets) -> torch.Tensor:
    return torch.from_numpy(model(image, camera, v2x, offsets)).to(device)

  return SuperResolutionInference(inference_fn, model.output_shape[:-1],
                                  device)
