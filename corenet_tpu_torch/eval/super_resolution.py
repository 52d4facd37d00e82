"""Super-resolution inference: evaluate a native-resolution model at an
integer-multiple output resolution by interleaving m³ shifted passes.

Counterpart of corenet_tpu/eval/super_resolution.py with
`packed_execution=False`: the output resolution must be the native one
times an integer m; the model decodes once per offset of the m³
shifted-offset lattice with the view → voxel transform scaled by 1/m, and
the PMFs interleave into the fine grid. The image is encoded once and only
the decoder runs per offset. With `batch_offsets` the m³ offsets fold into
the batch dimension of one decode instead of a loop of m³ decodes.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from corenet_tpu_torch.models.corenet import CoreNet
from corenet_tpu_torch.models.resnet50 import ResNet50Features
from corenet_tpu_torch.train.step import compute_v2s

# (image, camera, v2x, offsets[m³, B, 3]) → pmf float32[m³, B, d, h, w, C]
MultiOffsetInferenceFn = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class SuperResolutionInference:
  """(image, camera, v2x, grid_offsets, output_resolution) → PMF
  float32[B, D, H, W, C] on `device`. Inputs may be numpy arrays or
  tensors; they are moved to `device`."""

  def __init__(self, inference_fn: MultiOffsetInferenceFn,
               resolution: Tuple[int, int, int],
               device: torch.device):
    self.resolution = tuple(resolution)
    self.inference_fn = inference_fn
    self.device = torch.device(device)
    self._offset_cache = {}

  def get_resolution_multiplier(self,
                                output_resolution: Tuple[int, int, int]) -> int:
    out = np.asarray(output_resolution, np.float64)
    native = np.asarray(self.resolution, np.float64)
    mult = out / native
    if (np.floor(mult) != np.ceil(mult)).any() or (mult < 1).any() or (
        mult.min() != mult.max()):
      raise ValueError(
          "The output resolution should be divisible by the native "
          "resolution")
    return int(mult[0])

  def get_native_offsets(self, output_resolution: Tuple[int, int, int],
                         grid_offsets: torch.Tensor) -> torch.Tensor:
    """float32[m³, B, 3] sampling offsets in the native grid: the m³
    sub-voxel lattice plus the caller's offsets scaled down by m."""
    output_resolution = tuple(output_resolution)
    m = self.get_resolution_multiplier(output_resolution)
    if output_resolution not in self._offset_cache:
      zz, yy, xx = np.meshgrid(*([np.arange(m)] * 3), indexing="ij")
      offsets = np.stack([xx, yy, zz], -1).reshape(-1, 3) / m
      self._offset_cache[output_resolution] = torch.from_numpy(
          offsets.astype(np.float32)).to(self.device)
    offsets = self._offset_cache[output_resolution]
    return offsets[:, None] + grid_offsets[None, :] / m

  def __call__(self, image, camera_transform, view_to_voxel_transform,
               grid_offsets, output_resolution: Tuple[int, int, int]
               ) -> torch.Tensor:
    image = torch.as_tensor(image, device=self.device)
    camera_transform, view_to_voxel_transform, grid_offsets = (
        torch.as_tensor(t, dtype=torch.float32, device=self.device)
        for t in (camera_transform, view_to_voxel_transform, grid_offsets))
    m = self.get_resolution_multiplier(output_resolution)
    native_offsets = self.get_native_offsets(output_resolution, grid_offsets)

    # v2x @ diag(1/m, 1/m, 1/m, 1), as a column scaling.
    scale = torch.tensor([1 / m, 1 / m, 1 / m, 1.0], dtype=torch.float32,
                         device=self.device)
    v2x = view_to_voxel_transform * scale

    pmfs = self.inference_fn(image, camera_transform, v2x, native_offsets)
    b = image.shape[0]
    d, h, w, c = pmfs.shape[2:]
    pmfs = pmfs.reshape(m, m, m, b, d, h, w, c)
    # Interleave: fine[z*m+mz, y*m+my, x*m+mx] = pass (mz, my, mx).
    pmfs = pmfs.permute(3, 4, 0, 5, 1, 6, 2, 7)
    return pmfs.reshape(b, m * d, m * h, m * w, c)


def _tile_batch(features: ResNet50Features, k: int) -> ResNet50Features:
  """Each feature repeated k times along the batch, offset-major: entry
  o·B + b is scene b. Tiled in the encoder's own (N, C, H, W) layout."""
  def tile(f):
    if f.dim() == 2:
      return f.repeat(k, 1)
    return f.permute(0, 3, 1, 2).repeat(k, 1, 1, 1).permute(0, 2, 3, 1)
  return ResNet50Features(*(tile(f) for f in features))


def super_resolution_from_model(model: CoreNet, state_dict,
                                resolution: Tuple[int, int, int],
                                batch_offsets: Optional[bool] = None,
                                device="cuda") -> SuperResolutionInference:
  """Loads `state_dict` into `model`, moves it to `device` in eval mode and
  returns its SuperResolutionInference.

  batch_offsets (None = on when max(native) ≤ 32, the JAX package's rule)
  decodes all m³ offsets as one batch instead of a loop of m³ decodes:
  the small per-pass convolutions batch up, and memory grows with m³·B.
  Convolution numerics may depend on the batch shape, so the two ways
  agree within float32 rounding, not bit for bit.
  """
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
  model.load_state_dict(state_dict)
  model.to(device).eval()
  if batch_offsets is None:
    batch_offsets = max(resolution) <= 32

  @torch.inference_mode()
  def multi(image, camera, v2x, grid_offsets):
    v2s = compute_v2s(camera, v2x)
    features = model.encode(image)
    if batch_offsets:
      k, b = grid_offsets.shape[:2]
      logits = model.decode(_tile_batch(features, k), v2s.repeat(k, 1, 1),
                            grid_offsets.reshape(k * b, 3))
      pmf = torch.softmax(logits, dim=-1)
      return pmf.reshape((k, b) + pmf.shape[1:])
    return torch.stack([
        torch.softmax(model.decode(features, v2s, offset), dim=-1)
        for offset in grid_offsets])

  return SuperResolutionInference(multi, resolution, device)
