"""Super-resolution inference: evaluate a native-resolution model at an
integer-multiple output resolution by interleaving m³ shifted passes.

Counterpart of corenet_tpu/eval/super_resolution.py: the output
resolution must be the native one times an integer m; the model decodes
once per offset of the m³ shifted-offset lattice with the view → voxel
transform scaled by 1/m, and the PMFs interleave into the fine grid. The
image is encoded once and only the decoder runs per offset. With
`batch_offsets` the m³ offsets fold into the batch dimension of one
decode instead of a loop of m³ decodes. With `packed_execution` the
decoder runs packed (models/packing.py) where the model's configuration
allows it.

On a CUDA device a product replays one CUDA graph per input signature
(`GraphPlan`): a request's launches become a few copies and one graph
launch.
"""

from __future__ import annotations

from typing import (Callable, Dict, Hashable, Mapping, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch
from torch import nn

from corenet_tpu_torch.models.corenet import CoreNet
from corenet_tpu_torch.models.decoder import packed_eligible
from corenet_tpu_torch.models.resnet50 import ResNet50Features
from corenet_tpu_torch.train.step import compute_v2s
from corenet_tpu_torch.utils import tracing
from corenet_tpu_torch.utils.device import checked_device

# (image, camera, v2x, offsets[m³, B, 3]) → pmf float32[m³, B, d, h, w, C]
MultiOffsetInferenceFn = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class SuperResolutionInference:
  """(image, camera, v2x, grid_offsets, output_resolution) → PMF
  float32[B, D, H, W, C] on `device`. Inputs may be numpy arrays or
  tensors; they are moved to `device`. Each call is a `serve.request`
  span (utils/tracing.py) whose id is the call's number, with the spans
  serve.to_device, serve.encode and serve.decode (or, replaying a CUDA
  graph, serve.replay) and serve.assemble."""

  def __init__(self, inference_fn: MultiOffsetInferenceFn,
               resolution: Tuple[int, int, int],
               device: torch.device):
    self.resolution = tuple(resolution)
    self.inference_fn = inference_fn
    self.device = torch.device(device)
    self._offset_cache = {}
    self._requests = 0

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
    self._requests += 1
    with tracing.span("serve.request", self._requests):
      with tracing.span("serve.to_device"):
        image = torch.as_tensor(image, device=self.device)
        camera_transform, view_to_voxel_transform, grid_offsets = (
            torch.as_tensor(t, dtype=torch.float32, device=self.device)
            for t in (camera_transform, view_to_voxel_transform,
                      grid_offsets))
        m = self.get_resolution_multiplier(output_resolution)
        native_offsets = self.get_native_offsets(output_resolution,
                                                 grid_offsets)
        # v2x @ diag(1/m, 1/m, 1/m, 1), as a column scaling.
        scale = torch.tensor([1 / m, 1 / m, 1 / m, 1.0],
                             dtype=torch.float32, device=self.device)
        v2x = view_to_voxel_transform * scale

      pmfs = self.inference_fn(image, camera_transform, v2x, native_offsets)
      with tracing.span("serve.assemble"):
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


class _MultiOffset(nn.Module):
  """One eval-mode evaluation of a CoreNet over m³ offsets: the image is
  encoded once, the decoder runs once per offset or, with batch_offsets,
  once over all of them folded into the batch."""

  def __init__(self, model: CoreNet, batch_offsets: bool):
    super().__init__()
    self.model = model
    self.batch_offsets = batch_offsets

  def forward(self, image, camera, v2x, grid_offsets):
    with tracing.span("serve.encode"):
      features = self.model.encode(image)
    with tracing.span("serve.decode"):
      v2s = compute_v2s(camera, v2x)
      if self.batch_offsets:
        k, b = grid_offsets.shape[:2]
        logits = self.model.decode(_tile_batch(features, k),
                                   v2s.repeat(k, 1, 1),
                                   grid_offsets.reshape(k * b, 3))
        pmf = torch.softmax(logits, dim=-1)
        return pmf.reshape((k, b) + pmf.shape[1:])
      return torch.stack([
          torch.softmax(self.model.decode(features, v2s, offset), dim=-1)
          for offset in grid_offsets])


# Input signatures that one product keeps a CUDA graph for.
MAX_GRAPHS = 4

EAGER, CAPTURE, REPLAY = "eager", "capture", "replay"


class GraphPlan:
  """Which way each call of one product goes, by its signature.

  The first call of a signature runs eagerly: it fills the packed
  decoder's cached device indices and lets cuDNN choose its algorithms.
  The second captures a CUDA graph and replays it; later ones replay it.
  While a profiler runs, a signature without a graph runs eagerly and its
  capture waits for a later call, so that a trace never holds a capture.
  At most `limit` signatures get a graph; calls of others run eagerly.
  """

  def __init__(self, limit: int = MAX_GRAPHS):
    self.limit = limit
    self.seen = set()
    self.graphs: Dict[Hashable, _Captured] = {}

  def way(self, signature: Hashable, profiling: bool) -> str:
    if signature in self.graphs:
      return REPLAY
    if signature not in self.seen:
      self.seen.add(signature)
      return EAGER
    if profiling or len(self.graphs) >= self.limit:
      return EAGER
    return CAPTURE


def signature(inputs: Tuple[torch.Tensor, ...]) -> Hashable:
  """What a graph is captured for: each input's shape, dtype and device
  (the offsets' shape carries the output resolution's m³ passes)."""
  return tuple((tuple(t.shape), t.dtype, t.device) for t in inputs)


class _Captured(NamedTuple):
  graph: "torch.cuda.CUDAGraph"
  inputs: Tuple[torch.Tensor, ...]  # the graph's static input buffers
  output: torch.Tensor              # its static output


class GraphedCall:
  """`fn` (MultiOffsetInferenceFn on CUDA tensors) through one CUDA graph
  per signature, as `GraphPlan` decides. The graphs read `fn`'s weights
  where they lie, so an in-place change of them is seen by the next
  replay. They share one memory pool, which goes with this object. Counts
  serve.graph.eager, serve.graph.captures or serve.graph.replays for each
  call; a replay is the span serve.replay."""

  def __init__(self, fn: MultiOffsetInferenceFn, device: torch.device):
    self.fn, self.device = fn, device
    self.plan = GraphPlan()
    self.pool = None

  @torch.inference_mode()
  def __call__(self, *inputs: torch.Tensor) -> torch.Tensor:
    key = signature(inputs)
    way = self.plan.way(key, tracing.profiling())
    if way == EAGER:
      tracing.count("serve.graph.eager")
      return self.fn(*inputs)
    with torch.cuda.device(self.device):
      if way == CAPTURE:
        tracing.count("serve.graph.captures")
        captured = self.plan.graphs[key] = self._capture(inputs)
        captured.graph.replay()
      else:
        tracing.count("serve.graph.replays")
        captured = self.plan.graphs[key]
        with tracing.span("serve.replay"):
          for static, x in zip(captured.inputs, inputs):
            static.copy_(x)
          captured.graph.replay()
    # The next replay overwrites the static output: the caller gets its
    # own copy. With several passes the assemble's interleave copies; a
    # single pass it only views, so that one is copied here.
    out = captured.output
    return out.clone() if out.shape[0] == 1 else out

  def _capture(self, inputs: Tuple[torch.Tensor, ...]) -> _Captured:
    """Captures `fn` on static copies of `inputs`, after one warm-up call
    on the capture's side stream (torch.cuda.graphs' recipe)."""
    static = tuple(x.clone() for x in inputs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
      self.fn(*static)
    torch.cuda.current_stream().wait_stream(side)
    if self.pool is None:
      self.pool = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    # thread_local: a loader thread's CUDA calls (a training run's
    # recurrent evals) do not break the capture.
    with torch.cuda.graph(graph, pool=self.pool, stream=side,
                          capture_error_mode="thread_local"):
      output = self.fn(*static)
    return _Captured(graph, static, output)


def _twin(model: CoreNet, packed_execution: bool) -> CoreNet:
  """An eval-mode CoreNet of `model`'s architecture on the meta device
  with fine float32 logits, packed where asked and eligible."""
  dc = model.config.decoder
  packed = packed_execution and packed_eligible(
      dc.resolution, dc.last_upscale_factor, model.pack_from_stage)
  return CoreNet(model.config, compute_dtype=model.compute_dtype,
                 packed_decoder=packed,
                 pack_from_stage=model.pack_from_stage, device="meta")


def super_resolution_inference_factory(
    model: CoreNet, resolution: Tuple[int, int, int],
    batch_offsets: Optional[bool] = None, packed_execution: bool = True,
    device="cuda"
) -> Callable[[Mapping[str, torch.Tensor]], SuperResolutionInference]:
  """Returns make(weights) → SuperResolutionInference, where `weights` is
  a CoreNet state dict (the keys of `model.state_dict()`, such as
  models/convert.py's `state_dict_from_jax` gives).

  `model` supplies the architecture, the compute dtype and
  pack_from_stage only (a bf16 training model is evaluated in bf16, as
  the JAX package's recurrent evals are). Every product evaluates one
  eval-mode twin of it (built on the meta device, fine float32 logits)
  through `torch.func.functional_call` over the given tensors, moved to `device`:
  tensors already there are used without a copy, so a training loop can
  pass its own model's state dict. Neither the factory nor `make` changes
  the caller's model: not its mode, its weights or its device.

  batch_offsets (None = on when max(native) ≤ 32, the JAX package's rule)
  decodes all m³ offsets as one batch instead of a loop of m³ decodes:
  the small per-pass convolutions batch up, and memory grows with m³·B.
  Convolution numerics may depend on the batch shape, so the two ways
  agree within float32 rounding, not bit for bit.

  packed_execution (default on, as in the JAX package) decodes through a
  packed twin where the configuration allows (last_upscale_factor 2, an
  even grid at the packing point), else the fine one. On the H100 in
  float32 the packed decoder serves h7 and y1 10–25 % faster: its wide
  convolutions take cuDNN's fast forward kernels where the fine one runs
  its transposed convolutions on the dgrad engine (chip_smoke.py phase 12,
  PERF.md). The model's own packed_decoder does not carry over, so a
  packed training model is evaluated fine unless this asks. The packed
  logits agree with the fine ones within the convolutions' rounding (the
  JAX package's envelope is 2e-3 · max|logit|).

  On a CUDA device each product replays a CUDA graph per input signature
  from a signature's second call on (`GraphedCall`, `GraphPlan`); the
  PMFs are the eager ones bit for bit.
  """
  device = checked_device(device)
  if batch_offsets is None:
    batch_offsets = max(resolution) <= 32
  twin = _MultiOffset(_twin(model, packed_execution), batch_offsets).eval()
  # Buffers outside the state dict (constants the modules derive from the
  # configuration) come from the caller's model.
  persistent = set(model.state_dict())
  constants = {"model." + name: buf.to(device)
               for name, buf in model.named_buffers()
               if name not in persistent}

  def make(weights: Mapping[str, torch.Tensor]) -> SuperResolutionInference:
    tensors = dict(constants)
    tensors.update(("model." + k, v.to(device)) for k, v in weights.items())

    @torch.inference_mode()
    def multi(image, camera, v2x, grid_offsets):
      return torch.func.functional_call(
          twin, tensors, (image, camera, v2x, grid_offsets), strict=True)

    if device.type == "cuda":
      multi = GraphedCall(multi, device)
    return SuperResolutionInference(multi, resolution, device)

  return make


def super_resolution_from_model(model: CoreNet,
                                weights: Mapping[str, torch.Tensor],
                                resolution: Tuple[int, int, int],
                                batch_offsets: Optional[bool] = None,
                                packed_execution: bool = True,
                                device="cuda") -> SuperResolutionInference:
  """One-shot convenience wrapper over the factory: `model`'s architecture
  with `weights` (a CoreNet state dict), on `device`, in eval mode. The
  caller's model is left as it is."""
  return super_resolution_inference_factory(
      model, resolution, batch_offsets=batch_offsets,
      packed_execution=packed_execution, device=device)(weights)
