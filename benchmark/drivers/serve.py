"""Serving driver: super-resolution inference (the eval and demo path,
`eval/super_resolution.py::super_resolution_from_model`) under an open
loop of requests, each one batch of seeded images with its cameras.

Traffic parameters: `batch` images of `image_hw`² per request, drawn from
a pool of `image_pool` seeded batches; each image's camera one of `views`
seeded views; requests due every 1 / `rate_per_s` seconds from the
window's start. A request's time runs from when it was due to when its
PMF is synchronized on the device. With `drain` the requests due inside
the window are all served, the last ones after its close (a paced cell,
below capacity); without it the window counts the scenes whose PMF was
complete inside it (a cell above capacity, whose queue grows).

`correct`: after the window, the PMFs of `sample` requests drawn from the
seed among the first `sample_from` are compared with the plain
reference's float32 forward (TF32 off), by the largest absolute gap of a
probability.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict

import numpy as np
import torch

from benchmark.harness import scenes, weights
from benchmark.reference import model as ref
from benchmark.reference import precision
from benchmark.reference import serve as ref_serve
from benchmark.counts import flops as flop_counts
from benchmark.counts import gather as gather_counts
from benchmark.counts.peaks import PEAK_FLOPS

VIEW_TABLE = 1 << 16  # requests whose views are drawn in advance


class Requests:
  """The traffic's inputs, on the host, from the seed."""

  def __init__(self, ctx):
    t = ctx.traffic
    rng = np.random.default_rng(ctx.seed)
    self.batch = t["batch"]
    self.images = torch.from_numpy(rng.integers(
        0, 256, (t["image_pool"], t["batch"], t["image_hw"], t["image_hw"],
                 3), dtype=np.uint8))
    self.views = torch.from_numpy(scenes.views(t["views"], rng))
    self.view_ids = torch.from_numpy(
        rng.integers(0, t["views"], (VIEW_TABLE, t["batch"])))
    out = ctx.config["serve"]["output_resolution"]
    self.output = out
    self.v2x = torch.diag(torch.tensor([float(out)] * 3 + [1.0])).expand(
        t["batch"], 4, 4).contiguous()
    self.offsets = torch.full((t["batch"], 3), 0.5)
    self.sample = sorted(rng.choice(t["sample_from"], t["sample"],
                                    replace=False).tolist())

  def inputs(self, i: int):
    return (self.images[i % len(self.images)],
            self.views[self.view_ids[i % VIEW_TABLE]], self.v2x,
            self.offsets)


class State:
  pass


def _float32(ctx):
  if ctx.config["serve"]["precision"] != "float32":
    raise ValueError("the serving driver runs float32 configurations")
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False


def _weights(ctx):
  m = ctx.config["model"]
  spec = weights.shapes((m["resolution"],) * 3, m["num_classes"],
                        m["latent_channels"], m["skip_fraction"],
                        m["last_upscale_factor"])
  return weights.make(spec, ctx.seed, ctx.device)


def setup(ctx) -> State:
  from corenet_tpu_torch import CoreNet, CoreNetConfig, DecoderConfig
  from corenet_tpu_torch.eval.super_resolution import (
      super_resolution_from_model)
  _float32(ctx)
  m = ctx.config["model"]
  s = State()
  s.ctx = ctx
  s.requests = Requests(ctx)
  s.weights = _weights(ctx)
  ctx.mark("inputs and weights")
  res = (m["resolution"],) * 3
  model = CoreNet(CoreNetConfig(DecoderConfig(
      res, m["num_classes"], m["last_upscale_factor"], m["latent_channels"],
      m["skip_fraction"])))
  s.infer = super_resolution_from_model(
      model, s.weights, res, packed_execution=ctx.config["serve"]["packed"],
      device=ctx.device)
  ctx.mark("program")
  for i in range(ctx.traffic["warmup_requests"]):
    s.infer(*s.requests.inputs(VIEW_TABLE - 1 - i), (s.requests.output,) * 3)
    _sync(ctx.device)
    ctx.mark(f"request {i + 1}")
  return s


def _sync(device):
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def window(s: State, seconds: float) -> Dict:
  t, req = s.ctx.traffic, s.requests
  out3 = (req.output,) * 3
  kept = {}
  due, start, done = [], [], []
  t0 = time.perf_counter()
  end = t0 + seconds
  i = 0
  while True:
    when = t0 + i / t["rate_per_s"]
    if when >= end or (not t["drain"] and time.perf_counter() >= end):
      break
    now = time.perf_counter()
    if when > now:
      time.sleep(when - now)
    begin = time.perf_counter()
    pmf = s.infer(*req.inputs(i), out3)
    _sync(s.ctx.device)
    finish = time.perf_counter()
    if i in req.sample:
      kept[i] = pmf
    due.append(when)
    start.append(begin)
    done.append(finish)
    i += 1
  window_s = max(end, done[-1]) - t0
  due, start, done = map(np.asarray, (due, start, done))
  finished = int((done <= end).sum())
  s.kept = kept
  s.window = dict(due=due, start=start, done=done)
  service, queue = (done - start) * 1e3, (start - due) * 1e3
  print(f"window: {i} requests, {finished} finished inside; service ms "
        f"p50 {np.percentile(service, 50):.2f} p95 "
        f"{np.percentile(service, 95):.2f} max {service.max():.2f}; queue "
        f"ms p95 {np.percentile(queue, 95):.2f} max {queue.max():.2f}",
        file=sys.stderr)
  e2e = {"serve_scenes_per_s": finished * req.batch / seconds,
         "serve_p95_ms": float(np.percentile(done - due, 95)) * 1e3}
  return {"e2e": e2e, "attempted": i, "failed": 0, "window_s": window_s,
          "requests": i, "units": i, "requests_log": s.window}


def counts(s: State, result: Dict) -> Dict:
  """What the per-layer metrics need beyond the trace: the model's
  operations and the gathers' bytes bound over the window's requests."""
  ctx, req = s.ctx, s.requests
  m = ctx.config["model"]
  native = m["resolution"]
  passes = (req.output // native) ** 3
  per_image = flop_counts.forward(ctx.traffic["image_hw"], native,
                                  m["num_classes"], m["latent_channels"],
                                  m["skip_fraction"],
                                  m["last_upscale_factor"], passes)
  n = result["requests"]
  views_bytes = _gather_bytes_per_view(s)
  ids = req.view_ids[np.arange(n) % VIEW_TABLE]
  gather_bytes = float(views_bytes[ids].sum())
  return {"model_flops": per_image * req.batch * n,
          "peak_flops": PEAK_FLOPS["float32"],
          "gather_bound_s": gather_counts.bound_s(gather_bytes)}


def _gather_bytes_per_view(s: State) -> torch.Tensor:
  """Bytes of every skip gather of one image seen from each view, summed
  over the skips and super-resolution's passes (float32 rows)."""
  ctx, req = s.ctx, s.requests
  m = ctx.config["model"]
  native = m["resolution"]
  mult = req.output // native
  dev = ctx.device
  zz, yy, xx = np.meshgrid(*([np.arange(mult)] * 3), indexing="ij")
  offsets = torch.from_numpy((np.stack([xx, yy, zz], -1).reshape(-1, 3)
                              / mult).astype(np.float32)).to(dev) + 0.5 / mult
  k = offsets.shape[0]
  scale = torch.tensor([1 / mult] * 3 + [1.0], device=dev)
  v2x = torch.diag(torch.tensor([float(req.output)] * 3 + [1.0],
                                device=dev)) * scale
  ir = native // (16 * m["last_upscale_factor"])
  out = torch.zeros(len(req.views), dtype=torch.float64)
  taps = {5: 8, 4: 16, 3: 32, 2: 64}  # tap → its map's side at 256²
  hw = ctx.traffic["image_hw"]
  for v in range(len(req.views)):
    camera = req.views[v].to(dev)
    v2s = ref.compute_v2s(camera[None], v2x[None]).expand(k, 4, 4)
    layer = ir
    for stage in (2, 3, 4, 5):
      layer *= 2
      ratio = native / layer
      matrix = v2s * torch.tensor([ratio] * 3 + [1.0], device=dev)
      h2 = taps[ref.SKIPS[stage][1]] * hw // 256 + 2
      channels = round(ref.SKIPS[stage][0] * m["skip_fraction"])
      pixels = gather_counts.distinct_pixels(matrix, offsets, layer, h2)
      out[v] += gather_counts.launch_bytes(k, layer, channels, 4, pixels)
  return out


def _release(s: State) -> None:
  s.infer = None
  gc.collect()
  if s.ctx.device.type == "cuda":
    torch.cuda.empty_cache()


def _reference(ctx, req, w, i, low=None):
  """The reference's PMF of request i (`low`: a control's rounding)."""
  m = ctx.config["model"]
  image, camera, v2x, offsets = (t.to(ctx.device) for t in req.inputs(i))
  return ref_serve.pmf(dict(w), image, camera, v2x, offsets,
                       m["resolution"], req.output, ref.Precision(low=low))


def check(s: State):
  """[(name, value, limit)]: the largest probability gap over the
  sampled requests that the window served."""
  _release(s)
  ctx = s.ctx
  gap = 0.0
  for i, pmf in s.kept.items():
    gap = max(gap, float((pmf - _reference(ctx, s.requests, s.weights, i))
                         .abs().max()))
  s.kept = {}
  return [("pmf_gap", gap, ctx.cell["limits"]["pmf_gap"])]


def control(ctx) -> Dict:
  """The reference with TF32's operand rounding in the program's place,
  against the float32 reference, on the sampled requests."""
  _float32(ctx)
  req = Requests(ctx)
  w = _weights(ctx)
  gap = 0.0
  for i in req.sample:
    gap = max(gap, float((_reference(ctx, req, w, i, precision.tf32)
                          - _reference(ctx, req, w, i)).abs().max()))
  return {"pmf_gap": gap}


def fault(ctx, name: str) -> Dict:
  """A planted fault against the float32 reference: 'altered' zeroes the
  probabilities of one voxel of each sampled answer where it is made."""
  if name != "altered":
    raise ValueError(f"the serving driver plants no fault {name!r}")
  _float32(ctx)
  req = Requests(ctx)
  w = _weights(ctx)
  gap = 0.0
  for i in req.sample:
    want = _reference(ctx, req, w, i)
    got = want.clone()
    got.view(-1, got.shape[-1])[i % got[..., 0].numel()] = 0.0
    gap = max(gap, float((got - want).abs().max()))
  return {"pmf_gap": gap}
