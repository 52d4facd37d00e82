#!/usr/bin/env python3
"""The PyTorch port's decoder executions against each other on one CUDA
card: the fine decoder with its transposed convolutions as torch's
`conv_transpose` ("dilated", the port's only lowering), the fine decoder
with the JAX package's "phased_fused" lowering of them (the JAX
package's default for the decoder's towers, not ported; it lives in this
script alone), and the packed decoder (pack_from_stage 5).

phased_fused computes a stride-2 transposed convolution as one stride-1
convolution that emits all 8 output phases (8·F channels), then a
depth-to-space: output 2q + r reads x[q + dj]·W[p + r − 2dj]
(corenet_tpu/models/layers.py). Here it replaces the forward of the
decoder's towers (3D, stride 2, more than one input cell per axis) while
a measurement runs.

Usage, from the root of the repository, on a machine with an NVIDIA
Hopper card and the CUDA toolkit:

  python3 tools/decoder_execution_sweep.py [--windows 5] [--per_window 10]

For h7 (128³, batch 4, 256² images) and y1 (32³ → 128³, its 64 passes in
one batch) serving in float32, and for the h7 training step on GT
voxelized in the step with the phase loss (chip_smoke.py phase 12's
batch) in bf16 and in float32, with TF32 off:
- the eval-mode logits of phased_fused and packed against the dilated
  ones (deterministic cuDNN), as a share of max|logit|;
- per execution chip_smoke.py's figures: median of 30 forwards or 20
  steps on the host clock, peak memory, one profiled forward or step
  (device busy time, idle share, cuDNN's dgrad / wgrad / other
  convolution shares);
- then `--windows` windows that run every execution in turn (the order
  rotates by window), each the median of `--per_window` forwards or steps:
  the host's spread, which single windows cannot separate from the
  executions' difference.
Logs each figure, and prints as its last line one JSON object of them.
"""

import argparse
import contextlib
import functools
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402

EXECUTIONS = ("fine dilated", "fine phased_fused", "packed pfs 5")


@functools.lru_cache(maxsize=None)
def _tap_plan(k, p):
  """(lo, taps) of phased_fused along one axis: output phase r reads
  x[q + lo + t]·W[p + r − 2(lo + t)] for the taps t whose kernel index
  lies in [0, k)."""
  lo = min(-((k - 1 - p - r) // 2) for r in (0, 1))
  hi = max((p + r) // 2 for r in (0, 1))
  return lo, hi - lo + 1


@functools.lru_cache(maxsize=None)
def _tap_index(k, p, device):
  """Flat index into the weight's k³ taps with one zero appended, in the
  order (r0, r1, r2, t0, t1, t2); k³ (the zero) outside the kernel."""
  import numpy as np
  import torch
  lo, taps = _tap_plan(k, p)
  r = np.arange(2)
  t = np.arange(taps)
  r0, r1, r2, t0, t1, t2 = np.meshgrid(r, r, r, t, t, t, indexing="ij")
  w = [p + rr - 2 * (lo + tt) for rr, tt in ((r0, t0), (r1, t1), (r2, t2))]
  valid = functools.reduce(np.logical_and, [(v >= 0) & (v < k) for v in w])
  flat = (w[0] * k + w[1]) * k + w[2]
  with torch.inference_mode(False):
    return torch.from_numpy(np.where(valid, flat, k ** 3).reshape(-1)).to(
        device)


def phased_fused(layer, x):
  """A decoder tower's ConvTranspose (3D, stride 2, cubic kernel, output
  twice its input) through the phased_fused lowering, with the layer's
  bias and compute dtype handled as ConvTranspose.forward handles them."""
  import torch
  import torch.nn.functional as F
  dtype = layer.compute_dtype
  xc = x if dtype is None else x.to(dtype)
  weight = layer.weight if dtype is None else layer.weight.to(dtype)
  cin, f, k = weight.shape[:3]
  p = layer.padding[0]
  if (weight.shape[2:] != (k, k, k) or len(set(layer.padding)) != 1
      or k - 2 * p + layer.output_padding[0] != 2):
    raise ValueError("phased_fused here takes a cubic kernel with an output "
                     "twice its input")
  lo, taps = _tap_plan(k, p)
  flat = F.pad(weight.reshape(cin, f, -1), (0, 1))
  kk = flat.index_select(2, _tap_index(k, p, weight.device))
  kk = kk.reshape(cin, f, 8, taps, taps, taps).permute(2, 1, 0, 3, 4, 5)
  kk = kk.reshape(8 * f, cin, taps, taps, taps)
  # Pads −lo below and lo + taps − 1 above; F.conv3d pads symmetrically, so
  # pad by the larger and crop the extra rows (views).
  pad = max(-lo, lo + taps - 1)
  y = F.conv3d(xc, kk, layer.bias.repeat(8) if dtype is None else None, 1,
               pad)
  for axis in (2, 3, 4):
    y = y.narrow(axis, pad + lo, x.shape[axis])
  if dtype is not None:
    y = y + layer.bias.repeat(8).to(dtype).view(-1, 1, 1, 1)
  if layer.phase_output:
    return y.permute(0, 2, 3, 4, 1)  # channel order (pz, py, px, f)
  b, _, q0, q1, q2 = y.shape
  y = y.reshape(b, 2, 2, 2, f, q0, q1, q2).permute(0, 4, 5, 1, 6, 2, 7, 3)
  return y.reshape(b, f, 2 * q0, 2 * q1, 2 * q2)


@contextlib.contextmanager
def lowering(name):
  """Runs the decoder towers' fine transposed convolutions through
  phased_fused while active, for the execution `name`."""
  from corenet_tpu_torch.models import layers
  if name != "fine phased_fused":
    yield
    return
  real = layers.ConvTranspose.forward

  def forward(self, x):
    if (self.packed_io or self.stride != (2, 2, 2)
        or min(x.shape[2:]) < 2):
      return real(self, x)
    return phased_fused(self, x)

  layers.ConvTranspose.forward = forward
  try:
    yield
  finally:
    layers.ConvTranspose.forward = real


def windows(name_fns, n_windows, per_window):
  """{name: [median ms of `per_window` calls, one per window]}, the names
  taking turns within each window in an order that rotates."""
  import torch
  names = list(name_fns)
  out = {name: [] for name in names}
  for w in range(n_windows):
    for name in names[w % len(names):] + names[:w % len(names)]:
      times = []
      with lowering(name):
        for _ in range(per_window):
          start = time.perf_counter()
          name_fns[name]()
          torch.cuda.synchronize()
          times.append((time.perf_counter() - start) * 1e3)
      out[name].append(statistics.median(times))
  for name, ms in out.items():
    smoke.log(f"  {name}: windows " + ", ".join(f"{v:.3f}" for v in ms)
              + f" ms; median {statistics.median(ms):.3f}")
  return out


def logit_shares(torch, CoreNet, config, state, label, image, v2s, offsets,
                 dev):
  """Eval-mode logits of phased_fused and packed against dilated's."""
  logits = {}
  torch.backends.cudnn.deterministic = True
  try:
    for name in EXECUTIONS:
      model = CoreNet(config, packed_decoder=name.startswith("packed"),
                      device=dev)
      model.load_state_dict(state)
      with torch.inference_mode(), lowering(name):
        logits[name] = model.eval()(image, v2s, offsets)
      del model
  finally:
    torch.backends.cudnn.deterministic = False
  ref = logits.pop("fine dilated")
  scale = float(ref.abs().max())
  shares = {name: float((got - ref).abs().max()) / scale
            for name, got in logits.items()}
  smoke.log(f"{label}: logits against the fine dilated ones: " + ", ".join(
      f"{k} {v:.2e}" for k, v in shares.items())
            + f" of max|logit| {scale:.3f}")
  return shares


def serving(torch, op, CoreNet, CoreNetConfig, DecoderConfig, image, camera,
            v2x, offsets, dev, args):
  from corenet_tpu_torch.eval.super_resolution import (
      SuperResolutionInference, super_resolution_from_model)
  from corenet_tpu_torch.train.step import compute_v2s
  inputs = (image, camera, v2x, offsets, smoke.OUTPUT_RES)
  shape = (smoke.BATCH,) + smoke.OUTPUT_RES + (2,)
  out = {}
  for path, native, seed in (("h7", smoke.OUTPUT_RES, smoke.SEED),
                             ("y1", smoke.Y1_NATIVE, smoke.SEED + 10)):
    config = CoreNetConfig(DecoderConfig(native, 2))
    _, state = smoke.seeded_model(torch, CoreNet, config, seed)
    m = smoke.OUTPUT_RES[0] // native[0]
    v2s = compute_v2s(camera.to(dev), v2x.to(dev) * torch.tensor(
        [1 / m, 1 / m, 1 / m, 1.0], device=dev))
    sample = SuperResolutionInference(None, native, dev).get_native_offsets(
        smoke.OUTPUT_RES, offsets.to(dev))[0]
    rows = {"logit_shares": logit_shares(
        torch, CoreNet, config, state, f"{path} serve", image.to(dev), v2s,
        sample, dev)}
    infers = {name: super_resolution_from_model(
        CoreNet(config), state, native,
        packed_execution=name.startswith("packed"), device="cuda")
              for name in EXECUTIONS}
    for name, infer in infers.items():
      with lowering(name):
        _, rows[name] = smoke.serve(torch, op, f"{path} {name}", infer,
                                    inputs, shape)
    smoke.log(f"{path} serve, alternating windows:")
    rows["windows_ms"] = windows(
        {name: functools.partial(infer, *inputs)
         for name, infer in infers.items()}, args.windows, args.per_window)
    del infers
    torch.cuda.empty_cache()
    out[path] = rows
  return out


def training(torch, CoreNet, CoreNetConfig, DecoderConfig, image, camera,
             dev, args):
  from corenet_tpu_torch.train.state import create_train_state
  from corenet_tpu_torch.train.step import make_train_step
  h7 = CoreNetConfig(DecoderConfig(smoke.OUTPUT_RES, 2))
  host, _ = smoke.triangle_batch(torch, image, camera, smoke.SEED + 41)
  batch = {k: v.to(dev) for k, v in host.items()}
  out = {}
  for dtype in (torch.bfloat16, torch.float32):
    dname = str(dtype).replace("torch.", "")
    runs = {}
    for name in EXECUTIONS:
      model, _ = smoke.seeded_model(
          torch, CoreNet, h7, smoke.SEED + 40, phase_output=True,
          compute_dtype=dtype if dtype == torch.bfloat16 else None,
          packed_decoder=name.startswith("packed"))
      state = create_train_state(model, device=dev)
      step = make_train_step(state.model, state.optimizer, "FG_BG",
                             smoke.OUTPUT_RES,
                             voxelization_kwargs=smoke.H7_VOX)
      with lowering(name):
        for _ in range(3):
          state, _ = step(state, batch)
        torch.cuda.synchronize()
        state, figures = smoke.timed_training(
            torch, f"h7 train {name}, {dname}", step, state, batch)
      holder = [state]

      def one_step(step=step, holder=holder):
        holder[0], _ = step(holder[0], batch)

      runs[name] = (figures, one_step)
    smoke.log(f"h7 train {dname}, alternating windows:")
    ms = windows({name: fn for name, (_, fn) in runs.items()},
                 args.windows, args.per_window)
    out[dname] = {name: dict(figures, windows_ms=ms[name])
                  for name, (figures, _) in runs.items()}
    del runs
    torch.cuda.empty_cache()
  return out


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print("decoder_execution_sweep: no CUDA device", file=sys.stderr)
    return 1
  parser = argparse.ArgumentParser()
  parser.add_argument("--windows", type=int, default=5)
  parser.add_argument("--per_window", type=int, default=10)
  args = parser.parse_args()
  from corenet_tpu_torch import kernels
  from corenet_tpu_torch.models.corenet import (
      CoreNet, CoreNetConfig, DecoderConfig)
  from corenet_tpu_torch.ops import skip_gather as op
  dev = torch.device("cuda", 0)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  kernels.build_all()
  camera, v2x = smoke.camera_and_v2x(torch, smoke.OUTPUT_RES[0])
  offsets = torch.full((smoke.BATCH, 3), 0.5)
  image = torch.randint(0, 256, (smoke.BATCH, smoke.IMAGE_HW,
                                 smoke.IMAGE_HW, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(smoke.SEED))
  start = time.perf_counter()
  result = {"device": torch.cuda.get_device_name(0),
            "serve": serving(torch, op, CoreNet, CoreNetConfig,
                             DecoderConfig, image, camera, v2x, offsets, dev,
                             args),
            "train": training(torch, CoreNet, CoreNetConfig, DecoderConfig,
                              image, camera, dev, args)}
  smoke.log(f"decoder execution sweep: {time.perf_counter() - start:.1f} s")
  print(json.dumps(result))
  return 0


if __name__ == "__main__":
  sys.exit(main())
