"""The port's CUDA kernels on the card, against their plain versions, and
the port's serving forward, training step, general ground truth (the
rasterizer, the dense fill, ray parity) and eval metrics on the card
against the CPU.

Every test here is marked `cuda` and skips without a CUDA device. The
file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch; there, run it without the suite's
conftest (which sets JAX up):

  python -m pytest --noconftest -p no:cacheprovider -m cuda \\
      tests/test_torch_cuda.py
"""

import re

import numpy as np
import pytest
import torch

from corenet_tpu_torch.data.batching import (
    VOXELIZE_WINDOW_PIXELS, _pad_to_bucket, subdivide_triangles)
from corenet_tpu_torch.eval import metrics, results
from corenet_tpu_torch.models import skip
from corenet_tpu_torch.models.corenet import (
    CoreNet, CoreNetConfig, DecoderConfig)
from corenet_tpu_torch.ops import block_scatter as scatter
from corenet_tpu_torch.ops import blocked_raster as raster
from corenet_tpu_torch.ops import fgbg_loss as fgbg
from corenet_tpu_torch.ops import phased_gt as phased
from corenet_tpu_torch.ops import skip_gather as op
from corenet_tpu_torch.train import gt
from corenet_tpu_torch.train.state import create_train_state
from corenet_tpu_torch.train.step import compute_v2s, make_train_step
from corenet_tpu_torch.utils import tracing
from corenet_tpu_torch.voxel import fill
from corenet_tpu_torch.voxel.packed import pack_grid
from corenet_tpu_torch.voxel.parity import parity_voxelize_batch

pytestmark = pytest.mark.cuda

# The four skips of the h7 decoder: padded map (H2, W2), channels, and
# the voxel count per scene.
H7_SKIPS = [(10, 10, 96, 512), (18, 18, 48, 4096), (34, 34, 24, 32768),
            (66, 66, 12, 262144)]
# The grid (D, H, W) that each case's voxels form, (z, y, x) order.
GRIDS = {512: (8, 8, 8), 4096: (16, 16, 16), 32768: (32, 32, 32),
         262144: (64, 64, 64), 700: (7, 10, 10), 333: (9, 37, 1)}


# The skip gather's forward and backward launch counters.
K1_LAUNCHES = ("skip_gather.launches", "skip_gather.backward_launches")
# The launch counters of a training step on GT voxelized in the step.
STEP_LAUNCHES = ("blocked_raster.launches", "phased_gt.launches",
                 "skip_gather.launches", "skip_gather.backward_launches",
                 "fgbg_loss.launches")


def _count(name: str) -> int:
  """A counter's total (corenet_tpu_torch/utils/tracing.py)."""
  return tracing.counters()[name]


def _counts(*names: str) -> tuple:
  totals = tracing.counters()
  return tuple(totals[n] for n in names)


@pytest.fixture
def device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  return torch.device("cuda", 0)


def _inputs(seed, b, h2, w2, c, n, device):
  rng = np.random.default_rng(seed)
  fmap = torch.from_numpy(
      rng.standard_normal((b, h2, w2, c)).astype(np.float32))
  px = torch.from_numpy(rng.integers(0, w2, (b, n)).astype(np.int32))
  py = torch.from_numpy(rng.integers(0, h2, (b, n)).astype(np.int32))
  return fmap.to(device), px.to(device), py.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h2,w2,c,n", H7_SKIPS + [(18, 18, 48, 700),
                                                  (9, 7, 5, 333)])
def test_skip_gather_kernel_equals_plain_version(device, h2, w2, c, n,
                                                 dtype):
  fmap, px, py = _inputs(h2 + n, 4, h2, w2, c, n, device)
  fmap = fmap.to(dtype)
  before = _count("skip_gather.launches")
  out = op.skip_gather(fmap, px, py, GRIDS[n])
  torch.cuda.synchronize()
  assert _count("skip_gather.launches") == before + 1
  assert out.dtype == dtype and out.shape == (4, n, c)
  assert torch.equal(out, op.skip_gather_reference(fmap, px, py))


def _scatter_bounds(dout, px, py, h2, w2):
  """The float64 scatter-add and the scatter-add of |dout|, per cell."""
  ref64 = op.skip_gather_backward_reference(dout.double(), px, py, h2, w2)
  s = op.skip_gather_backward_reference(dout.double().abs(), px, py, h2, w2)
  return ref64, s


# (h2, w2, c, n, indices): random indices with every fourth voxel on the
# hot pad cell at every shape; at the h7 shapes also every voxel on one
# pixel, a pixel that alternates along z, and the h7 path's own indices.
BACKWARD_CASES = (
    [s + ("random",) for s in H7_SKIPS + [(18, 18, 48, 700), (9, 7, 5, 333)]]
    + [s + (kind,) for s in H7_SKIPS
       for kind in ("one_pixel", "alternating", "h7_path")])


def _backward_indices(kind, h2, w2, n, device):
  grid = GRIDS[n]
  if kind == "random":
    _, px, py = _inputs(h2 + n, 4, h2, w2, 1, n, device)
    # Every fourth voxel reads the hot pad cell (0, 0), as voxels behind
    # the camera do.
    px[:, ::4] = 0
    py[:, ::4] = 0
    return px, py
  if kind == "one_pixel":
    px = torch.full((4, n), w2 // 2, dtype=torch.int32, device=device)
    return px, torch.full_like(px, h2 // 2)
  if kind == "alternating":  # two random pixels per column, by parity of z
    _, px, py = _inputs(n, 4, h2, w2, 1, 2 * n // grid[0], device)
    z_odd = torch.arange(grid[0], device=device).remainder(2)
    pick = lambda t: t.reshape(4, 2, -1)[:, z_odd].reshape(4, n).contiguous()
    return pick(px), pick(py)
  # The h7 path: the serving camera (f = 1.8 + 0.1 · scene, 1 unit in
  # front of the [0, 1]³ box) at 128³, the skip at layer resolution D.
  near, far = 0.5, 3.0
  a, b = (far + near) / (far - near), -2 * far * near / (far - near)
  camera = torch.tensor([[[f, 0, 0, -0.5 * f], [0, f, 0, -0.5 * f],
                          [0, 0, a, a + b], [0, 0, 1, 1.0]]
                         for f in (1.8, 1.9, 2.0, 2.1)], device=device)
  v2x = torch.diag(torch.tensor([128.0] * 3 + [1.0])).expand(4, 4, 4)
  div = 128 // grid[0]
  matrix = compute_v2s(camera, v2x.to(device)) * torch.tensor(
      [div, div, div, 1.0], device=device)
  return skip.voxel_pixel_indices(matrix, torch.full((4, 3), 0.5,
                                                     device=device),
                                  grid, h2 - 2, w2 - 2)


def _step_layout(dout, grid):
  """dout [B, N, C] re-laid as autograd hands it to the backward in the
  decoder: the channel slice of a [B, 16 + C, D, H, W] gradient."""
  b, n, c = dout.shape
  big = torch.randn((b, 16 + c) + grid, device=dout.device).to(dout.dtype)
  big[:, 16:] = dout.reshape((b,) + grid + (c,)).permute(0, 4, 1, 2, 3)
  return big[:, 16:].permute(0, 2, 3, 4, 1).reshape(b, n, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("columns", ["grid", "flat"])
@pytest.mark.parametrize("layout", ["contiguous", "step"])
@pytest.mark.parametrize("h2,w2,c,n,indices", BACKWARD_CASES)
def test_skip_gather_backward_kernel_matches_plain_version(
    device, h2, w2, c, n, indices, layout, columns, dtype):
  px, py = _backward_indices(indices, h2, w2, n, device)
  grid = GRIDS[n]
  dout = torch.randn((4, n, c), generator=torch.Generator().manual_seed(n))
  dout = dout.to(device, dtype)
  if layout == "step":
    dout = _step_layout(dout, grid)
    assert dout.stride() == ((16 + c) * n, 1, n)
  before = _count("skip_gather.backward_launches")
  got = op.skip_gather_backward(dout, px, py, h2, w2,
                                grid_resolution=grid if columns == "grid"
                                else (1, 1, n))
  torch.cuda.synchronize()
  assert _count("skip_gather.backward_launches") == before + 1
  assert got.dtype == dtype and got.shape == (4, h2, w2, c)
  ref64, s = _scatter_bounds(dout, px, py, h2, w2)
  plain = op.skip_gather_backward_reference(dout, px, py, h2, w2)
  # f32 summation order: |err| <= 1e-5 · Σ|dout| per cell; bf16 adds the
  # one rounding of the f32 sum.
  for out in (got, plain):
    err = (out.double() - ref64).abs()
    bound = 1e-5 * s + 1e-30
    if dtype == torch.bfloat16:
      bound = bound + _bf16_ulp(ref64)
    assert bool((err <= bound).all()), float((err - bound).max())


def _bf16_ulp(x):
  """The spacing of bfloat16 numbers at |x| (its smallest normal's at 0)."""
  mag = x.abs().to(torch.bfloat16).double().clamp(min=2.0 ** -126)
  return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def test_skip_gather_trains_through_both_kernels(device):
  fmap, px, py = _inputs(0, 2, 10, 10, 8, 64, device)
  fmap.requires_grad_(True)
  fwd, bwd = _counts(*K1_LAUNCHES)
  out = op.skip_gather(fmap, px, py, (1, 1, 64))
  dout = torch.randn_like(out)
  out.backward(dout)
  torch.cuda.synchronize()
  assert _counts(*K1_LAUNCHES) == (fwd + 1, bwd + 1)
  ref64, s = _scatter_bounds(dout, px, py, 10, 10)
  assert bool(((fmap.grad.double() - ref64).abs() <= 1e-5 * s + 1e-30).all())


@pytest.mark.parametrize("gt_dtype", [torch.int32, torch.uint8,
                                      torch.float32])
@pytest.mark.parametrize("diff_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n", [(4, 128 ** 3), (2, 32 ** 3), (3, 1001)])
def test_fgbg_sums_kernel_matches_plain_version(device, b, n, diff_dtype,
                                                gt_dtype):
  gen = torch.Generator().manual_seed(n)
  diff = (torch.randn((b, n), generator=gen) * 3).to(device, diff_dtype)
  gt = (torch.rand((b, n), generator=gen) < 0.3).to(device, gt_dtype)
  before = _count("fgbg_loss.launches")
  inter, union = fgbg.fgbg_sums(diff, gt)
  torch.cuda.synchronize()
  assert _count("fgbg_loss.launches") == before + 1
  ref_inter, ref_union = fgbg.fgbg_sums_reference(diff, gt)
  torch.testing.assert_close(inter, ref_inter, rtol=1e-6, atol=0)
  torch.testing.assert_close(union, ref_union, rtol=1e-6, atol=0)
  # No float atomics: the same inputs give the same sums.
  again = fgbg.fgbg_sums(diff, gt)
  assert torch.equal(again[0], inter) and torch.equal(again[1], union)


def test_fgbg_sums_gradient_on_card_matches_cpu(device):
  gen = torch.Generator().manual_seed(1)
  diff = torch.randn((2, 4096), generator=gen) * 3
  gt = (torch.rand((2, 4096), generator=gen) < 0.5).int()
  grads = []
  for dev in ("cpu", device):
    d = diff.to(dev, copy=True).requires_grad_(True)
    inter, union = fgbg.fgbg_sums(d, gt.to(dev))
    (1 - inter / union).mean().backward()
    grads.append(d.grad.cpu())
  torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-9)


def test_train_step_on_card_matches_cpu(device, monkeypatch):
  monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
  rng = np.random.default_rng(0)
  image = torch.from_numpy(
      rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8))
  camera = torch.diag(torch.tensor([1.8, 1.8, 1.8, 1.0])).repeat(2, 1, 1)
  camera[:, :3, 3] = -0.9
  grid = torch.zeros((2, 32, 32, 32), dtype=torch.int32)
  grid[:, 8:24, 6:26, 8:22] = 1
  batch = {"image": image, "camera": camera,
           "v2x": torch.diag(torch.tensor([32.0] * 3 + [1.0])).repeat(
               2, 1, 1),
           "grid": grid, "grid_offset": torch.full((2, 3), 0.5)}
  losses = []
  for dev in ("cpu", device):
    model = CoreNet(CoreNetConfig(DecoderConfig((32, 32, 32), 2)))
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = create_train_state(model, device=dev)
    step = make_train_step(state.model, state.optimizer, "FG_BG",
                           (32, 32, 32))
    counts = _counts(*K1_LAUNCHES, "fgbg_loss.launches")
    state, metrics = step(state, {k: v.to(dev) for k, v in batch.items()})
    losses.append(float(metrics["loss"]))
    assert state.global_step == 2
  assert _counts(*K1_LAUNCHES, "fgbg_loss.launches") == (
      counts[0] + 4, counts[1] + 4, counts[2] + 1)
  assert losses[1] == pytest.approx(losses[0], rel=1e-4)


def test_corenet_on_card_matches_cpu(device, monkeypatch):
  # Float32 on the card as on the CPU: no TF32 in the convolutions.
  monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
  model = CoreNet(CoreNetConfig(DecoderConfig((32, 32, 32), 2)))
  model.reset_parameters(torch.Generator().manual_seed(0))
  model.eval()
  rng = np.random.default_rng(0)
  image = torch.from_numpy(
      rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8))
  v2s = torch.diag(torch.tensor([1.8 / 32] * 3 + [1.0])).repeat(2, 1, 1)
  v2s[:, :3, 3] = -0.9
  offsets = torch.full((2, 3), 0.5)
  with torch.inference_mode():
    ref = model(image, v2s, offsets)
    model.to(device)
    before = _count("skip_gather.launches")
    got = model(image.to(device), v2s.to(device), offsets.to(device))
    assert _count("skip_gather.launches") == before + 4
  torch.testing.assert_close(got.cpu(), ref, rtol=2e-3,
                             atol=2e-3 * float(ref.abs().max()))


@pytest.mark.parametrize("b,t,meshes,hw,nw", [(2, 300, 2, 32, 1),
                                              (2, 300, 2, 32, 2),
                                              (4, 16384, 2, 128, 4)])
def test_block_scatter_kernel_equals_plain_version(device, b, t, meshes, hw,
                                                   nw):
  rng = np.random.default_rng(t + nw)
  slot = rng.integers(0, meshes, (b, t))
  oy = rng.integers(0, hw - 7, (b, t))
  ox = rng.integers(0, hw - 7, (b, t))
  origins = ((slot * hw + oy) * hw + ox).astype(np.int32)
  origins[:, 10:20] = origins[:, 9:10]  # a run of one origin
  origins[:, 30] = (meshes * hw - 8) * hw + hw - 8  # the last corner
  origins[:, 31] = hw - 7  # its block would leave the grid: skipped
  origins[rng.random((b, t)) < 0.25] = -1
  pw = rng.integers(-2 ** 31, 2 ** 31, (b, t, 8, 8 * nw), dtype=np.int64)
  pw[rng.random(pw.shape) < 0.7] = 0
  origins = torch.from_numpy(origins).to(device)
  pw = torch.from_numpy(pw.astype(np.int32)).to(device)
  before = _count("block_scatter.launches")
  got = scatter.block_scatter_or(origins, pw, meshes=meshes, h=hw, w=hw,
                                 nw=nw)
  again = scatter.block_scatter_or(origins, pw, meshes=meshes, h=hw, w=hw,
                                   nw=nw)
  torch.cuda.synchronize()
  assert _count("block_scatter.launches") == before + 2
  want = scatter.block_scatter_or_reference(origins, pw, meshes=meshes,
                                            h=hw, w=hw, nw=nw)
  assert torch.equal(got, want) and torch.equal(again, got)
  assert float((got != 0).float().mean()) > 0.05


def _raster_batch(m, irm, seed):
  """Two scenes for the blocked rasterizer at grid m and multiplier irm:
  the cube shell subdivided to irm's window contract, small seeded
  triangles (slots 0 and 1), zero-area ones (equal vertices, collinear),
  ones clipped at and beyond the grid's faces, invalid rows that hold
  triangles, and slots outside [0, 2)."""
  rng = np.random.default_rng(seed)
  max_edge = int(2.5 * irm) / irm / m
  lo, hi = 0.3, 0.7
  corners = np.array([[lo, lo, lo], [hi, lo, lo], [hi, hi, lo],
                      [lo, hi, lo], [lo, lo, hi], [hi, lo, hi],
                      [hi, hi, hi], [lo, hi, hi]], np.float32)
  faces = [(0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7), (0, 1, 5), (0, 5, 4),
           (2, 3, 7), (2, 7, 6), (1, 2, 6), (1, 6, 5), (0, 4, 7), (0, 7, 3)]
  cube = subdivide_triangles(corners[np.array(faces)], max_edge)
  point = rng.uniform(-0.03, 1.03, (600, 1, 3))
  point[:200, 0, rng.integers(0, 3, 200)] = rng.choice(
      [-0.01, 0.0, 0.999, 1.0, 1.01], 200)
  small = point + rng.uniform(-1, 1, (600, 3, 3)) * max_edge * 0.6
  small[:40] = point[:40]  # three equal vertices
  small[40:80, 1] = point[40:80, 0] + (small[40:80, 2] - point[40:80, 0]) / 2
  tris = np.concatenate([cube, small]).astype(np.float32)
  t = len(tris) + 32
  triangles = rng.uniform(0, 1, (2, t, 3, 3)).astype(np.float32)
  triangles[:, :len(tris)] = tris
  triangles[1, :len(tris)] += np.float32(0.02)
  slot = rng.integers(0, 2, (2, t)).astype(np.int32)
  slot[:, :4] = [2, -1, 1 << 20, -(1 << 20)]
  valid = np.zeros((2, t), bool)
  valid[:, :len(tris)] = rng.random((2, len(tris))) > 0.05
  offsets = torch.from_numpy(rng.uniform(0, 1, (2, 3)).astype(np.float32))
  return (torch.from_numpy(triangles), torch.from_numpy(slot),
          gt._view2voxel_uniform(offsets, float(m), 2),
          torch.from_numpy(valid))


@pytest.mark.parametrize("conservative", [False, True])
@pytest.mark.parametrize("m,irm", [(32, 1), (32, 2), (32, 3), (32, 8),
                                   (64, 8), (128, 1), (128, 8)])
def test_blocked_raster_kernel_equals_plain_version(device, m, irm,
                                                    conservative):
  inputs = [x.to(device) for x in _raster_batch(m, irm, m + irm)]
  kw = dict(meshes=2, m=m, irm=irm, conservative=conservative)
  before = _count("blocked_raster.launches")
  got = raster.blocked_raster_or(*inputs, **kw)
  again = raster.blocked_raster_or(*inputs, **kw)
  torch.cuda.synchronize()
  assert _count("blocked_raster.launches") == before + 2
  assert got.shape == (2, 2, m, m * (m // 32)) and got.dtype == torch.int32
  want = raster.blocked_raster_reference(*inputs, **kw)
  assert torch.equal(got, want) and torch.equal(again, got)
  assert int((got != 0).sum()) > 100


def test_blocked_raster_kernel_refuses_a_grid_it_was_not_built_for(device):
  inputs = [x.to(device) for x in _raster_batch(32, 8, 0)]
  with pytest.raises(RuntimeError, match="kernel launch failed"):
    raster.blocked_raster_or(*inputs, meshes=2, m=32, irm=1 << 20,
                             conservative=False)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("shape", [(2, 64, 64, 64), (1, 32, 48, 64),
                                   (4, 128, 128, 128)])
def test_phased_gt_kernel_equals_plain_version(device, s, shape):
  gen = torch.Generator().manual_seed(sum(shape) + s)
  grid = (torch.rand(shape, generator=gen) < 0.4).to(device)
  packed = pack_grid(grid)
  before = _count("phased_gt.launches")
  got = phased.phased_gt(packed, s)
  torch.cuda.synchronize()
  assert _count("phased_gt.launches") == before + 1
  assert got.dtype == torch.uint8
  assert torch.equal(got, phased.phased_gt_reference(packed, s))


@pytest.mark.parametrize("s,shape", [(2, (2, 32, 10, 6)),
                                     (4, (1, 64, 12, 20))])
def test_phased_gt_kernel_odd_cell_counts(device, s, shape):
  gen = torch.Generator().manual_seed(s)
  grid = (torch.rand(shape, generator=gen) < 0.5).to(device)
  packed = pack_grid(grid)
  got = phased.phased_gt(packed, s)
  assert torch.equal(got, phased.phased_gt_reference(packed, s))


def _cube_batch(res, batch=2):
  """Triangle batch: a subdivided cube shell per scene, shifted per
  scene, plus a second, empty mesh slot."""
  max_edge = (VOXELIZE_WINDOW_PIXELS - 4) / 8 / res
  lo, hi = 0.3, 0.7
  corners = np.array([[lo, lo, lo], [hi, lo, lo], [hi, hi, lo],
                      [lo, hi, lo], [lo, lo, hi], [hi, lo, hi],
                      [hi, hi, hi], [lo, hi, hi]], np.float32)
  faces = [(0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7), (0, 1, 5), (0, 5, 4),
           (2, 3, 7), (2, 7, 6), (1, 2, 6), (1, 6, 5), (0, 4, 7), (0, 7, 3)]
  tris = subdivide_triangles(corners[np.array(faces)], max_edge)
  t = _pad_to_bucket(len(tris))
  triangles = np.zeros((batch, t, 3, 3), np.float32)
  for i in range(batch):
    triangles[i, :len(tris)] = tris + np.float32(0.02 * i)
  valid = np.zeros((batch, t), bool)
  valid[:, :len(tris)] = True
  return {"triangles": torch.from_numpy(triangles),
          "tri_mesh_slot": torch.zeros((batch, t), dtype=torch.int32),
          "tri_valid": torch.from_numpy(valid),
          "mesh_labels": torch.tensor([[1, 0]] * batch, dtype=torch.int32),
          "grid_offset": torch.full((batch, 3), 0.5)}


def test_packed_gt_on_card_equals_cpu(device):
  batch = _cube_batch(64)
  kwargs = dict(resolution=(64, 64, 64), image_resolution_multiplier=8,
                conservative_rasterization=False,
                max_bbox_pixels=VOXELIZE_WINDOW_PIXELS)
  keys = ("triangles", "tri_mesh_slot", "tri_valid", "mesh_labels",
          "grid_offset")
  want, _ = gt.voxelize_batch_packed_fgbg(*(batch[k] for k in keys),
                                          **kwargs)
  before = _counts("blocked_raster.launches", "block_scatter.launches")
  got, v2x = gt.voxelize_batch_packed_fgbg(
      *(batch[k].to(device) for k in keys), **kwargs)
  assert _counts("blocked_raster.launches", "block_scatter.launches") == (
      before[0] + 1, before[1])
  assert torch.equal(got.cpu(), want)
  assert v2x.device == got.device


def test_phase_loss_train_step_on_card_matches_cpu(device, monkeypatch):
  monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
  rng = np.random.default_rng(0)
  batch = _cube_batch(32)
  batch["image"] = torch.from_numpy(
      rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8))
  batch["camera"] = torch.diag(torch.tensor([1.8, 1.8, 1.8, 1.0])).repeat(
      2, 1, 1)
  batch["camera"][:, :3, 3] = -0.9
  kwargs = dict(image_resolution_multiplier=8,
                conservative_rasterization=False,
                max_bbox_pixels=VOXELIZE_WINDOW_PIXELS)
  losses = []
  for dev in ("cpu", device):
    model = CoreNet(CoreNetConfig(DecoderConfig((32, 32, 32), 2)),
                    phase_output=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = create_train_state(model, device=dev)
    step = make_train_step(state.model, state.optimizer, "FG_BG",
                           (32, 32, 32), voxelization_kwargs=kwargs)
    counts = _counts(*STEP_LAUNCHES)
    state, metrics = step(state, {k: v.to(dev) for k, v in batch.items()})
    losses.append(float(metrics["loss"]))
  after = _counts(*STEP_LAUNCHES)
  assert tuple(a - c for a, c in zip(after, counts)) == (1, 1, 4, 4, 1)
  assert losses[1] == pytest.approx(losses[0], rel=1e-4)


def _to_packed(t, grid):
  """Fine-order [B, D·H·W] indices in the packed decoder's voxel order:
  8 phase grids (pz, py, px) of half the resolution, phase-outer."""
  d, h, w = grid
  return t.view(-1, d // 2, 2, h // 2, 2, w // 2, 2).permute(
      0, 2, 4, 6, 1, 3, 5).reshape(t.shape[0], -1).contiguous()


def _pad_ring_indices(h2, w2, grid, device):
  """Every voxel on a cell of the map's 1-px pad ring, the cell changing
  every 3 voxels along z and from column to column."""
  ring = ([(0, x) for x in range(w2)] + [(h2 - 1, x) for x in range(w2)]
          + [(y, 0) for y in range(1, h2 - 1)]
          + [(y, w2 - 1) for y in range(1, h2 - 1)])
  ring = torch.tensor(ring, dtype=torch.int32, device=device)
  d, h, w = grid
  z = torch.arange(d, device=device)[:, None]
  column = torch.arange(h * w, device=device)[None]
  cell = (z // 3 + column).remainder(len(ring)).reshape(1, -1)
  cell = (cell + torch.arange(4, device=device)[:, None]).remainder(len(ring))
  return ring[cell, 1].contiguous(), ring[cell, 0].contiguous()


@pytest.mark.parametrize("layout", ["step", "contiguous"])
@pytest.mark.parametrize("indices",
                         ["h7_path", "one_pixel", "alternating", "pad_ring"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h2,w2,c,n", H7_SKIPS)
def test_skip_gather_backward_packed_order_matches_plain_version(
    device, h2, w2, c, n, dtype, indices, layout):
  """The backward in the packed decoder's voxel order (8 phase grids of
  half the resolution, phase-outer; a thread walks both z phases of a
  fine column) at the four h7 skip shapes, with the h7 path's indices
  and contended ones (every voxel on one pixel, two pixels alternating
  along fine z, the pad ring), dout in the packed step's layout (the
  skip's channel slice of a per-phase [B, 8, 16 + C, D/2, H/2, W/2]
  gradient, read in place) and contiguous."""
  grid = GRIDS[n]
  half = tuple(v // 2 for v in grid)
  m = n // 8
  if indices == "pad_ring":
    fine_px, fine_py = _pad_ring_indices(h2, w2, grid, device)
  else:
    fine_px, fine_py = _backward_indices(indices, h2, w2, n, device)
  px, py = _to_packed(fine_px, grid), _to_packed(fine_py, grid)
  if indices == "h7_path":
    # The same camera's indices computed in packed order: each voxel
    # reads the pixel it reads in fine order.
    near, far = 0.5, 3.0
    a, b = (far + near) / (far - near), -2 * far * near / (far - near)
    camera = torch.tensor([[[f, 0, 0, -0.5 * f], [0, f, 0, -0.5 * f],
                            [0, 0, a, a + b], [0, 0, 1, 1.0]]
                           for f in (1.8, 1.9, 2.0, 2.1)], device=device)
    v2x = torch.diag(torch.tensor([128.0] * 3 + [1.0])).expand(4, 4, 4)
    div = 128 // grid[0]
    matrix = compute_v2s(camera, v2x.to(device)) * torch.tensor(
        [div, div, div, 1.0], device=device)
    packed_px, packed_py = skip.voxel_pixel_indices(
        matrix, torch.full((4, 3), 0.5, device=device), grid, h2 - 2,
        w2 - 2, packed=True)
    assert torch.equal(packed_px, px) and torch.equal(packed_py, py)
  dout = torch.randn((4, 8, m, c),
                     generator=torch.Generator().manual_seed(n))
  dout = dout.to(device, dtype)
  if layout == "step":
    big = torch.randn((4, 8, 16 + c) + half, device=device).to(dtype)
    big[:, :, 16:] = dout.view((4, 8) + half + (c,)).permute(
        0, 1, 5, 2, 3, 4)
    given = big[:, :, 16:].permute(0, 1, 3, 4, 5, 2).reshape(4, 8, m, c)
    assert given.stride() == (8 * (16 + c) * m, (16 + c) * m, 1, m)
  else:
    given = dout
  ref64, s = _scatter_bounds(dout, px, py, h2, w2)
  plain = op.skip_gather_backward_reference(dout, px, py, h2, w2)
  bound = 1e-5 * s + 1e-30
  if dtype == torch.bfloat16:
    bound = bound + _bf16_ulp(ref64)
  for call in range(2):
    before = _count("skip_gather.backward_launches")
    got = op.skip_gather_backward(given, px, py, h2, w2,
                                  grid_resolution=half)
    torch.cuda.synchronize()
    assert _count("skip_gather.backward_launches") == before + 1
    assert got.dtype == dtype and got.shape == (4, h2, w2, c)
    for out in (got, plain):
      err = (out.double() - ref64).abs()
      assert bool((err <= bound).all()), float((err - bound).max())


def test_packed_phase_loss_step_on_card_matches_cpu(device, monkeypatch):
  """The packed decoder's phase-loss step at 64³ on GT voxelized in the
  step: K1 4 + 4 (one backward in packed voxel order), K2 1, K3 1, K4 1
  at s = 4, and the loss of the CPU's step."""
  monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
  rng = np.random.default_rng(0)
  batch = _cube_batch(64)
  batch["image"] = torch.from_numpy(
      rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8))
  batch["camera"] = torch.diag(torch.tensor([1.8, 1.8, 1.8, 1.0])).repeat(
      2, 1, 1)
  batch["camera"][:, :3, 3] = -0.9
  kwargs = dict(image_resolution_multiplier=8,
                conservative_rasterization=False,
                max_bbox_pixels=VOXELIZE_WINDOW_PIXELS)
  factors, backwards = [], []
  phased_forward = phased.phased_gt_forward
  backward = op.skip_gather_backward
  monkeypatch.setattr(phased, "phased_gt_forward", lambda packed, s: (
      factors.append(s), phased_forward(packed, s))[1])
  monkeypatch.setattr(op, "skip_gather_backward", lambda dout, *a, **k: (
      backwards.append(dout.dim()), backward(dout, *a, **k))[1])
  losses = []
  for dev in ("cpu", device):
    model = CoreNet(CoreNetConfig(DecoderConfig((64, 64, 64), 2)),
                    phase_output=True, packed_decoder=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = create_train_state(model, device=dev)
    step = make_train_step(state.model, state.optimizer, "FG_BG",
                           (64, 64, 64), voxelization_kwargs=kwargs)
    counts = _counts(*STEP_LAUNCHES)
    del factors[:], backwards[:]
    state, metrics = step(state, {k: v.to(dev) for k, v in batch.items()})
    losses.append(float(metrics["loss"]))
  after = _counts(*STEP_LAUNCHES)
  assert tuple(a - c for a, c in zip(after, counts)) == (1, 1, 4, 4, 1)
  assert factors == [4] and sorted(backwards) == [3, 3, 3, 4]
  assert losses[1] == pytest.approx(losses[0], rel=1e-4)


GT_KEYS = ("triangles", "tri_mesh_slot", "tri_valid", "mesh_labels",
           "grid_offset")


@pytest.mark.parametrize("res", [32, 64])
@pytest.mark.parametrize("kwargs", [
    dict(sub_grid_sampling=True, image_resolution_multiplier=7,
         conservative_rasterization=False),
    dict(image_resolution_multiplier=8, conservative_rasterization=True,
         num_label_values=300),
    dict(image_resolution_multiplier=4, projection_depth_multiplier=2,
         conservative_rasterization=False, fill_rounds=3)])
def test_general_gt_on_card_equals_cpu(device, res, kwargs):
  """The general rasterizer, the dense fill and the label compose: every
  float32 operation is its own kernel on both devices, so the grids are
  equal bit for bit; neither the blocked rasterizer nor the block scatter
  is launched."""
  batch = _cube_batch(res)
  batch["mesh_labels"] = torch.tensor([[3, 0], [1, 2]], dtype=torch.int32)
  batch["tri_mesh_slot"][1, ::3] = 1
  batch["grid_offset"] = torch.tensor([[0.5, 0.5, 0.5], [0.2, 0.9, 0.4]])
  kwargs = dict(kwargs, resolution=(res,) * 3,
                max_bbox_pixels=VOXELIZE_WINDOW_PIXELS)
  want, _ = gt.voxelize_batch(*(batch[k] for k in GT_KEYS), **kwargs)
  before = _counts("blocked_raster.launches", "block_scatter.launches")
  got, v2x = gt.voxelize_batch(*(batch[k].to(device) for k in GT_KEYS),
                               **kwargs)
  assert _counts("blocked_raster.launches", "block_scatter.launches") == before
  assert got.dtype == torch.int32 and v2x.device == got.device
  assert torch.equal(got.cpu(), want)
  assert set(want.unique().tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("shape", [(2, 32, 32, 32), (3, 65, 65, 65),
                                   (1, 24, 40, 33)])
def test_dense_fill_on_card_equals_cpu(device, shape):
  gen = torch.Generator().manual_seed(sum(shape))
  grid = (torch.rand(shape, generator=gen) < 0.12).float()
  grid[0, 4:20, 4:20, 4:20] = 1
  grid[0, 6:18, 6:18, 6:18] = 0  # a cavity, which fills
  want = fill.fill_inside_voxels(grid)
  before = _count("fill.rounds")
  got = fill.fill_inside_voxels(grid.to(device))
  rounds = _count("fill.rounds") - before
  assert torch.equal(got.cpu(), want) and want[0, 12, 12, 12] == 1
  static = fill.fill_inside_voxels(grid.to(device), fill_rounds=rounds)
  assert torch.equal(static.cpu(), want)
  assert bool(fill.static_rounds_converged(grid.to(device), rounds))


@pytest.mark.parametrize("res", [32, 64])
def test_parity_on_card_equals_cpu(device, res):
  batch = _cube_batch(res)
  batch["grid_offset"] = torch.tensor([[0.5, 0.5, 0.5], [0.2, 0.9, 0.4]])
  batch["mesh_labels"] = torch.tensor([[3, 0], [1, 2]], dtype=torch.int32)
  kwargs = dict(num_mesh_slots=2, resolution=(res,) * 3, chunk_size=500)
  want, _ = parity_voxelize_batch(*(batch[k] for k in GT_KEYS), **kwargs)
  got, v2x = parity_voxelize_batch(*(batch[k].to(device) for k in GT_KEYS),
                                   **kwargs)
  assert torch.equal(got.cpu(), want) and v2x.device == got.device
  assert want[0, res // 2, res // 2, res // 2] == 3 and want[0, 1, 1, 1] == 0


@pytest.mark.parametrize("res", [32, 64])
def test_confusion_matrix_and_labels_on_card_equal_cpu(device, res):
  gen = torch.Generator().manual_seed(res)
  pmf = torch.rand((2, res, res, res, 4), generator=gen)
  # Exact ties, between all classes and between the last two: the first
  # maximum wins on both devices.
  pmf[0, 0] = 0.25
  pmf[0, 1, :, :, 2:] = 2.0
  grid = torch.randint(0, 4, (2, res, res, res), generator=gen,
                       dtype=torch.uint8)
  fg = torch.tensor([1, 300], dtype=torch.int32)
  for task_type, classes in (("SEMANTIC", 4), ("FG_BG", 4 * 300)):
    pred, labels = results.extract_labels(pmf, grid, fg, task_type)
    want = metrics.confusion_matrix(pred, labels, classes)
    pred_c, labels_c = results.extract_labels(
        pmf.to(device), grid.to(device), fg.to(device), task_type)
    assert torch.equal(pred_c.cpu(), pred)
    assert torch.equal(labels_c.cpu(), labels)
    got = metrics.confusion_matrix(pred_c, labels_c, classes)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    assert int(want.sum()) == 2 * res ** 3
  pred, _ = results.extract_labels(pmf.to(device), grid.to(device),
                                   fg.to(device), "SEMANTIC")
  assert bool((pred[0, 0] == 0).all()) and bool((pred[0, 1] == 2).all())
  acc = results.QuantitativeResults(["__void__", "a", "b", "c"], "SEMANTIC")
  acc.add_batch(pmf.to(device), grid.to(device), fg,
                valid=np.array([True, False]))
  assert acc.confusion.sum() == res ** 3


def _soup(seed, n):
  """n seeded triangles inside [0, 1]³ with seeded colors."""
  rng = np.random.default_rng(seed)
  centres = rng.uniform(0.2, 0.8, (n, 1, 3))
  tris = (centres + rng.normal(0, 0.12, (n, 3, 3))).astype(np.float32)
  return tris, rng.uniform(0, 1, (n, 3)).astype(np.float32)


def _l1(a, b):
  return float(np.abs(a.astype(np.int32) - b.astype(np.int32)).mean())


@pytest.mark.parametrize("size", [(64, 64), (256, 256)])
def test_renderers_on_card_match_cpu(device, size):
  """The mesh rasterizer (several chunks) and the voxel raycaster: the
  card's image within L1 < 1.0 of the CPU's (the measure of
  tests/test_viz.py); only pixel-edge ties may round apart."""
  from corenet_tpu_torch.viz import camera, renderer
  tris, colors = _soup(0, 700)
  cam = camera.default_camera([0, 0, 0], [1, 1, 1])
  images = [renderer.render_mesh(tris, colors, cam, size, chunk=256,
                                 device=dev) for dev in ("cpu", device)]
  assert _l1(*images) < 1.0 and (images[1] != 255).any()
  rng = np.random.default_rng(1)
  grid = ((rng.random((24, 20, 28)) > 0.8) *
          rng.integers(1, 5, (24, 20, 28))).astype(np.int32)
  images = [renderer.render_voxel_grid(grid, image_size=size, device=dev)
            for dev in ("cpu", device)]
  assert _l1(*images) < 1.0 and (images[1] != 255).any()


def test_checkpoint_round_trip_on_card(device, tmp_path, monkeypatch):
  """A model and Adam state on the card through the port's `.cpt`: the
  restored model's logits equal the original's, and so do the moments."""
  from corenet_tpu_torch.train.checkpoint import CheckpointManager
  monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
  model = CoreNet(CoreNetConfig(DecoderConfig((32, 32, 32), 2)))
  model.reset_parameters(torch.Generator().manual_seed(0))
  state = create_train_state(model, global_step=4, device=device)
  for p in state.model.parameters():
    p.grad = torch.full_like(p, 1e-3)
  state.optimizer.step()
  path = CheckpointManager(str(tmp_path)).save_state(state, {"k": 1})
  fresh = create_train_state(
      CoreNet(CoreNetConfig(DecoderConfig((32, 32, 32), 2))), device=device)
  restored, meta, _ = CheckpointManager(str(tmp_path)).read_last_checkpoint(
      fresh)
  assert meta == {"k": 1} and restored.global_step == 4
  assert restored.model.encoder.stage1_bn.mean.device.type == "cuda"
  for p, q in zip(state.model.parameters(), restored.model.parameters()):
    a, b = state.optimizer.state[p], restored.optimizer.state[q]
    assert torch.equal(a["exp_avg"], b["exp_avg"]) and int(b["step"]) == 1
    assert b["exp_avg_sq"].device.type == "cuda"
  image = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                        device=device)
  v2s = torch.diag(torch.tensor([1.8 / 32] * 3 + [1.0])).repeat(2, 1, 1)
  v2s[:, :3, 3] = -0.9
  offsets = torch.full((2, 3), 0.5, device=device)
  with torch.inference_mode():
    logits = [m.eval()(image, v2s.to(device), offsets)
              for m in (state.model, restored.model)]
  assert torch.equal(*logits)
  assert path.endswith("state_000000004.cpt")


def _plain_kernels(monkeypatch):
  """Every kernel of the step swapped for its plain version."""
  monkeypatch.setattr(op, "skip_gather_forward", op.skip_gather_reference)
  monkeypatch.setattr(
      op, "skip_gather_backward",
      lambda *args, grid_resolution: op.skip_gather_backward_reference(*args))
  monkeypatch.setattr(fgbg, "fgbg_sums_forward", fgbg.fgbg_sums_reference)
  monkeypatch.setattr(raster, "blocked_raster_forward",
                      raster.blocked_raster_reference)
  monkeypatch.setattr(phased, "phased_gt_forward", phased.phased_gt_reference)


def test_bf16_train_step_on_card_matches_plain_kernels(device, monkeypatch):
  """The bf16 h7 step (GT voxelized in the step, the phase loss) at 128³,
  batch 4, 256² images, with the kernels and with their plain versions
  from the same weights, under deterministic cuDNN: the forward is the
  same up to the loss's sums (1e-6 relative). Those sums part in the last
  float32 bits, which the backward's bf16 roundings turn into ulp flips:
  the gradients together lie within 5e-2 relative L2 and each points the
  same way (cosine ≥ 0.95), chip_smoke.py's bf16 rule."""
  monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
  rng = np.random.default_rng(1)
  batch = _cube_batch(128, batch=4)
  batch["image"] = torch.from_numpy(
      rng.integers(0, 256, (4, 256, 256, 3)).astype(np.uint8))
  batch["camera"] = torch.diag(torch.tensor([1.8, 1.8, 1.8, 1.0])).repeat(
      4, 1, 1)
  batch["camera"][:, :3, 3] = -0.9
  batch = {k: v.to(device) for k, v in batch.items()}
  kwargs = dict(image_resolution_multiplier=8,
                conservative_rasterization=False,
                max_bbox_pixels=VOXELIZE_WINDOW_PIXELS)
  results = []
  for plain in (False, True):
    model = CoreNet(CoreNetConfig(DecoderConfig((128,) * 3, 2)),
                    phase_output=True, compute_dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = create_train_state(model, device=device)
    step = make_train_step(state.model, state.optimizer, "FG_BG",
                           (128,) * 3, voxelization_kwargs=kwargs)
    counts = _count("skip_gather.backward_launches")
    with monkeypatch.context() as m:
      if plain:
        _plain_kernels(m)
      _, metrics = step(state, batch)
    launched = _count("skip_gather.backward_launches") - counts
    assert launched == (0 if plain else 4)
    # Conv biases that a BatchRenorm normalizes have a true gradient of 0:
    # both steps hold rounding dust there.
    results.append((float(metrics["loss"]), {
        n: p.grad.clone() for n, p in model.named_parameters()
        if not (n.endswith(".bias") and (
            (n.startswith("encoder.") and "conv" in n.split(".")[-2])
            or re.fullmatch(r"decoder\.stage_\d_c\.bias", n)))}))
  (loss_k, grads_k), (loss_p, grads_p) = results
  assert loss_k == pytest.approx(loss_p, rel=1e-6)
  assert sorted(grads_k) == sorted(grads_p)
  diff = sum(float((grads_k[n] - g).norm()) ** 2 for n, g in grads_p.items())
  norm = sum(float(g.norm()) ** 2 for g in grads_p.values())
  assert (diff / norm) ** 0.5 <= 5e-2
  for name, g in grads_p.items():
    k = grads_k[name]
    assert k.dtype == torch.float32
    assert float((k * g).sum() / (k.norm() * g.norm())) >= 0.95, name


def test_bf16_inference_twin_on_card(device, monkeypatch):
  """The inference factory over a bf16 training model on the card: the
  PMF is the bf16 eval forward's (deterministic cuDNN), near the float32
  twin's, and the caller's model keeps its mode, weights and device."""
  from corenet_tpu_torch.eval.super_resolution import (
      super_resolution_from_model)
  from corenet_tpu_torch.train.step import make_eval_forward
  monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
  monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
  model = CoreNet(CoreNetConfig(DecoderConfig((32, 32, 32), 2)),
                  compute_dtype=torch.bfloat16)
  model.reset_parameters(torch.Generator().manual_seed(2))
  model.to(device).train()
  weights = {k: v.clone() for k, v in model.state_dict().items()}
  rng = np.random.default_rng(3)
  image = torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3)).astype(
      np.uint8)).to(device)
  camera = torch.diag(torch.tensor([1.8, 1.8, 1.8, 1.0])).repeat(2, 1, 1)
  camera[:, :3, 3] = -0.9
  args = (image, camera.to(device),
          torch.diag(torch.tensor([32.0, 32, 32, 1])).repeat(2, 1, 1).to(
              device), torch.full((2, 3), 0.5, device=device))
  pmf = super_resolution_from_model(model, model.state_dict(), (32,) * 3,
                                    packed_execution=False,
                                    device=device)(*args, (32,) * 3)
  twin = CoreNet(model.config, compute_dtype=torch.bfloat16).to(device)
  twin.load_state_dict(weights)
  assert torch.equal(pmf, make_eval_forward(twin.eval())(*args))
  f32 = CoreNet(model.config).to(device)
  f32.load_state_dict(weights)
  pmf32 = make_eval_forward(f32.eval())(*args)
  assert not torch.equal(pmf, pmf32)
  assert float((pmf - pmf32).abs().mean()) < 0.02
  assert model.training and next(model.parameters()).device.type == "cuda"
  for k, v in model.state_dict().items():
    assert torch.equal(v, weights[k]), k


def test_nccl_group_of_one_steps_as_no_group_does(device, tmp_path,
                                                  monkeypatch):
  """The packed phase-loss step at 64³ in an NCCL group of one rank and
  without a group, from the same state with deterministic cuDNN: the
  same launches, the loss and the new statistics bit for bit, and each
  gradient bit for bit where two runs without a group are. K1's backward
  adds with atomics, so two runs may differ in the order of its float32
  sums (7.6e-6 relative L2 in the encoder's first convolution, H100,
  700.00 W); then each gradient lies within the larger of 1e-6 and ten
  times the two runs' worst difference."""
  from corenet_tpu_torch.parallel import mesh
  monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
  monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
  rng = np.random.default_rng(0)
  batch = _cube_batch(64)
  batch["image"] = torch.from_numpy(
      rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8))
  batch["camera"] = torch.diag(torch.tensor([1.8, 1.8, 1.8, 1.0])).repeat(
      2, 1, 1)
  batch["camera"][:, :3, 3] = -0.9
  batch = {k: v.to(device) for k, v in batch.items()}
  model = CoreNet(CoreNetConfig(DecoderConfig((64, 64, 64), 2)),
                  phase_output=True, packed_decoder=True)
  model.reset_parameters(torch.Generator().manual_seed(0))
  state = create_train_state(model, device=device)
  step = make_train_step(state.model, state.optimizer, "FG_BG", (64,) * 3,
                         voxelization_kwargs=dict(
                             image_resolution_multiplier=8,
                             conservative_rasterization=False,
                             max_bbox_pixels=VOXELIZE_WINDOW_PIXELS))
  snapshot = {k: v.clone() for k, v in model.state_dict().items()}

  def one_step():
    model.load_state_dict(snapshot)
    counts = _counts(*STEP_LAUNCHES)
    collectives = _count("mesh.collectives")
    new_state, metrics = step(state, batch)
    torch.cuda.synchronize()
    after = _counts(*STEP_LAUNCHES)
    return (float(metrics["loss"]), new_state.global_step,
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()},
            tuple(a - c for a, c in zip(after, counts)),
            _count("mesh.collectives") - collectives)

  def worst(run):
    return max(float((run[2][n] - g).norm() / g.norm())
               for n, g in alone[2].items() if float(g.norm()) > 0)

  alone = one_step()
  mesh.initialize(backend="nccl", init_method=f"file://{tmp_path}/store",
                  rank=0, world_size=1, device=device)
  try:
    grouped = one_step()
  finally:
    mesh.shutdown()
  again = one_step()
  assert alone[4] == grouped[4] == (1, 1, 4, 4, 1)
  assert alone[5] == 0 and grouped[5] > 0
  assert alone[0] == grouped[0] == again[0]
  assert alone[1] == grouped[1] == 2
  for name, value in alone[3].items():
    assert torch.equal(value, grouped[3][name]), name
  floor = worst(again)
  if floor == 0:
    assert worst(grouped) == 0
  else:
    assert worst(grouped) <= max(1e-6, 10 * floor), (worst(grouped), floor)
