"""The port's CUDA kernels on the card, against their plain versions, and
the port's serving forward and training step on the card against the CPU.

Every test here is marked `cuda` and skips without a CUDA device. The
file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch; there, run it without the suite's
conftest (which sets JAX up):

  python -m pytest --noconftest -p no:cacheprovider -m cuda \\
      tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from corenet_tpu_torch.data.batching import (
    VOXELIZE_WINDOW_PIXELS, _pad_to_bucket, subdivide_triangles)
from corenet_tpu_torch.models.corenet import (
    CoreNet, CoreNetConfig, DecoderConfig)
from corenet_tpu_torch.ops import block_scatter as scatter
from corenet_tpu_torch.ops import fgbg_loss as fgbg
from corenet_tpu_torch.ops import phased_gt as phased
from corenet_tpu_torch.ops import skip_gather as op
from corenet_tpu_torch.train import gt
from corenet_tpu_torch.train.state import create_train_state
from corenet_tpu_torch.train.step import make_train_step
from corenet_tpu_torch.voxel.packed import pack_grid

pytestmark = pytest.mark.cuda

# The four skips of the h7 decoder: padded map (H2, W2), channels, and
# the voxel count per scene.
H7_SKIPS = [(10, 10, 96, 512), (18, 18, 48, 4096), (34, 34, 24, 32768),
            (66, 66, 12, 262144)]


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
  before = op.launch_count
  out = op.skip_gather(fmap, px, py)
  torch.cuda.synchronize()
  assert op.launch_count == before + 1
  assert out.dtype == dtype and out.shape == (4, n, c)
  assert torch.equal(out, op.skip_gather_reference(fmap, px, py))


def _scatter_bounds(dout, px, py, h2, w2):
  """The float64 scatter-add and the scatter-add of |dout|, per cell."""
  ref64 = op.skip_gather_backward_reference(dout.double(), px, py, h2, w2)
  s = op.skip_gather_backward_reference(dout.double().abs(), px, py, h2, w2)
  return ref64, s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h2,w2,c,n", H7_SKIPS + [(18, 18, 48, 700),
                                                  (9, 7, 5, 333)])
def test_skip_gather_backward_kernel_matches_plain_version(device, h2, w2, c,
                                                           n, dtype):
  _, px, py = _inputs(h2 + n, 4, h2, w2, c, n, device)
  # Every fourth voxel reads the hot pad cell (0, 0), as voxels behind the
  # camera do.
  px[:, ::4] = 0
  py[:, ::4] = 0
  dout = torch.randn((4, n, c), generator=torch.Generator().manual_seed(n))
  dout = dout.to(device, dtype)
  before = op.backward_launch_count
  got = op.skip_gather_backward(dout, px, py, h2, w2)
  torch.cuda.synchronize()
  assert op.backward_launch_count == before + 1
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
  fwd, bwd = op.launch_count, op.backward_launch_count
  out = op.skip_gather(fmap, px, py)
  dout = torch.randn_like(out)
  out.backward(dout)
  torch.cuda.synchronize()
  assert (op.launch_count, op.backward_launch_count) == (fwd + 1, bwd + 1)
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
  before = fgbg.launch_count
  inter, union = fgbg.fgbg_sums(diff, gt)
  torch.cuda.synchronize()
  assert fgbg.launch_count == before + 1
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
    counts = (op.launch_count, op.backward_launch_count, fgbg.launch_count)
    state, metrics = step(state, {k: v.to(dev) for k, v in batch.items()})
    losses.append(float(metrics["loss"]))
    assert state.global_step == 2
  assert (op.launch_count, op.backward_launch_count, fgbg.launch_count) == (
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
    before = op.launch_count
    got = model(image.to(device), v2s.to(device), offsets.to(device))
    assert op.launch_count == before + 4
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
  before = scatter.launch_count
  got = scatter.block_scatter_or(origins, pw, meshes=meshes, h=hw, w=hw,
                                 nw=nw)
  again = scatter.block_scatter_or(origins, pw, meshes=meshes, h=hw, w=hw,
                                   nw=nw)
  torch.cuda.synchronize()
  assert scatter.launch_count == before + 2
  want = scatter.block_scatter_or_reference(origins, pw, meshes=meshes,
                                            h=hw, w=hw, nw=nw)
  assert torch.equal(got, want) and torch.equal(again, got)
  assert float((got != 0).float().mean()) > 0.05


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("shape", [(2, 64, 64, 64), (1, 32, 48, 64),
                                   (4, 128, 128, 128)])
def test_phased_gt_kernel_equals_plain_version(device, s, shape):
  gen = torch.Generator().manual_seed(sum(shape) + s)
  grid = (torch.rand(shape, generator=gen) < 0.4).to(device)
  packed = pack_grid(grid)
  before = phased.launch_count
  got = phased.phased_gt(packed, s)
  torch.cuda.synchronize()
  assert phased.launch_count == before + 1
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
  before = scatter.launch_count
  got, v2x = gt.voxelize_batch_packed_fgbg(
      *(batch[k].to(device) for k in keys), **kwargs)
  assert scatter.launch_count == before + 1
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
    counts = (scatter.launch_count, phased.launch_count, op.launch_count,
              op.backward_launch_count, fgbg.launch_count)
    state, metrics = step(state, {k: v.to(dev) for k, v in batch.items()})
    losses.append(float(metrics["loss"]))
  after = (scatter.launch_count, phased.launch_count, op.launch_count,
           op.backward_launch_count, fgbg.launch_count)
  assert tuple(a - c for a, c in zip(after, counts)) == (1, 1, 4, 4, 1)
  assert losses[1] == pytest.approx(losses[0], rel=1e-4)
