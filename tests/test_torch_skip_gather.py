"""The PyTorch port's skip gather (corenet_tpu_torch/ops/skip_gather.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU
as tests/test_skip_gather.py runs it.

The gather is a copy, so the port's plain version must be bit-exact with
the Pallas kernel in float32 and bfloat16. Its gradient is a scatter-add
with f32 accumulation, held against `jax.vjp` of the Pallas kernel: in
float32 within 1e-5 · Σ|dout| per cell (the f32 summation-order bound),
in bfloat16 within that plus one bf16 ulp (the one rounding of the f32
sum). The CUDA kernels themselves run only on a card;
tests/test_torch_cuda.py holds them against the plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corenet_tpu.ops.skip_gather import skip_gather as jax_skip_gather
from corenet_tpu_torch import kernels
from corenet_tpu_torch.ops import skip_gather as op
from corenet_tpu_torch.utils import tracing

torch.set_num_threads(2)

# The four skips of the h7 decoder: padded map (H2, W2) and channels.
H7_SKIP_SHAPES = [(10, 10, 96), (18, 18, 48), (34, 34, 24), (66, 66, 12)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# The skip gather's forward and backward launch counters.
K1_LAUNCHES = ("skip_gather.launches", "skip_gather.backward_launches")


def _count(name: str) -> int:
  """A counter's total (corenet_tpu_torch/utils/tracing.py)."""
  return tracing.counters()[name]


def _counts(*names: str) -> tuple:
  totals = tracing.counters()
  return tuple(totals[n] for n in names)


def _inputs(seed, b, h2, w2, c, n):
  rng = np.random.default_rng(seed)
  fmap = rng.standard_normal((b, h2, w2, c)).astype(np.float32)
  px = rng.integers(0, w2, (b, n)).astype(np.int32)
  py = rng.integers(0, h2, (b, n)).astype(np.int32)
  return fmap, px, py


def _both(fmap, px, py, dtype):
  jdt, tdt = DTYPES[dtype]
  ref = jax_skip_gather(jnp.asarray(fmap, jdt), jnp.asarray(px),
                        jnp.asarray(py), interpret=True)
  got = op.skip_gather_reference(torch.from_numpy(fmap).to(tdt),
                                 torch.from_numpy(px), torch.from_numpy(py))
  # bf16 → f32 is exact, so comparing in f32 compares the bits.
  return (np.asarray(ref.astype(jnp.float32)), got.float().numpy())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h2,w2,c", H7_SKIP_SHAPES)
def test_plain_version_bit_exact_with_pallas(h2, w2, c, dtype):
  fmap, px, py = _inputs(h2, 2, h2, w2, c, 2048)
  ref, got = _both(fmap, px, py, dtype)
  assert got.shape == ref.shape == (2, 2048, c)
  assert np.array_equal(got, ref)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_bit_exact_ragged_n(dtype):
  fmap, px, py = _inputs(7, 2, 18, 18, 48, 700)
  ref, got = _both(fmap, px, py, dtype)
  assert got.shape == ref.shape == (2, 700, 48)
  assert np.array_equal(got, ref)


# Random indices have no column structure: every voxel its own column.
FLAT64 = (1, 1, 64)


def test_wrapper_takes_plain_version_on_cpu_without_counting():
  fmap, px, py = (torch.from_numpy(a) for a in _inputs(3, 2, 10, 9, 5, 64))
  before = _count("skip_gather.launches")
  out = op.skip_gather(fmap, px, py, FLAT64)
  assert _count("skip_gather.launches") == before
  assert torch.equal(out, op.skip_gather_reference(fmap, px, py))
  # On the CPU the plain version is differentiable.
  fmap.requires_grad_(True)
  op.skip_gather(fmap, px, py, FLAT64).sum().backward()
  assert fmap.grad is not None


def test_wrapper_refuses_malformed_inputs():
  fmap, px, py = (torch.from_numpy(a) for a in _inputs(4, 2, 10, 9, 5, 64))
  with pytest.raises(TypeError):
    op.skip_gather(fmap, px.long(), py, FLAT64)
  with pytest.raises(TypeError):
    op.skip_gather(fmap.half(), px, py, FLAT64)
  with pytest.raises(ValueError):
    op.skip_gather(fmap, px[:1], py, FLAT64)
  with pytest.raises(ValueError):
    op.skip_gather(fmap[0], px, py, FLAT64)
  with pytest.raises(ValueError):
    op.skip_gather(fmap.transpose(1, 2), px, py, FLAT64)
  with pytest.raises(ValueError):
    op.skip_gather(fmap.to("meta"), px.to("meta"), py.to("meta"), FLAT64)


def test_build_command_targets_hopper(monkeypatch, tmp_path):
  monkeypatch.setattr(kernels, "nvcc_path", lambda: "nvcc")
  command = kernels.nvcc_command("skip_gather", tmp_path / "lib.so")
  assert "arch=compute_90a,code=sm_90a" in command
  assert "-shared" in command and command[-1].endswith("skip_gather.cu")
  path = kernels.library_path("skip_gather")
  assert path.parent == kernels.BUILD_DIR
  assert path == kernels.library_path("skip_gather")  # keyed by content


def test_missing_nvcc_raises(monkeypatch, tmp_path):
  monkeypatch.setattr(kernels.shutil, "which", lambda _: None)
  monkeypatch.setattr(kernels, "DEFAULT_NVCC", tmp_path / "no-nvcc")
  with pytest.raises(RuntimeError, match="nvcc not found"):
    kernels.nvcc_path()


def _scatter64(values, px, py, h2, w2):
  """float64 scatter-add of values [B, N, C] into [B, H2, W2, C]."""
  b, _, c = values.shape
  out = np.zeros((b, h2, w2, c), np.float64)
  for i in range(b):
    np.add.at(out[i], (py[i], px[i]), values[i].astype(np.float64))
  return out


def _bf16_ulp(x):
  mag = np.maximum(np.abs(x), 2.0 ** -126)
  return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _backward_case(seed, b, h2, w2, c, n, dtype):
  """Indices that repeat pixels and send a quarter of the voxels to the pad
  cell (0, 0), as voxels behind the camera do; a cotangent exactly
  representable in `dtype`."""
  jdt, tdt = DTYPES[dtype]
  fmap, px, py = _inputs(seed, b, h2, w2, c, n)
  rng = np.random.default_rng(seed + 1)
  hot = rng.random((b, n)) < 0.25
  px[hot] = 0
  py[hot] = 0
  dout = torch.from_numpy(
      rng.standard_normal((b, n, c)).astype(np.float32)).to(tdt)
  return fmap, px, py, dout, jdt, tdt


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h2,w2,c,n", [s + (2048,) for s in H7_SKIP_SHAPES]
                         + [(18, 18, 48, 700)])
def test_gradient_matches_pallas_backward(h2, w2, c, n, dtype):
  fmap, px, py, dout, jdt, tdt = _backward_case(h2 + n, 2, h2, w2, c, n,
                                                dtype)
  _, vjp = jax.vjp(
      lambda f: jax_skip_gather(f, jnp.asarray(px), jnp.asarray(py),
                                interpret=True), jnp.asarray(fmap, jdt))
  (ref,) = vjp(jnp.asarray(dout.float().numpy(), jdt))
  ref = np.asarray(ref.astype(jnp.float32), np.float64)

  fmap_t = torch.from_numpy(fmap).to(tdt).requires_grad_(True)
  op.skip_gather(fmap_t, torch.from_numpy(px), torch.from_numpy(py),
                 (1, 1, n)).backward(dout)
  got = fmap_t.grad
  assert got.dtype == tdt and got.shape == (2, h2, w2, c)
  got = got.double().numpy()

  d = dout.double().numpy()
  exact = _scatter64(d, px, py, h2, w2)
  mass = _scatter64(np.abs(d), px, py, h2, w2)
  bound = 1e-5 * mass + 1e-30
  if dtype == "bfloat16":
    bound = bound + _bf16_ulp(exact)
  # The pad cell (0, 0) collects a quarter of the voxels of each scene.
  assert (mass[:, 0, 0] > 0.1 * mass.sum(axis=(1, 2))).all()
  for out in (got, ref):
    assert (np.abs(out - exact) <= bound).all()
  assert (np.abs(got - ref) <= 2 * bound).all()


def test_backward_wrapper_takes_plain_version_on_cpu_without_counting():
  fmap, px, py, dout, _, _ = _backward_case(5, 2, 10, 9, 5, 64, "float32")
  px, py = torch.from_numpy(px), torch.from_numpy(py)
  before = _counts(*K1_LAUNCHES)
  got = op.skip_gather_backward(dout, px, py, 10, 9, FLAT64)
  assert _counts(*K1_LAUNCHES) == before
  assert torch.equal(got, op.skip_gather_backward_reference(dout, px, py, 10,
                                                            9))
  with pytest.raises(ValueError):
    op.skip_gather_backward(dout[:, :10], px, py, 10, 9, FLAT64)
  with pytest.raises(ValueError):
    op.skip_gather_backward(dout.transpose(0, 1), px, py, 10, 9, FLAT64)


# The step's layout: the decoder concatenates the skip's [B, C, D, H, W]
# view behind the tower's channels (models/decoder.py), so autograd hands
# SkipGather.backward a channel slice of the concatenation's gradient,
# [B, N, C] with element strides (C_tot·N, 1, N).
GRID = (8, 16, 16)


def _step_layout(dout, grid, channels_before):
  """dout [B, N, C] re-laid as the channel slice of a [B, C_tot, D, H, W]
  gradient whose other channels hold noise."""
  b, n, c = dout.shape
  big = torch.randn((b, channels_before + c) + tuple(grid),
                    generator=torch.Generator().manual_seed(n)).to(dout.dtype)
  big[:, channels_before:] = dout.reshape((b,) + tuple(grid) + (c,)).permute(
      0, 4, 1, 2, 3)
  strided = big[:, channels_before:].permute(0, 2, 3, 4, 1).reshape(b, n, c)
  assert strided.stride() == ((channels_before + c) * n, 1, n)
  return big, strided


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_backward_wrapper_takes_strided_gradient(dtype):
  _, px, py, dout, _, _ = _backward_case(6, 2, 18, 18, 48, 2048, dtype)
  px, py = torch.from_numpy(px), torch.from_numpy(py)
  _, strided = _step_layout(dout, GRID, 64)
  assert not strided.is_contiguous()
  got = op.skip_gather_backward(strided, px, py, 18, 18,
                                grid_resolution=GRID)
  want = op.skip_gather_backward(dout, px, py, 18, 18, grid_resolution=GRID)
  assert got.dtype == dout.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h2,w2,c", H7_SKIP_SHAPES)
def test_gradient_in_step_layout_matches_pallas_backward(h2, w2, c, dtype):
  n = GRID[0] * GRID[1] * GRID[2]
  fmap, px, py, dout, jdt, tdt = _backward_case(3 * h2 + c, 2, h2, w2, c, n,
                                                dtype)
  _, vjp = jax.vjp(
      lambda f: jax_skip_gather(f, jnp.asarray(px), jnp.asarray(py),
                                interpret=True), jnp.asarray(fmap, jdt))
  (ref,) = vjp(jnp.asarray(dout.float().numpy(), jdt))
  ref = np.asarray(ref.astype(jnp.float32), np.float64)

  fmap_t = torch.from_numpy(fmap).to(tdt).requires_grad_(True)
  out = op.skip_gather(fmap_t, torch.from_numpy(px), torch.from_numpy(py),
                       grid_resolution=GRID)
  sampled = out.reshape((2,) + GRID + (c,)).permute(0, 4, 1, 2, 3)
  tower = torch.zeros((2, 16) + GRID, dtype=tdt)
  cotangent, _ = _step_layout(dout, GRID, 16)
  torch.cat([tower, sampled], dim=1).backward(cotangent)
  got = fmap_t.grad
  assert got.dtype == tdt and got.shape == (2, h2, w2, c)
  got = got.double().numpy()

  d = dout.double().numpy()
  exact = _scatter64(d, px, py, h2, w2)
  bound = 1e-5 * _scatter64(np.abs(d), px, py, h2, w2) + 1e-30
  if dtype == "bfloat16":
    bound = bound + _bf16_ulp(exact)
  for result in (got, ref):
    assert (np.abs(result - exact) <= bound).all()
  assert (np.abs(got - ref) <= 2 * bound).all()


def test_skip_backward_receives_the_gradient_uncopied(monkeypatch):
  """A SampleGrid2d, the decoder's concatenation and a 3D conv at 16³: the
  backward wrapper gets the non-contiguous channel slice, and the map's
  gradient equals the one through a contiguous copy."""
  from corenet_tpu_torch.models import skip
  grid = (16, 16, 16)
  gen = torch.Generator().manual_seed(0)
  module = skip.SampleGrid2d(8, 12, grid)
  conv = torch.nn.Conv3d(28, 4, 3, padding=1)
  with torch.no_grad():
    for p in list(module.parameters()) + list(conv.parameters()):
      p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
  f, near, far = 1.8, 0.5, 3.0
  a, bb = (far + near) / (far - near), -2 * far * near / (far - near)
  camera = torch.tensor([[f, 0, 0, -0.5 * f], [0, f, 0, -0.5 * f],
                         [0, 0, a, a + bb], [0, 0, 1, 1.0]])
  matrix = (camera @ torch.diag(torch.tensor([1 / 16] * 3 + [1.0]))).expand(
      2, 4, 4)
  offsets = torch.full((2, 3), 0.5)
  grid2d = torch.randn((2, 8, 8, 8), generator=gen)
  tower = torch.randn((2, 16) + grid, generator=gen)
  kernel_wrapper = op.skip_gather_backward

  def map_gradient(copy_first):
    received = []

    def spy(dout, *args, **kwargs):
      received.append((dout.is_contiguous(), dout.stride(),
                       kwargs.get("grid_resolution")))
      return kernel_wrapper(dout.contiguous() if copy_first else dout, *args,
                            **kwargs)

    monkeypatch.setattr(op, "skip_gather_backward", spy)
    x = grid2d.clone().requires_grad_(True)
    sampled = module(x, matrix, offsets)
    conv(torch.cat([tower, sampled], dim=1)).square().sum().backward()
    return x.grad, received

  got, received = map_gradient(copy_first=False)
  want, _ = map_gradient(copy_first=True)
  n = 16 ** 3
  assert received == [(False, (28 * n, 1, n), grid)]
  assert torch.equal(got, want)


def test_backward_columns_and_chunks():
  assert op.columns(4096, (16, 16, 16)) == (16, 256)
  assert op.columns(4096, (1, 1, 4096)) == (1, 4096)
  with pytest.raises(ValueError):
    op.columns(4096, (16, 16, 15))
  fmap, px, py = (torch.from_numpy(a) for a in _inputs(4, 2, 10, 9, 5, 64))
  with pytest.raises(ValueError):
    op.skip_gather(fmap, px, py, grid_resolution=(4, 4, 2))
  with pytest.raises(ValueError):
    op.skip_gather_backward(torch.zeros((2, 64, 5)), px, py, 10, 9,
                            grid_resolution=(4, 4, 5))
  assert [op.channel_vector(c) for c in (12, 6, 5)] == [4, 2, 1]
  assert [op.z_chunk(d) for d in (1, 3, 8, 16, 32, 64)] == [1, 1, 2, 4, 8, 16]
