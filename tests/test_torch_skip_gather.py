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

torch.set_num_threads(2)

# The four skips of the h7 decoder: padded map (H2, W2) and channels.
H7_SKIP_SHAPES = [(10, 10, 96), (18, 18, 48), (34, 34, 24), (66, 66, 12)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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


def test_wrapper_takes_plain_version_on_cpu_without_counting():
  fmap, px, py = (torch.from_numpy(a) for a in _inputs(3, 2, 10, 9, 5, 64))
  before = op.launch_count
  out = op.skip_gather(fmap, px, py)
  assert op.launch_count == before
  assert torch.equal(out, op.skip_gather_reference(fmap, px, py))
  # On the CPU the plain version is differentiable.
  fmap.requires_grad_(True)
  op.skip_gather(fmap, px, py).sum().backward()
  assert fmap.grad is not None


def test_wrapper_refuses_malformed_inputs():
  fmap, px, py = (torch.from_numpy(a) for a in _inputs(4, 2, 10, 9, 5, 64))
  with pytest.raises(TypeError):
    op.skip_gather(fmap, px.long(), py)
  with pytest.raises(TypeError):
    op.skip_gather(fmap.half(), px, py)
  with pytest.raises(ValueError):
    op.skip_gather(fmap, px[:1], py)
  with pytest.raises(ValueError):
    op.skip_gather(fmap[0], px, py)
  with pytest.raises(ValueError):
    op.skip_gather(fmap.transpose(1, 2), px, py)
  with pytest.raises(ValueError):
    op.skip_gather(fmap.to("meta"), px.to("meta"), py.to("meta"))


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
  op.skip_gather(fmap_t, torch.from_numpy(px),
                 torch.from_numpy(py)).backward(dout)
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
  before = (op.launch_count, op.backward_launch_count)
  got = op.skip_gather_backward(dout, px, py, 10, 9)
  assert (op.launch_count, op.backward_launch_count) == before
  assert torch.equal(got, op.skip_gather_backward_reference(dout, px, py, 10,
                                                            9))
  with pytest.raises(ValueError):
    op.skip_gather_backward(dout[:, :10], px, py, 10, 9)
  with pytest.raises(ValueError):
    op.skip_gather_backward(dout.transpose(0, 1), px, py, 10, 9)
