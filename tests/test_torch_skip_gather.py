"""The PyTorch port's skip gather (corenet_tpu_torch/ops/skip_gather.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU
as tests/test_skip_gather.py runs it.

The gather is a copy, so the port's plain version must be bit-exact with
the Pallas kernel in float32 and bfloat16. The CUDA kernel itself runs
only on a card; tests/test_torch_cuda.py holds it against the plain
version there.
"""

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
