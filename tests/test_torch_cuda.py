"""The port's CUDA kernels on the card, against their plain versions.

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

from corenet_tpu_torch.models.corenet import (
    CoreNet, CoreNetConfig, DecoderConfig)
from corenet_tpu_torch.ops import skip_gather as op

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


def test_skip_gather_kernel_refuses_grad(device):
  fmap, px, py = _inputs(0, 2, 10, 10, 8, 64, device)
  with pytest.raises(RuntimeError, match="no CUDA backward"):
    op.skip_gather(fmap.requires_grad_(True), px, py)


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
