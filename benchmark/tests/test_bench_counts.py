"""The benchmark's counts reproduce the bounds that chip_smoke.py printed
at h7: 0.0304 ms for the blocked rasterizer on PR 15's batch (55,236
valid triangles of 4 scenes padded to 16,384, irm 8, 128³) and 0.0232 ms
for the skip gathers of one float32 h7 forward at its cameras."""

import pytest
import torch

from benchmark.counts import flops, gather, raster
from benchmark.reference import model as ref
from benchmark.tests.test_bench_reference import _camera

# chip_smoke.py's skips: stage → (native / layer resolution, padded map
# side at 256², channels).
SKIPS = {2: (16, 10, 96), 3: (8, 18, 48), 4: (4, 34, 24), 5: (2, 66, 12)}


def test_raster_bound_at_h7():
  ms = raster.bound_s(55236, 4, 16384, 128, 8) * 1e3
  assert ms == pytest.approx(0.0304, abs=5e-5)


def test_gather_bound_at_h7():
  v2x = torch.diag(torch.tensor([128.0] * 3 + [1.0])).expand(4, 4, 4)
  v2s = ref.compute_v2s(_camera(4), v2x)
  offsets = torch.full((4, 3), 0.5)
  total = 0
  for div, h2, c in SKIPS.values():
    matrix = v2s * torch.tensor([div, div, div, 1.0])
    pixels = gather.distinct_pixels(matrix, offsets, 128 // div, h2)
    total += gather.launch_bytes(4, 128 // div, c, 4, pixels)
  assert gather.bound_s(total) * 1e3 == pytest.approx(0.0232, abs=5e-5)


def test_axis_pairs():
  # A 3-tap convolution with padding 1 over 4 positions: 4·3 − 2 pairs.
  assert flops.conv_pairs(4, 3, 1, 1) == (4, 10)
  # Kernel 7, stride 2, padding 3, output padding 1: twice the input, and
  # 3.5 taps per output on average away from the edges.
  out, pairs = flops.conv_t_pairs(32, 7, 2, 3, 1)
  assert out == 64 and pairs == 32 * 7 - 4 - 2
  # kernel = stride (the seed layer): every tap lands.
  assert flops.conv_t_pairs(1, 4, 4, 0, 0) == (4, 4)


def test_model_flops_at_published_sizes():
  encoder, taps = flops.resnet50(256, 256)
  assert taps[5] == (8, 8) and taps[2] == (64, 64)
  assert 9.0e9 < encoder < 10.5e9  # ResNet-50's ~4.1 GMAC at 224², ×(256/224)²
  h7 = flops.forward(256, 128, 2, 64, 0.75, 2)
  y1 = flops.forward(256, 32, 2, 64, 0.75, 2, decodes_per_image=64)
  assert h7 == encoder + flops.decoder(128, 2, 64, 0.75, 2, taps)
  assert y1 < h7
