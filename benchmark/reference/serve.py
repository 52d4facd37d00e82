"""Plain reference of super-resolution serving: one image batch encoded
once, the fine decoder run once per offset of the m³ sub-voxel lattice
(the view → voxel transform scaled by 1/m), the class PMFs interleaved
into the m-times finer grid. m = 1 is a plain forward."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import model as ref


@torch.no_grad()
def pmf(p, image, camera, v2x, offsets, native: int, output: int,
        prec: ref.Precision, passes_per_block: int = 8) -> torch.Tensor:
  """float32 [B, output³, C] class probabilities (eval mode)."""
  m = output // native
  dev = camera.device
  zz, yy, xx = np.meshgrid(*([np.arange(m)] * 3), indexing="ij")
  lattice = torch.from_numpy(
      (np.stack([xx, yy, zz], -1).reshape(-1, 3) / m).astype(np.float32)
  ).to(dev)
  native_offsets = lattice[:, None] + offsets[None] / m  # [m³, B, 3]
  scale = torch.tensor([1 / m, 1 / m, 1 / m, 1.0], dtype=torch.float32,
                       device=dev)
  v2s = ref.compute_v2s(camera, v2x * scale)
  taps, average = ref.resnet50(p, image, False, prec)
  b = image.shape[0]
  out = []
  for block in torch.split(native_offsets, passes_per_block):
    k = block.shape[0]
    logits = ref.decoder(
        p, {t: v.repeat(k, 1, 1, 1) for t, v in taps.items()},
        average.repeat(k, 1), v2s.repeat(k, 1, 1), block.reshape(k * b, 3),
        (native,) * 3, False, prec)
    out.append(torch.softmax(logits, dim=-1).reshape((k, b) +
                                                     logits.shape[1:]))
  pmfs = torch.cat(out)  # [m³, B, n, n, n, C]
  c = pmfs.shape[-1]
  pmfs = pmfs.reshape((m, m, m, b) + (native,) * 3 + (c,))
  pmfs = pmfs.permute(3, 4, 0, 5, 1, 6, 2, 7)
  return pmfs.reshape(b, output, output, output, c)
