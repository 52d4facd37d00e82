"""The port's demo CLI (python -m corenet_tpu_torch.cli.demo) against the
JAX package's, on the CPU, on the `.cpt` of tests/test_torch_cli.py (written
by `corenet_tpu.train.checkpoint.encode_state`): both write a tile of the
same shape, within L1 < 1.0 of each other (the mean absolute difference
per channel value; the renderers agree, and the input image's bicubic
resampling differs slightly between PIL and torch).
"""

import numpy as np
import PIL.Image
import pytest
import torch

from corenet_tpu.cli import demo as jax_demo
from corenet_tpu_torch.cli import demo
from corenet_tpu_torch.utils.png import decode_png
from test_torch_cli import RES, checkpoint  # noqa: F401  (a fixture)

torch.set_num_threads(2)


def test_both_demo_clis_write_the_same_tile(checkpoint, tmp_path):
  path, scene, meshes_dir, _ = checkpoint
  args = [f"--scene={scene}", f"--meshes_dir={meshes_dir}",
          f"--checkpoint={path}", f"--resolution={RES}"]
  jax_demo.main(args + [f"--output={tmp_path / 'jax.png'}"])
  got = demo.main(args + [f"--output={tmp_path / 'port.png'}",
                          "--device=cpu"])
  want = np.asarray(PIL.Image.open(tmp_path / "jax.png"))
  png = decode_png((tmp_path / "port.png").read_bytes())
  np.testing.assert_array_equal(png, got)
  assert png.shape == want.shape == (5 * 256, 5 * 256, 3)
  l1 = float(np.abs(png.astype(np.int32) - want).mean())
  assert l1 < 1.0, l1
  with pytest.raises(NotImplementedError, match="slice 8b"):
    demo.main(args[:2] + ["--checkpoint=model.pb", "--device=cpu"])
