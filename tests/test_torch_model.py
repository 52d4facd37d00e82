"""The PyTorch port's serving path (corenet_tpu_torch) against the JAX
package, on the CPU, at small sizes: the ray-traced skip's projection and
gather, the whole CoreNet in eval mode, and super-resolution inference.

The weights are initialized by flax (`model.init`) with random
BatchRenorm running statistics, and bridged into the port with
models/convert.py. Inputs are numpy arrays made from fixed seeds.
"""

import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu.eval import super_resolution as jax_sr
from corenet_tpu.models import layers as jax_layers
from corenet_tpu.models import skip as jax_skip
from corenet_tpu.models.corenet import CoreNet as JaxCoreNet
from corenet_tpu.models.corenet import CoreNetConfig as JaxCoreNetConfig
from corenet_tpu.models.corenet import DecoderConfig as JaxDecoderConfig
from corenet_tpu.train.step import compute_v2s as jax_compute_v2s
from corenet_tpu_torch.eval.super_resolution import (
    super_resolution_from_model)
from corenet_tpu_torch.models import skip
from corenet_tpu_torch.models.convert import state_dict_from_jax
from corenet_tpu_torch.models.corenet import (
    CoreNet, CoreNetConfig, DecoderConfig)
from corenet_tpu_torch.train.step import compute_v2s, make_eval_forward

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
BATCH = 2
IMAGE_HW = 64


def _jax_model(res):
  return JaxCoreNet(JaxCoreNetConfig(decoder=JaxDecoderConfig(
      resolution=(res,) * 3, num_output_channels=2)))


def _torch_model(res, variables):
  model = CoreNet(CoreNetConfig(DecoderConfig((res,) * 3, 2)))
  model.load_state_dict(state_dict_from_jax(variables))
  return model.eval()


@functools.lru_cache(maxsize=None)
def _variables(res):
  """flax-initialized CoreNet variables (numpy) for a res³ grid, with
  random running statistics. One flax init of the whole model serves every
  resolution: only stage_1_t's kernel (k = stride = res / 32) depends on
  it, and that layer gets its own flax init."""
  if res == 32:
    model = _jax_model(32)
    variables = jax.jit(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMAGE_HW, IMAGE_HW, 3),
                                         jnp.uint8),
        jnp.eye(4)[None], jnp.zeros((1, 3)),
        train=False))()
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(1)

    def randomize(path, value):
      name = path[-1].key
      if name == "mean":
        return rng.normal(0, 0.3, value.shape).astype(np.float32)
      if name == "var":
        return rng.uniform(0.5, 2.0, value.shape).astype(np.float32)
      return value

    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        randomize, variables["batch_stats"])
    return variables
  ir = res // 32
  stage_1_t = jax_layers.ConvTranspose(256, ir, ndim=3, stride=ir).init(
      jax.random.PRNGKey(res), jnp.zeros((1, 1, 1, 1, 67)))
  variables = jax.tree_util.tree_map(lambda v: v, _variables(32))
  variables["params"]["decoder"]["stage_1_t"] = jax.tree_util.tree_map(
      np.asarray, stage_1_t["params"])
  return variables


def _scene(res, seed=0):
  """uint8 images, an affine-plus-perspective voxel → screen matrix that
  keeps most of the grid on screen, and in-voxel offsets."""
  rng = np.random.default_rng(seed)
  image = rng.integers(0, 256, (BATCH, IMAGE_HW, IMAGE_HW, 3)).astype(
      np.uint8)
  mats = []
  for i in range(BATCH):
    m = np.diag([1.8 / res, 1.8 / res, 1.8 / res, 1.0]).astype(np.float32)
    m[:3, 3] = -0.9
    m[0, 2] = 0.05 * (i + 1) / res
    m[3, 2] = 0.2 / res
    mats.append(m)
  offsets = rng.uniform(0.25, 0.75, (BATCH, 3)).astype(np.float32)
  return image, np.stack(mats), offsets


def _skip_matrices(res):
  """Projections with voxels off-image and voxels behind the camera."""
  mats = []
  for i in range(BATCH):
    s = 2.6 / res  # slightly over-wide: some voxels project off-image
    mats.append(np.array([[s, 0, 0.01 * i, -1.2], [0, s, 0.005, -1.1],
                          [0, 0.002, 1.0 / res, -0.15],  # some depths < 0
                          [0, 0, 0.01, 1.05]], np.float32))
  return np.stack(mats)


def test_port_imports_neither_jax_nor_the_jax_package():
  files = sorted((REPO / "corenet_tpu_torch").rglob("*.py"))
  files.append(REPO / "chip_smoke.py")
  banned = {"jax", "jaxlib", "flax", "optax", "corenet_tpu", "pandas",
            "msgpack", "tensorboard"}
  offenders = []
  for path in files:
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
      if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
      elif isinstance(node, ast.ImportFrom) and node.level == 0:
        names = [node.module]
      else:
        continue
      offenders += [f"{path.relative_to(REPO)}: {n}" for n in names
                    if n.split(".")[0] in banned]
  assert len(files) > 10
  assert not offenders, offenders


def test_importing_every_port_module_loads_neither_jax_nor_pandas():
  """A fresh interpreter imports every module of the port: none of JAX, the
  JAX package, pandas, PIL, msgpack or tensorboard gets loaded on the way
  (the card's machine is not known to have the last four)."""
  import subprocess
  import sys
  modules = sorted(
      ".".join(path.relative_to(REPO).with_suffix("").parts).removesuffix(
          ".__init__")
      for path in (REPO / "corenet_tpu_torch").rglob("*.py"))
  assert {"corenet_tpu_torch.eval.pipeline", "corenet_tpu_torch.cli.eval",
          "corenet_tpu_torch.cli.demo", "corenet_tpu_torch.viz.renderer",
          "corenet_tpu_torch.train.checkpoint",
          "corenet_tpu_torch.utils.summary",
          "corenet_tpu_torch.train.pipeline", "corenet_tpu_torch.cli.train",
          "corenet_tpu_torch.cli.import_resnet50_checkpoint"} <= set(modules)
  assert len(modules) > 45
  code = (
      "import importlib, sys\n"
      f"for name in {modules!r}:\n"
      "  importlib.import_module(name)\n"
      "loaded = {m.split('.')[0] for m in sys.modules}\n"
      "bad = loaded & {'jax', 'jaxlib', 'flax', 'optax', 'corenet_tpu', "
      "'pandas', 'PIL', 'msgpack', 'tensorboard'}\n"
      "assert not bad, bad\n")
  subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                 timeout=300)


def test_skip_indices_and_gather_match_jax():
  res = (32, 32, 32)
  h = w = 16
  mats = _skip_matrices(res[0])
  loc = np.full((BATCH, 3), 0.5, np.float32)
  # A map whose values are the padded flat index of each pixel, with -1 in
  # the pad: the JAX gather then reports the pixel it read.
  yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
  index_map = ((yy + 1) * (w + 2) + xx + 1).astype(np.float32)
  index_map = np.broadcast_to(index_map[None, :, :, None], (BATCH, h, w, 1))
  jax_idx = np.asarray(jax_skip.sample_grid2d(
      jnp.asarray(index_map), jnp.asarray(mats), jnp.asarray(loc), res,
      outside_value=-1.0)).reshape(BATCH, -1)
  px, py = skip.voxel_pixel_indices(torch.from_numpy(mats),
                                    torch.from_numpy(loc), res, h, w)
  px, py = px.numpy(), py.numpy()
  pad = (px == 0) | (px == w + 1) | (py == 0) | (py == h + 1)
  idx = np.where(pad, -1, py * (w + 2) + px)
  agree = idx == jax_idx
  # Voxels off-image and (depth row: z < 4.8) behind the camera both read
  # the pad.
  assert 0.01 < pad.mean() < 0.9
  # Projections that land on a pixel boundary may round either way.
  assert agree.mean() >= 0.9999, f"{(~agree).sum()} of {agree.size} differ"

  rng = np.random.default_rng(5)
  g2d = rng.standard_normal((BATCH, h, w, 6)).astype(np.float32)
  ref = np.asarray(jax_skip.sample_grid2d(
      jnp.asarray(g2d), jnp.asarray(mats), jnp.asarray(loc), res,
      outside_value=0.25)).reshape(BATCH, -1, 6)
  got = skip.sample_grid2d(torch.from_numpy(g2d), torch.from_numpy(mats),
                           torch.from_numpy(loc), res, outside_value=0.25)
  assert got.shape == (BATCH,) + res + (6,)
  got = got.numpy().reshape(BATCH, -1, 6)
  assert np.array_equal(got[agree], ref[agree])


@pytest.mark.parametrize("res", [32, 64])
def test_corenet_eval_logits_match_jax(res):
  variables = _variables(res)
  image, v2s, offsets = _scene(res)
  model = _jax_model(res)
  ref = np.asarray(jax.jit(
      lambda v, i, p, o: model.apply(v, i, p, o, train=False))(
          variables, image, v2s, offsets))
  with torch.inference_mode():
    got = _torch_model(res, variables)(
        torch.from_numpy(image), torch.from_numpy(v2s),
        torch.from_numpy(offsets)).numpy()
  assert got.shape == ref.shape == (BATCH, res, res, res, 2)
  assert np.isfinite(got).all()
  # f32 end to end, different conv kernels: the tolerance of
  # tests/test_full_model_parity.py.
  tt.assert_allclose(got, ref, atol=2e-3 * np.abs(ref).max(), rtol=2e-3)


@functools.lru_cache(maxsize=None)
def _jax_super_resolution(m):
  image, _, offsets = _scene(32, seed=m)
  camera = np.array([[2, 0, 0.1, -1], [0, 2, 0, -1], [0, 0, 2, -1],
                     [0, 0, 0.2, 1]], np.float32)
  camera = np.broadcast_to(camera, (BATCH, 4, 4)).copy()
  res = 32 * m
  v2x = np.broadcast_to(np.diag([res, res, res, 1.0]).astype(np.float32),
                        (BATCH, 4, 4)).copy()
  inputs = (image, camera, v2x, offsets, (res,) * 3)
  infer = jax_sr.super_resolution_from_model(
      _jax_model(32), _variables(32), (32, 32, 32), packed_execution=False,
      batch_offsets=False)
  return inputs, np.asarray(infer(*inputs))


@pytest.mark.parametrize("batch_offsets", [False, True])
@pytest.mark.parametrize("m", [1, 2])
def test_super_resolution_matches_jax(m, batch_offsets):
  inputs, ref = _jax_super_resolution(m)
  model = CoreNet(CoreNetConfig(DecoderConfig((32, 32, 32), 2)))
  infer = super_resolution_from_model(
      model, state_dict_from_jax(_variables(32)), (32, 32, 32),
      batch_offsets=batch_offsets, packed_execution=False, device="cpu")
  got = infer(*inputs).numpy()
  assert got.shape == ref.shape == (BATCH,) + (32 * m,) * 3 + (2,)
  tt.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
  tt.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_eval_forward_matches_jax():
  # At m = 1 the JAX super-resolution is the eval forward: one pass at the
  # caller's offsets, softmax over the classes.
  (image, camera, v2x, offsets, _), ref = _jax_super_resolution(1)
  model = _torch_model(32, _variables(32))
  got = make_eval_forward(model)(*(torch.from_numpy(a) for a in (
      image, camera, v2x, offsets))).numpy()
  assert got.shape == ref.shape
  tt.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_compute_v2s_matches_jax(batch):
  rng = np.random.default_rng(len(batch))
  camera = rng.standard_normal(batch + (4, 4)).astype(np.float32)
  v2x = np.zeros(batch + (4, 4), np.float32)
  v2x[..., [0, 1, 2], [0, 1, 2]] = rng.uniform(8, 128, batch + (3,))
  v2x[..., 3, 3] = 1
  ref = np.asarray(jax_compute_v2s(jnp.asarray(camera), jnp.asarray(v2x)))
  got = compute_v2s(torch.from_numpy(camera), torch.from_numpy(v2x))
  # A diagonal product has one nonzero term per entry: exact both ways.
  assert np.array_equal(got.numpy(), ref)


def test_super_resolution_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  model = CoreNet(CoreNetConfig(DecoderConfig((32, 32, 32), 2)))
  with pytest.raises(RuntimeError, match="no CUDA device"):
    super_resolution_from_model(model, model.state_dict(), (32, 32, 32))
