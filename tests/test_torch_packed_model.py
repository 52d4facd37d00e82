"""The PyTorch port's packed (space-to-depth) execution of the whole model
against the JAX package's and against the port's own fine execution, on
the CPU: the decoder's logits for every packing stage, gradients, the
phase-loss training step on factor-64 logits and super-resolution
serving. TrainPipeline and the CLIs are in
tests/test_torch_packed_pipeline.py.

Weights are flax-initialized with random BatchRenorm statistics
(tests/test_torch_model.py) and bridged with models/convert.py: a packed
model loads the fine model's state_dict. Everything here is float32 on
both sides, so logits are held to 1e-5 · max|logit| (they agree to about
2.5e-6), not to the JAX package's packed envelope of 2e-3, which covers
the TPU's bf16 matrix units; super-resolution's PMFs to 1e-4, as
tests/test_torch_model.py holds the fine ones. Gradients are held to
tests/test_packing.py's rule (each leaf within 5e-3 of its largest
magnitude), the training step to tests/test_torch_train_step.py's
levels.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu.eval import super_resolution as jax_sr
from corenet_tpu.models.corenet import CoreNet as JaxCoreNet
from corenet_tpu.models.corenet import CoreNetConfig as JaxCoreNetConfig
from corenet_tpu.models.corenet import DecoderConfig as JaxDecoderConfig
from corenet_tpu_torch.eval.super_resolution import (
    super_resolution_from_model)
from corenet_tpu_torch.models import convert
from corenet_tpu_torch.models.convert import state_dict_from_jax
from corenet_tpu_torch.models.corenet import (
    CoreNet, CoreNetConfig, DecoderConfig)
from corenet_tpu_torch.models.decoder import packed_eligible
from corenet_tpu_torch.ops import phased_gt as phased
from corenet_tpu_torch.ops import skip_gather as op
from corenet_tpu_torch.train.state import create_train_state
from corenet_tpu_torch.train.step import make_train_step
from test_torch_model import BATCH, _scene, _variables
from test_torch_train_step import (
    VOX_KWARGS, _assert_step_matches, _jax_step, _triangle_batch)

torch.set_num_threads(2)

LOGIT_TOL = 1e-5  # of max|logit|, float32 on both sides


def _models(res, **packed):
  """The JAX and the port CoreNet at res³, 2 classes."""
  jax_model = JaxCoreNet(JaxCoreNetConfig(decoder=JaxDecoderConfig(
      resolution=(res,) * 3, num_output_channels=2)), **packed)
  model = CoreNet(CoreNetConfig(DecoderConfig((res,) * 3, 2)), **packed)
  model.load_state_dict(state_dict_from_jax(_variables(res)))
  return jax_model, model.eval()


@functools.lru_cache(maxsize=None)
def _fine_logits(res):
  _, model = _models(res)
  image, v2s, offsets = _scene(res)
  with torch.no_grad():
    return model(*(torch.from_numpy(a) for a in (image, v2s, offsets)))


@pytest.mark.parametrize("pfs", [2, 4, 5, 6])
def test_packed_decoder_matches_jax_packed_and_port_fine(pfs):
  image, v2s, offsets = _scene(64)
  jax_model, model = _models(64, packed_decoder=True, pack_from_stage=pfs)
  want = np.asarray(jax.jit(functools.partial(jax_model.apply, train=False))(
      _variables(64), image, v2s, offsets))
  with torch.no_grad():
    got = model(*(torch.from_numpy(a) for a in (image, v2s, offsets)))
  fine = _fine_logits(64)
  assert got.shape == fine.shape == want.shape == (BATCH, 64, 64, 64, 2)
  scale = float(fine.abs().max())
  tt.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL * scale)
  tt.assert_allclose(got.numpy(), fine.numpy(), rtol=0,
                     atol=LOGIT_TOL * scale)


def test_packed_state_dict_is_the_fine_one():
  """The same keys, shapes and tensors both ways through the bridge."""
  fine = CoreNet(CoreNetConfig(DecoderConfig((64,) * 3, 2)))
  packed = CoreNet(CoreNetConfig(DecoderConfig((64,) * 3, 2)),
                   packed_decoder=True, pack_from_stage=2, phase_output=True)
  want = fine.state_dict()
  got = packed.state_dict()
  assert list(got) == list(want)
  assert all(got[k].shape == want[k].shape for k in want)
  sd = state_dict_from_jax(_variables(64))
  packed.load_state_dict(sd)
  back = convert.jax_variables_from_state_dict(packed.state_dict())
  assert jax.tree_util.tree_all(jax.tree_util.tree_map(
      np.array_equal, back, jax.tree_util.tree_map(np.asarray,
                                                   _variables(64))))


def test_packed_eligibility_and_refusals():
  h7 = DecoderConfig((128,) * 3, 2)
  y1 = DecoderConfig((32,) * 3, 2)
  assert packed_eligible((128,) * 3, 2, 2)
  assert packed_eligible((32,) * 3, 2, 5)
  assert not packed_eligible((32,) * 3, 2, 2)  # a 1³ seed grid
  assert not packed_eligible((128,) * 3, 4, 5)
  assert not packed_eligible((128,) * 3, 2, 7)
  with pytest.raises(ValueError, match="pack_from_stage"):
    CoreNet(CoreNetConfig(h7), packed_decoder=True, pack_from_stage=7)
  with pytest.raises(ValueError, match="even grid"):
    CoreNet(CoreNetConfig(y1), packed_decoder=True, pack_from_stage=2)


@pytest.mark.parametrize("res,seed_grid_even", [(32, False), (64, True),
                                                (96, False), (128, True)])
def test_the_pipeline_rule_is_eligibility_at_stage_2(res, seed_grid_even):
  """TrainPipeline's 'auto' packs where the JAX pipeline does: an even seed
  grid (res / 32), which is packed_eligible at pack_from_stage 2; the
  default pack_from_stage 5 takes every one of these grids."""
  assert packed_eligible((res,) * 3, 2, 2) == seed_grid_even
  assert packed_eligible((res,) * 3, 2, 5)
  if not seed_grid_even:
    with pytest.raises(ValueError, match="even grid at the packing point"):
      CoreNet(CoreNetConfig(DecoderConfig((res,) * 3, 2)),
              packed_decoder=True, pack_from_stage=2, device="meta")


def test_packed_trains_after_serving_in_inference_mode():
  """The packed kernels' cached tap indices are made outside inference
  mode: a packed forward under torch.inference_mode, then a backward."""
  from corenet_tpu_torch.models import packing
  packing._conv_index.cache_clear()
  packing._conv_transpose_index.cache_clear()
  _, model = _models(32, packed_decoder=True)
  image, v2s, offsets = (torch.from_numpy(a) for a in _scene(32))
  with torch.inference_mode():
    served = model(image, v2s, offsets)
  model(image, v2s, offsets).sum().backward()
  assert model.decoder.stage_6_c.weight.grad is not None
  assert served.shape == (BATCH, 32, 32, 32, 2)


def test_packed_gradients_match_fine():
  """d(loss)/d(params) through the packed decoder (pfs 5: packed skip
  concatenation, the packed-order skip gather's backward) against the
  fine decoder, eval mode, as tests/test_packing.py holds JAX's."""
  image, v2s, offsets = (torch.from_numpy(a) for a in _scene(32))
  target = torch.from_numpy((np.random.default_rng(11).random(
      (BATCH, 32, 32, 32, 2)) > 0.7).astype(np.float32))
  grads = []
  for packed in (False, True):
    _, model = _models(32, packed_decoder=packed)
    ((model(image, v2s, offsets) - target) ** 2).mean().backward()
    grads.append({n: p.grad for n, p in model.named_parameters()})
  fine, packed = grads
  assert list(fine) == list(packed)
  for name, g in fine.items():
    scale = max(float(g.abs().max()), 1e-6)
    tt.assert_allclose(packed[name].numpy() / scale, g.numpy() / scale,
                       rtol=0, atol=5e-3, err_msg=name)


def test_packed_phase_loss_step_on_device_gt_matches_jax():
  """The JAX package's default training step: GT voxelized in the step,
  phased at s = 4 (factor 64) for the packed decoder's deep-phase logits."""
  variables = _variables(32)
  batch = _triangle_batch()
  jax_model = JaxCoreNet(JaxCoreNetConfig(decoder=JaxDecoderConfig(
      resolution=(32,) * 3, num_output_channels=2)), packed_decoder=True,
                         phase_output=True)
  ref = _jax_step(variables, batch, jax_model, VOX_KWARGS)

  model = CoreNet(CoreNetConfig(DecoderConfig((32,) * 3, 2)),
                  phase_output=True, packed_decoder=True)
  model.load_state_dict(state_dict_from_jax(variables))
  state = create_train_state(model, device="cpu")
  step = make_train_step(state.model, state.optimizer, "FG_BG", (32,) * 3,
                         voxelization_kwargs=VOX_KWARGS)
  factors = []
  real = phased.phased_gt_forward
  phased.phased_gt_forward = lambda packed, s: (factors.append(s),
                                                real(packed, s))[1]
  try:
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
  finally:
    phased.phased_gt_forward = real
  assert factors == [4]
  _assert_step_matches(ref, model, state, metrics)


def test_packed_phase_loss_equals_plain_loss_on_unpacked_logits():
  """The factor-64 logits with labels phased at s = 4 give the loss of the
  same logits unpacked with the plain grid: only the sums' order differs.
  Also on the labeled-grid branch (phase_permute at s = 4)."""
  from corenet_tpu_torch.models.losses import iou_fgbg
  from corenet_tpu_torch.ops.phased_gt import phase_permute
  _, model = _models(32, packed_decoder=True, phase_output=True)
  image, v2s, offsets = (torch.from_numpy(a) for a in _scene(32))
  with torch.no_grad():
    logits = model(image, v2s, offsets)
  fine = _fine_logits(32)
  assert logits.shape == (BATCH, 8, 8, 8, 128)
  b = BATCH
  x = logits.reshape(b, 8, 8, 8, 2, 2, 2, 2, 2, 2, 2).permute(
      0, 1, 4, 7, 2, 5, 8, 3, 6, 9, 10).reshape(b, 32, 32, 32, 2)
  tt.assert_allclose(x.numpy(), fine.numpy(), rtol=0,
                     atol=LOGIT_TOL * float(fine.abs().max()))
  grid = torch.from_numpy((np.random.default_rng(3).random(
      (b, 32, 32, 32)) < 0.3).astype(np.uint8))
  phase = iou_fgbg(phase_permute(grid, 4), logits.reshape(b, 8, 8, -1, 2))
  tt.assert_allclose(float(phase), float(iou_fgbg(grid, x)), rtol=1e-6)


def test_packed_super_resolution_matches_jax():
  """super_resolution_from_model(packed_execution=True) at 32³ native,
  m = 2 with the 8 offsets folded into the batch (y1's way), against the
  JAX package's packed execution (its default)."""
  batch_offsets = True
  image, _, offsets = _scene(32, seed=2)
  camera = np.array([[2, 0, 0.1, -1], [0, 2, 0, -1], [0, 0, 2, -1],
                     [0, 0, 0.2, 1]], np.float32)
  camera = np.broadcast_to(camera, (BATCH, 4, 4)).copy()
  v2x = np.broadcast_to(np.diag([64.0, 64.0, 64.0, 1.0]).astype(np.float32),
                        (BATCH, 4, 4)).copy()
  inputs = (image, camera, v2x, offsets, (64,) * 3)
  jax_model, model = _models(32)
  ref = np.asarray(jax_sr.super_resolution_from_model(
      jax_model, _variables(32), (32,) * 3, packed_execution=True,
      batch_offsets=batch_offsets)(*inputs))
  calls = []
  real = op.skip_gather
  op.skip_gather = lambda *a, **k: (calls.append(k.get("phases", 1)),
                                    real(*a, **k))[1]
  try:
    got = super_resolution_from_model(
        model, model.state_dict(), (32,) * 3, batch_offsets=batch_offsets,
        packed_execution=True, device="cpu")(*inputs).numpy()
  finally:
    op.skip_gather = real
  assert 8 in calls  # skip 5 gathered in packed order
  assert got.shape == ref.shape == (BATCH, 64, 64, 64, 2)
  tt.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
  # tests/test_torch_model.py's level for the fine super-resolution; the
  # two agree to about 3.3e-5 here.
  tt.assert_allclose(got, ref, rtol=0, atol=1e-4)
  assert model.training is False and not model.packed_decoder
