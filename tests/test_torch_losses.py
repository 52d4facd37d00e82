"""The PyTorch port's losses (corenet_tpu_torch/models/losses.py) and the
FG_BG loss sums (corenet_tpu_torch/ops/fgbg_loss.py) against the JAX
package's, on the CPU.

`fgbg_sums` runs the Pallas kernel in interpret mode, as
tests/test_fgbg_loss.py runs it. Tolerances: the sums and the losses
within 1e-6 relative (the JAX package's own contract for the kernel,
docs/kernels.md), gradients within 1e-6 of their largest element for the
sums and 1e-5 relative for the losses (f32 sums taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu.models import losses as jax_losses
from corenet_tpu.ops import fgbg_loss as jax_fgbg
from corenet_tpu_torch.models import losses
from corenet_tpu_torch.ops import fgbg_loss as fgbg
from corenet_tpu_torch.utils import tracing

torch.set_num_threads(2)

GT_DTYPES = {"int32": (np.int32, torch.int32),
             "uint8": (np.uint8, torch.uint8),
             "float32": (np.float32, torch.float32)}
LOSSES = ["iou_agnostic", "iou_fgbg", "xent", "xent_times_iou_agnostic",
          "xent_times_iou_fgbg"]


def _count(name: str) -> int:
  """A counter's total (corenet_tpu_torch/utils/tracing.py)."""
  return tracing.counters()[name]


def _sums_inputs(gt_dtype, empty_scene):
  """diff and labels [2, 32³]; with `empty_scene`, scene 1 has no
  foreground and σ(diff) underflows to 0 everywhere, so its union is 0."""
  rng = np.random.default_rng(len(gt_dtype) + empty_scene)
  diff = (rng.standard_normal((2, 32 ** 3)) * 3).astype(np.float32)
  gt = (rng.random((2, 32 ** 3)) < 0.3).astype(GT_DTYPES[gt_dtype][0])
  if empty_scene:
    gt[1] = 0
    diff[1] = -200.0
  return diff, gt


@pytest.mark.parametrize("empty_scene", [False, True])
@pytest.mark.parametrize("gt_dtype", sorted(GT_DTYPES))
def test_fgbg_sums_and_gradient_match_pallas(gt_dtype, empty_scene):
  diff, gt = _sums_inputs(gt_dtype, empty_scene)
  weights = np.array([0.7, -1.3], np.float32)  # a cotangent for each sum

  def jax_objective(d):
    inter, union = jax_fgbg.fgbg_sums(d, jnp.asarray(gt), interpret=True)
    return (inter * weights[0] + union * weights[1]).sum(), (inter, union)

  (_, (ref_inter, ref_union)), ref_grad = jax.value_and_grad(
      jax_objective, has_aux=True)(jnp.asarray(diff))

  d = torch.from_numpy(diff).requires_grad_(True)
  inter, union = fgbg.fgbg_sums(d, torch.from_numpy(gt).to(
      GT_DTYPES[gt_dtype][1]))
  (inter * float(weights[0]) + union * float(weights[1])).sum().backward()

  for got, ref in ((inter, ref_inter), (union, ref_union)):
    tt.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-6,
                       atol=0)
  if empty_scene:
    assert float(union[1].detach()) == 0.0
  # σ'(diff) = s·(1 − s) from two sigmoid implementations: near s = 1 the
  # factor (1 − s) magnifies their last-bit differences, so the gradient
  # is held to 1e-6 of its largest element.
  ref_grad = np.asarray(ref_grad)
  tt.assert_allclose(d.grad.numpy(), ref_grad, rtol=1e-6,
                     atol=1e-6 * np.abs(ref_grad).max())


def test_fgbg_sums_plain_version_on_cpu_without_counting():
  diff, gt = (torch.from_numpy(a) for a in _sums_inputs("int32", False))
  before = _count("fgbg_loss.launches")
  got = fgbg.fgbg_sums(diff, gt)
  assert _count("fgbg_loss.launches") == before
  ref = fgbg.fgbg_sums_reference(diff, gt)
  assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
  with pytest.raises(TypeError):
    fgbg.fgbg_sums(diff.double(), gt)
  with pytest.raises(TypeError):
    fgbg.fgbg_sums(diff, gt.long())
  with pytest.raises(ValueError):
    fgbg.fgbg_sums(diff, gt[:1])
  with pytest.raises(ValueError):
    fgbg.fgbg_sums(diff.t(), gt.t())


def _loss_inputs(c, weighted, seed):
  rng = np.random.default_rng(seed)
  shape = (2, 8, 16, 8)
  gt = rng.integers(0, c, shape).astype(np.int32)
  logits = (rng.standard_normal(shape + (c,)) * 2).astype(np.float32)
  weights = (rng.uniform(0.0, 2.0, shape).astype(np.float32)
             if weighted else None)
  return gt, logits, weights


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("c", [2, 4])
@pytest.mark.parametrize("name", LOSSES)
def test_loss_and_gradient_match_jax(name, c, weighted):
  gt, logits, weights = _loss_inputs(c, weighted, seed=c + 10 * weighted)
  jax_fn = getattr(jax_losses, name)
  jw = None if weights is None else jnp.asarray(weights)
  ref, ref_grad = jax.value_and_grad(
      lambda l: jax_fn(jnp.asarray(gt), l, jw))(jnp.asarray(logits))

  lt = torch.from_numpy(logits).requires_grad_(True)
  tw = None if weights is None else torch.from_numpy(weights)
  got = getattr(losses, name)(torch.from_numpy(gt), lt, tw)
  got.backward()
  tt.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
  ref_grad = np.asarray(ref_grad)
  tt.assert_allclose(lt.grad.numpy(), ref_grad, rtol=1e-5,
                     atol=1e-5 * np.abs(ref_grad).max())


def test_iou_fgbg_takes_the_sums_for_two_classes_without_weights(
    monkeypatch):
  calls = []
  real = fgbg.fgbg_sums

  def spy(diff, gt):
    calls.append(diff.dtype)
    return real(diff, gt)

  monkeypatch.setattr(fgbg, "fgbg_sums", spy)
  gt, logits, weights = _loss_inputs(2, True, seed=3)
  gt, logits, weights = (torch.from_numpy(a) for a in (gt, logits, weights))
  losses.iou_fgbg(gt.to(torch.uint8), logits)
  losses.iou_fgbg(gt, logits, weights)
  assert calls == [torch.float32]
  assert fgbg.use_fgbg_kernel(logits, None)
  assert not fgbg.use_fgbg_kernel(logits, weights)
