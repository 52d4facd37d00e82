"""The PyTorch port's training state and step (corenet_tpu_torch/train/)
against the JAX package's, on the CPU.

One FG_BG step at 32³, batch 2, 64² images, from flax-initialized weights
with random BatchRenorm running statistics, on a batch that carries its
ground-truth grid (the JAX step's host-GT branch). The JAX step runs with
an optimizer that keeps the gradients in its state and leaves the
parameters alone, so one compiled step gives its loss, gradients and new
batch statistics. Loss and statistics agree within 1e-4 relative. The
gradients are held to the three levels of evidence of
tests/test_train_step_grad_parity.py: a 55-layer f32 backward through
train-mode BatchRenorm amplifies the two frameworks' rounding with the
distance from the loss, so the layers next to the loss agree within 5 %
relative L2, every gradient that carries mass points the same way
(cosine ≥ 0.90), and so do all of them together (cosine ≥ 0.96).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as tt
import optax
import pytest
import torch

from corenet_tpu.train.state import create_optimizer as jax_create_optimizer
from corenet_tpu.train.state import create_train_state as jax_train_state
from corenet_tpu.train.step import make_train_step as jax_make_train_step
from corenet_tpu_torch.models.convert import state_dict_from_jax
from corenet_tpu_torch.models.corenet import (
    CoreNet, CoreNetConfig, DecoderConfig)
from corenet_tpu_torch.train.state import (
    create_optimizer, create_train_state)
from corenet_tpu_torch.train.step import loss_fn_for_task, make_train_step
from test_torch_model import BATCH, _jax_model, _scene, _variables

torch.set_num_threads(2)

RES = (32, 32, 32)


def test_adam_matches_optax():
  rng = np.random.default_rng(0)
  params = {"w": rng.standard_normal((5, 7)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32) * 0.1}
  # Gradients from large to far below eps = 1e-4.
  grads = [{k: (rng.standard_normal(v.shape) * 10.0 ** -rng.integers(
      1, 7, v.shape)).astype(np.float32) for k, v in params.items()}
           for _ in range(3)]

  optimizer = jax_create_optimizer()
  jp = jax.tree_util.tree_map(jnp.asarray, params)
  opt_state = optimizer.init(jp)
  for g in grads:
    updates, opt_state = optimizer.update(
        jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
    jp = optax.apply_updates(jp, updates)

  tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
        for k, v in params.items()}
  adam = create_optimizer(tp.values())
  for g in grads:
    for k, p in tp.items():
      p.grad = torch.from_numpy(g[k])
    adam.step()
  for k, p in tp.items():
    tt.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                       atol=1e-6 * np.abs(params[k]).max())
    # The parameters moved by about 3 lr where the gradients were large.
    assert np.abs(p.detach().numpy() - params[k]).max() > 2e-4


def _grad_keeper() -> optax.GradientTransformation:
  """An optimizer that stores the gradients in its state and leaves the
  parameters unchanged."""

  def init(params):
    return {"grads": jax.tree_util.tree_map(jnp.zeros_like, params)}

  def update(grads, state, params=None):
    del state, params
    return jax.tree_util.tree_map(jnp.zeros_like, grads), {"grads": grads}

  return optax.GradientTransformation(init, update)


def _batch():
  """The scenes of tests/test_torch_model.py as a training batch: v2x a
  diagonal scale (32, a power of two, so compute_v2s recovers the scene's
  matrix exactly) and a grid of one ellipsoid per scene."""
  image, v2s, offsets = _scene(RES[0])
  v2x = np.broadcast_to(np.diag([32.0, 32.0, 32.0, 1.0]).astype(np.float32),
                        (BATCH, 4, 4)).copy()
  camera = v2s * np.array([32.0, 32.0, 32.0, 1.0], np.float32)
  z, y, x = np.meshgrid(*([np.arange(32) + 0.5] * 3), indexing="ij")
  grid = np.stack([
      (((x - 14 - i) / 9) ** 2 + ((y - 17) / 11) ** 2
       + ((z - 15 + i) / 8) ** 2 <= 1.0) for i in range(BATCH)]).astype(
           np.int32)
  return {"image": image, "camera": camera, "v2x": v2x, "grid": grid,
          "grid_offset": offsets}


def _jax_step(variables, batch):
  model = _jax_model(RES[0])
  optimizer = _grad_keeper()
  state = jax_train_state(jax.tree_util.tree_map(jnp.asarray, variables),
                          optimizer)
  step = jax_make_train_step(model, optimizer, "FG_BG", RES, donate=False)
  state, metrics = step(state, jax.tree_util.tree_map(jnp.asarray, batch))
  return (float(metrics["loss"]), int(state.global_step),
          jax.tree_util.tree_map(np.asarray, state.opt_state["grads"]),
          jax.tree_util.tree_map(np.asarray, state.batch_stats))


def test_fgbg_train_step_matches_jax():
  variables = _variables(RES[0])
  batch = _batch()
  assert 0.05 < batch["grid"].mean() < 0.5
  ref_loss, ref_step, ref_grads, ref_stats = _jax_step(variables, batch)

  model = CoreNet(CoreNetConfig(DecoderConfig(RES, 2)))
  model.load_state_dict(state_dict_from_jax(variables))
  state = create_train_state(model, device="cpu")
  step = make_train_step(state.model, state.optimizer, "FG_BG", RES)
  state, metrics = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})

  assert ref_step == state.global_step == BATCH
  tt.assert_allclose(float(metrics["loss"]), ref_loss, rtol=1e-4)

  # The new running statistics, `steps` counters included, through the
  # weight bridge.
  want = state_dict_from_jax({"params": {}, "batch_stats": ref_stats})
  got = model.state_dict()
  assert len(want) == 3 * sum(1 for k in got if k.endswith(".steps"))
  for key, value in want.items():
    if key.endswith(".steps"):
      assert int(got[key]) == int(value) == 1, key
    else:
      tt.assert_allclose(got[key].numpy(), value.numpy(), rtol=1e-4,
                         atol=1e-4 * float(value.abs().max()), err_msg=key)

  # Gradients, in the port's layouts through the same bridge.
  ref = state_dict_from_jax({"params": ref_grads})
  grads = {n: p.grad.numpy().astype(np.float64)
           for n, p in model.named_parameters()}
  assert sorted(ref) == sorted(grads)
  allr = np.concatenate([ref[k].numpy().ravel() for k in grads]).astype(
      np.float64)
  allg = np.concatenate([grads[k].ravel() for k in grads])
  nr = np.linalg.norm(allr)
  global_cos = float(allr @ allg / (nr * np.linalg.norm(allg)))
  assert global_cos >= 0.96, global_cos
  near_loss = ("decoder.stage_5", "decoder.stage_6", "decoder.rt_skip_5")
  checked = near = 0
  for key, g in grads.items():
    r = ref[key].numpy().astype(np.float64)
    rn = np.linalg.norm(r)
    if _feeds_batch_renorm(key) or rn < 1e-4 * nr / np.sqrt(len(grads)):
      continue  # ~zero true gradient: both sides hold rounding dust
    cos = float(r.ravel() @ g.ravel() / (rn * np.linalg.norm(g)))
    assert cos >= 0.90, (key, cos)
    checked += 1
    if key.startswith(near_loss):
      rel = np.linalg.norm(g - r) / rn
      assert rel <= 0.05, (key, rel)
      near += 1
  assert checked > 150 and near >= 10, (checked, near)


def _feeds_batch_renorm(name):
  """Conv biases whose output a BatchRenorm normalizes: its mean
  subtraction cancels them, so their true gradient is 0."""
  return name.endswith(".bias") and (
      (name.startswith("encoder.") and "conv" in name.split(".")[-2])
      or re.fullmatch(r"decoder\.stage_\d_c\.bias", name) is not None)


def test_train_step_needs_the_grid():
  model = CoreNet(CoreNetConfig(DecoderConfig(RES, 2)))
  model.reset_parameters(torch.Generator().manual_seed(0))
  state = create_train_state(model, device="cpu")
  step = make_train_step(state.model, state.optimizer, "FG_BG", RES)
  batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
  with pytest.raises(ValueError, match="does not match"):
    step(state, dict(batch, grid=batch["grid"][:, :16]))
  del batch["grid"]
  with pytest.raises(NotImplementedError, match="on-device GT"):
    step(state, batch)
  assert state.global_step == 0


def test_loss_per_task_and_state_device(monkeypatch):
  from corenet_tpu_torch.models import losses
  assert loss_fn_for_task("FG_BG") is losses.iou_fgbg
  assert loss_fn_for_task("SEMANTIC") is losses.xent_times_iou_agnostic
  with pytest.raises(ValueError):
    loss_fn_for_task("DEPTH")
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  model = CoreNet(CoreNetConfig(DecoderConfig(RES, 2)))
  with pytest.raises(RuntimeError, match="no CUDA device"):
    create_train_state(model)
