"""The PyTorch port's training step in bf16 against the JAX package's, on
the CPU: h7's kind of step at 32³, batch 2 (the JAX pipeline's default:
triangles voxelized in the step by the blocked rasterizer, the phase
loss on phase-major logits), with a bf16 model on each side.

The rule of tests/test_torch_bf16.py: with d = ‖JAX bf16 − JAX f32‖ /
‖JAX f32‖ for each quantity, the port's bf16 result lies within 2·d of
both. The loss is one number per batch, so its d and the port's distances
are taken over three batches (other images and grid offsets) together;
the new running statistics and the gradients are those of the first.
Train-mode bf16 at batch 2 is chaotic in the early layers (stage 1's
BatchRenorm normalizes two samples per channel), so the gradients' d is
large; the per-parameter check still holds every gradient to its own d.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from corenet_tpu.models.corenet import CoreNet as JaxCoreNet
from corenet_tpu.models.corenet import CoreNetConfig as JaxCoreNetConfig
from corenet_tpu.models.corenet import DecoderConfig as JaxDecoderConfig
from corenet_tpu.train.state import create_train_state as jax_train_state
from corenet_tpu.train.step import make_train_step as jax_make_train_step
from corenet_tpu_torch.models.convert import state_dict_from_jax
from corenet_tpu_torch.models.corenet import (
    CoreNet, CoreNetConfig, DecoderConfig)
from corenet_tpu_torch.train.state import create_train_state
from corenet_tpu_torch.train.step import make_train_step
from test_torch_bf16 import assert_within_bf16_distance
from test_torch_model import _variables
from test_torch_train_step import (
    RES, VOX_KWARGS, _feeds_batch_renorm, _grad_keeper, _triangle_batch)

torch.set_num_threads(2)

BATCHES = 3


def _batches():
  """The triangle batch of tests/test_torch_train_step.py, then the same
  meshes under other images and grid offsets."""
  first = _triangle_batch()
  out = [first]
  rng = np.random.default_rng(9)
  for _ in range(BATCHES - 1):
    out.append(dict(first, image=rng.integers(
        0, 256, first["image"].shape).astype(np.uint8),
        grid_offset=rng.uniform(0.25, 0.75, (2, 3)).astype(np.float32)))
  return out


def _jax_steps(variables, batches, dtype):
  """(losses, gradients and new statistics of the first batch) of JAX's
  step with a model of `dtype`, every batch from the same state."""
  model = JaxCoreNet(JaxCoreNetConfig(decoder=JaxDecoderConfig(
      resolution=RES, num_output_channels=2)), compute_dtype=dtype,
                     phase_output=True)
  optimizer = _grad_keeper()
  state = jax_train_state(jax.tree_util.tree_map(jnp.asarray, variables),
                          optimizer)
  step = jax_make_train_step(model, optimizer, "FG_BG", RES,
                             voxelization_kwargs=VOX_KWARGS, donate=False)
  losses, first = [], None
  for batch in batches:
    new, metrics = step(state, jax.tree_util.tree_map(jnp.asarray, batch))
    losses.append(float(metrics["loss"]))
    if first is None:
      first = (state_dict_from_jax({"params": jax.tree_util.tree_map(
          np.asarray, new.opt_state["grads"])}),
               state_dict_from_jax({"params": {}, "batch_stats":
                                    jax.tree_util.tree_map(
                                        np.asarray, new.batch_stats)}))
  return losses, first


def test_bf16_phase_loss_step_on_device_gt_matches_jax():
  variables = _variables(RES[0])
  batches = _batches()
  ref = {"f32": _jax_steps(variables, batches, None),
         "bf16": _jax_steps(variables, batches, jnp.bfloat16)}

  losses = []
  for i, batch in enumerate(batches):
    model = CoreNet(CoreNetConfig(DecoderConfig(RES, 2)), phase_output=True,
                    compute_dtype=torch.bfloat16)
    model.load_state_dict(state_dict_from_jax(variables))
    state = create_train_state(model, device="cpu")
    step = make_train_step(state.model, state.optimizer, "FG_BG", RES,
                           voxelization_kwargs=VOX_KWARGS)
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    losses.append(float(metrics["loss"]))
    if i == 0:
      grads = {n: p.grad for n, p in model.named_parameters()}
      stats = model.state_dict()
  assert state.global_step == 2
  assert_within_bf16_distance("loss over 3 batches", losses,
                              ref["bf16"][0], ref["f32"][0])

  (grads_b, stats_b), (grads_f, stats_f) = ref["bf16"][1], ref["f32"][1]
  # Running statistics, float32: every mean and variance together.
  keys = sorted(k for k in stats_b if not k.endswith(".steps"))
  assert all(int(stats[k]) == 1 for k in stats_b if k.endswith(".steps"))

  def cat(tree, names):
    return np.concatenate([np.asarray(tree[k], np.float32).ravel()
                           for k in names])

  assert all(stats[k].dtype == torch.float32 for k in keys)
  assert_within_bf16_distance("running statistics", cat(stats, keys),
                              cat(stats_b, keys), cat(stats_f, keys))

  # Gradients: float32, all together and each parameter's own.
  names = sorted(n for n in grads if not _feeds_batch_renorm(n))
  assert sorted(grads) == sorted(grads_b)
  assert all(g.dtype == torch.float32 for g in grads.values())
  assert_within_bf16_distance("all gradients", cat(grads, names),
                              cat(grads_b, names), cat(grads_f, names))
  for name in names:
    assert_within_bf16_distance(f"gradient {name}", grads[name].numpy(),
                                grads_b[name], grads_f[name])
