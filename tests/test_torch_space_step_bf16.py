"""The PyTorch port's training step on 2 space ranks (gloo, CPU) in bf16,
against the JAX package's one-device steps and the port's one-process
step (tests/test_torch_space_step.py has the float32 cases and the
helpers).

The fine decoder in bf16 at 32³ with the phase loss on triangles
voxelized in the step (sharded from tower 4), on
tests/test_torch_bf16_step.py's three batches, held by its 2·d rule: with
d the distance of JAX bf16 from JAX f32, the ranks' result lies within
2·d of both, for the losses of the three batches together, the first
batch's new statistics, and the gradients. Train-mode bf16 at batch 2 is
chaotic (d ≈ 1 for most gradients: stage 1's BatchRenorm normalizes two
samples per channel), and the two ranks take the statistics and the IoU
sums in another order than one process, so the ranks' gradients are
another draw of that chaos, 20 % (median) from the one-process step's.
Each gradient is therefore held with d and the distances taken over the
three batches together, as the loss is. (One batch alone is a single
draw: on the first, two of the encoder's gradients lie outside 2·d of JAX
bf16, encoder.stage1_bn.bias at 3.25 against 2 · 1.33 and
encoder.stage2b.bn_a.scale at 2.17 against 2 · 1.08, where the
one-process step lies inside; over the three batches every gradient of
both lies inside.) The forward quantities, the losses and the new
statistics, lie within 1e-5 of the one-process step's.
"""

import numpy as np
import numpy.testing as tt
import pytest
import torch

from test_torch_space_step import (
    assert_ranks_agree, run_cases, run_one_process)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def inputs():
  from corenet_tpu_torch.models.convert import state_dict_from_jax
  from test_torch_bf16_step import _batches
  from test_torch_model import _variables
  from test_torch_train_step import RES, VOX_KWARGS
  variables = _variables(32)
  cases = {
      "bf16": {"res": RES, "channels": 2,
               "model": {"phase_output": True,
                         "compute_dtype": torch.bfloat16},
               "task": "FG_BG", "vox_kwargs": VOX_KWARGS,
               "batches": _batches(),
               "state_dict": dict(state_dict_from_jax(variables))},
  }
  return variables, cases


@pytest.fixture(scope="module")
def space2(tmp_path_factory, inputs):
  return run_cases(tmp_path_factory, "space2", inputs[1], world=2, space=2)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory, inputs):
  return run_one_process(tmp_path_factory, "one_process", inputs[1])


def _jax_steps(variables, batches, dtype):
  """JAX's step with a model of `dtype` on each batch from the same
  state: (losses, each batch's gradients, the first batch's new
  statistics), in the port's layouts."""
  import jax
  import jax.numpy as jnp
  from corenet_tpu.models.corenet import CoreNet as JaxCoreNet
  from corenet_tpu.models.corenet import CoreNetConfig as JaxCoreNetConfig
  from corenet_tpu.models.corenet import DecoderConfig as JaxDecoderConfig
  from corenet_tpu.train.state import create_train_state as jax_train_state
  from corenet_tpu.train.step import make_train_step as jax_make_train_step
  from corenet_tpu_torch.models.convert import state_dict_from_jax
  from test_torch_train_step import RES, VOX_KWARGS, _grad_keeper
  model = JaxCoreNet(JaxCoreNetConfig(decoder=JaxDecoderConfig(
      resolution=RES, num_output_channels=2)), compute_dtype=dtype,
                     phase_output=True)
  optimizer = _grad_keeper()
  state = jax_train_state(jax.tree_util.tree_map(jnp.asarray, variables),
                          optimizer)
  step = jax_make_train_step(model, optimizer, "FG_BG", RES,
                             voxelization_kwargs=VOX_KWARGS, donate=False)
  losses, grads, stats = [], [], None
  for batch in batches:
    new, metrics = step(state, jax.tree_util.tree_map(jnp.asarray, batch))
    losses.append(float(metrics["loss"]))
    grads.append({k: v.numpy() for k, v in state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray,
                                          new.opt_state["grads"])}).items()})
    if stats is None:
      stats = {k: v.numpy() for k, v in state_dict_from_jax(
          {"params": {}, "batch_stats": jax.tree_util.tree_map(
              np.asarray, new.batch_stats)}).items()}
  return losses, grads, stats


def _cat(trees, names):
  return np.concatenate([np.asarray(tree[k], np.float32).ravel()
                         for tree in trees for k in names])


def test_bf16_space_step_within_the_bf16_rule(inputs, space2, one_process):
  import jax.numpy as jnp
  from test_torch_bf16 import assert_within_bf16_distance
  from test_torch_train_step import _feeds_batch_renorm
  variables, cases = inputs
  got = [r["bf16"] for r in space2]
  assert_ranks_agree(got, 2)
  assert got[0]["shard_stage"] == 4
  ranks = got[0]
  batches = cases["bf16"]["batches"]
  f32 = _jax_steps(variables, batches, None)
  bf16 = _jax_steps(variables, batches, jnp.bfloat16)
  assert_within_bf16_distance("loss over 3 batches", ranks["losses"],
                              bf16[0], f32[0])
  keys = sorted(k for k in bf16[2] if not k.endswith(".steps"))
  assert_within_bf16_distance(
      "running statistics", _cat([ranks["buffers"]], keys),
      _cat([bf16[2]], keys), _cat([f32[2]], keys))
  names = sorted(n for n in bf16[1][0] if not _feeds_batch_renorm(n))
  assert_within_bf16_distance(
      "all gradients over 3 batches", _cat(ranks["batch_grads"], names),
      _cat(bf16[1], names), _cat(f32[1], names))
  for name in names:
    assert_within_bf16_distance(
        f"gradient {name} over 3 batches",
        _cat(ranks["batch_grads"], [name]), _cat(bf16[1], [name]),
        _cat(f32[1], [name]))

  # The forward against the port's one-process bf16 step.
  want = one_process[0]["bf16"]
  tt.assert_allclose(ranks["losses"], want["losses"], rtol=1e-5)
  for key in keys:
    value = want["buffers"][key]
    tt.assert_allclose(ranks["buffers"][key], value, rtol=1e-5,
                       atol=1e-5 * np.abs(value).max(), err_msg=key)
