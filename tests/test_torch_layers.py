"""The PyTorch port's layers (corenet_tpu_torch/models/{layers,
batch_renorm}.py) against the JAX package's, on the CPU.

Each JAX layer is initialized by flax, its parameters go through the
port's weight bridge (models/convert.py), and both layers see the same
numpy inputs. The port works in (N, C, spatial...) inside, so inputs and
outputs are permuted at the comparison. Tolerance: atol 1e-5·max|ref| (the
two frameworks sum the products in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as tt
import pytest
import torch
from torch import nn

from corenet_tpu.models import layers as jax_layers
from corenet_tpu.models.batch_renorm import BatchRenorm as JaxBatchRenorm
from corenet_tpu_torch.models import layers
from corenet_tpu_torch.models.batch_renorm import BatchRenorm
from corenet_tpu_torch.models.convert import state_dict_from_jax

torch.set_num_threads(2)


def _to_torch_layout(x):
  return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _from_torch_layout(y):
  return np.moveaxis(y.detach().numpy(), 1, -1)


def _close(got, ref):
  ref = np.asarray(ref)
  assert got.shape == ref.shape
  tt.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def _bridged(name, module, variables):
  """`module` registered under scope `name`, holding the JAX variables."""
  holder = nn.ModuleDict({name: module})
  tree = {"params": {name: variables["params"]}}
  if "batch_stats" in variables:
    tree["batch_stats"] = {name: variables["batch_stats"]}
  tree = jax.tree_util.tree_map(np.asarray, tree)
  holder.load_state_dict(state_dict_from_jax(tree))
  return module.eval()


@pytest.mark.parametrize("ndim,k,s,p", [
    (2, 7, 2, 3), (2, 1, 2, 0), (2, 3, 1, 1), (2, 1, 1, 0),  # the encoder
    (3, 3, 1, 1), (3, 5, 1, 2),                              # the decoder
])
def test_conv_matches_jax(ndim, k, s, p):
  rng = np.random.default_rng(k * 10 + s)
  x = rng.standard_normal((2,) + (9,) * ndim + (5,)).astype(np.float32)
  jl = jax_layers.Conv(features=6, kernel_size=k, ndim=ndim, stride=s,
                       padding=p)
  variables = jl.init(jax.random.PRNGKey(k), jnp.asarray(x))
  ref = jl.apply(variables, jnp.asarray(x))
  tl = _bridged("conv", layers.Conv(5, 6, k, ndim, stride=s, padding=p),
                variables)
  _close(_from_torch_layout(tl(_to_torch_layout(x))), ref)


@pytest.mark.parametrize("k,s,p,op,in_size", [
    (3, 2, 1, 1, 3),   # stage_2_t
    (7, 2, 3, 1, 3),   # stage_3_t .. stage_6_t
    (1, 1, 0, 0, 1),   # stage_1_t at ir = 1 (32³ output)
    (2, 2, 0, 0, 1),   # stage_1_t at ir = 2 (64³)
    (4, 4, 0, 0, 1),   # stage_1_t at ir = 4 (128³)
])
def test_conv_transpose_matches_jax(k, s, p, op, in_size):
  rng = np.random.default_rng(k * 10 + s)
  x = rng.standard_normal((2,) + (in_size,) * 3 + (6,)).astype(np.float32)
  jl = jax_layers.ConvTranspose(features=4, kernel_size=k, ndim=3, stride=s,
                                padding=p, output_padding=op)
  variables = jl.init(jax.random.PRNGKey(k), jnp.asarray(x))
  ref = jl.apply(variables, jnp.asarray(x))
  tl = _bridged("stage_t", layers.ConvTranspose(
      6, 4, k, 3, stride=s, padding=p, output_padding=op), variables)
  _close(_from_torch_layout(tl(_to_torch_layout(x))), ref)


def test_linear_matches_jax():
  x = np.random.default_rng(0).standard_normal((3, 16)).astype(np.float32)
  jl = jax_layers.Linear(features=8)
  variables = jl.init(jax.random.PRNGKey(0), jnp.asarray(x))
  ref = jl.apply(variables, jnp.asarray(x))
  tl = _bridged("stage_0", layers.Linear(16, 8), variables)
  _close(tl(torch.from_numpy(x)).detach().numpy(), ref)


def test_max_pool_pads_with_negative_infinity():
  # All-negative input: a zero pad would win the max at the border.
  x = -np.abs(np.random.default_rng(1).standard_normal(
      (2, 9, 9, 3))).astype(np.float32) - 1.0
  ref = jax_layers.max_pool_2d(jnp.asarray(x), kernel=3, stride=2, padding=1)
  got = _from_torch_layout(layers.max_pool_2d(_to_torch_layout(x), 3, 2, 1))
  assert np.array_equal(got, np.asarray(ref))
  assert got.max() < 0


@pytest.mark.parametrize("spatial", [(), (5, 5), (3, 4, 5)])
def test_batch_renorm_eval_matches_jax(spatial):
  rng = np.random.default_rng(len(spatial))
  c = 7
  x = rng.standard_normal((2,) + spatial + (c,)).astype(np.float32) * 3
  jl = JaxBatchRenorm(eps=1e-3)
  variables = {
      "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                 "bias": rng.normal(0, 0.3, c).astype(np.float32)},
      "batch_stats": {"mean": rng.normal(0, 0.3, c).astype(np.float32),
                      "var": rng.uniform(0.5, 2.0, c).astype(np.float32),
                      "steps": np.int32(7)}}
  ref = jl.apply(variables, jnp.asarray(x), False)
  tl = _bridged("bn", BatchRenorm(c, eps=1e-3), variables)
  assert int(tl.steps) == 7
  _close(_from_torch_layout(tl(_to_torch_layout(x))), ref)


def test_batch_renorm_refuses_train_mode():
  # Train mode is ported for float32; bf16 (the JAX package's shifted
  # one-pass variance) comes with the bf16 port.
  with pytest.raises(NotImplementedError):
    BatchRenorm(3).train()(torch.zeros(2, 3, dtype=torch.bfloat16))


@pytest.mark.parametrize("steps", [0, 6000, 45000])
@pytest.mark.parametrize("spatial", [(), (3, 4, 5)])
def test_batch_renorm_train_matches_jax(spatial, steps):
  """Train mode against flax's `apply(..., train=True, mutable=...)`:
  output, gradients of x, scale and bias, and the new running statistics,
  within 1e-5 relative. Past the ramp start (5000) the r and d clips
  engage: the batch's spread and mean sit far from the running ones."""
  rng = np.random.default_rng(steps + len(spatial))
  c = 7
  # At 45000 the clips are widest (r_max 3, d_max 5): a wider, shifted
  # batch still reaches them.
  loc, spread = (8.0, 5.0) if steps == 45000 else (1.0, 2.0)
  x = rng.normal(loc, spread, (4,) + spatial + (c,)).astype(np.float32)
  dout = rng.standard_normal(x.shape).astype(np.float32)
  variables = {
      "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                 "bias": rng.normal(0, 0.3, c).astype(np.float32)},
      "batch_stats": {"mean": rng.normal(0, 0.3, c).astype(np.float32),
                      "var": rng.uniform(0.5, 2.0, c).astype(np.float32),
                      "steps": np.int32(steps)}}
  jl = JaxBatchRenorm(eps=1e-3)

  def objective(params, xx):
    y, updates = jl.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          xx, True, mutable=["batch_stats"])
    return (y * dout).sum(), (y, updates["batch_stats"])

  (_, (ref, ref_stats)), (ref_gp, ref_gx) = jax.value_and_grad(
      objective, argnums=(0, 1), has_aux=True)(variables["params"],
                                               jnp.asarray(x))

  tl = _bridged("bn", BatchRenorm(c, eps=1e-3), variables).train()
  xt = _to_torch_layout(x).requires_grad_(True)
  y = tl(xt)
  y.backward(_to_torch_layout(dout))

  def close(got, want):
    want = np.asarray(want)
    tt.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())

  close(_from_torch_layout(y), ref)
  close(_from_torch_layout(xt.grad), ref_gx)
  close(tl.scale.grad.numpy(), ref_gp["scale"])
  close(tl.bias.grad.numpy(), ref_gp["bias"])
  close(tl.mean.numpy(), ref_stats["mean"])
  close(tl.var.numpy(), ref_stats["var"])
  assert int(tl.steps) == int(ref_stats["steps"]) == steps + 1
  if steps > 5000:  # the r and d clips engage in some channel
    stats = variables["batch_stats"]
    running_std = np.sqrt(stats["var"] + 1e-3)
    r = np.sqrt(x.reshape(-1, c).var(axis=0) + 1e-3) / running_std
    d = (x.reshape(-1, c).mean(axis=0) - stats["mean"]) / running_std
    r_max = 1 + min(2 * (steps - 5000) / 35000, 2)
    d_max = min(5 * (steps - 5000) / 20000, 5)
    assert (r > r_max).any() and (np.abs(d) > d_max).any()


def test_ramp_start_is_shared_and_settable():
  from corenet_tpu_torch.models import batch_renorm
  assert batch_renorm.ramp_start() == 5000
  x = torch.from_numpy(np.random.default_rng(0).normal(
      1.0, 2.0, (4, 3, 5)).astype(np.float32))
  layer = BatchRenorm(3).train()
  layer.steps.fill_(100)
  plain = layer(x)  # before the ramp start: r = 1, d = 0
  batch_renorm.set_ramp_start(0)
  try:
    layer.steps.fill_(100)
    ramped = layer(x)
  finally:
    batch_renorm.set_ramp_start(5000)
  assert batch_renorm.ramp_start() == 5000
  assert not torch.allclose(plain, ramped)


@pytest.mark.parametrize("make,fan_in,kaiming", [
    (lambda: layers.Conv(16, 32, 3, 2, kernel_init_mode="kaiming_normal"),
     16 * 9, True),
    (lambda: layers.Conv(16, 32, 3, 3), 16 * 27, False),
    # A transposed conv counts fan_in over its output channels.
    (lambda: layers.ConvTranspose(16, 32, 3, 3), 32 * 27, False),
    (lambda: layers.Linear(300, 40), 300, False),
])
def test_seeded_init_matches_jax_initializers(make, fan_in, kaiming):
  a, b = make(), make()
  a.reset_parameters(torch.Generator().manual_seed(3))
  b.reset_parameters(torch.Generator().manual_seed(3))
  assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
  w = a.weight.detach()
  bound = 1 / np.sqrt(fan_in)
  assert float(a.bias.detach().abs().max()) <= bound
  if kaiming:  # truncated at two standard deviations of the draw
    std = np.sqrt(2 / fan_in)
    assert abs(float(w.std()) / std - 1) < 0.05
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978
  else:
    assert float(w.abs().max()) <= bound
    assert abs(float(w.std()) / (bound / np.sqrt(3)) - 1) < 0.05
