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
  with pytest.raises(NotImplementedError):
    BatchRenorm(3).train()(torch.zeros(2, 3))


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
