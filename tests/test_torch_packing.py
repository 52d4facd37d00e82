"""The PyTorch port's packed (space-to-depth) layers
(corenet_tpu_torch/models/{packing,layers,batch_renorm,skip}.py) against
the JAX package's, on the CPU.

The port's activations are (N, C, D, H, W), the JAX package's channel
last; packed channels are phase-major in both, so a port tensor compared
here is the JAX one with its channel axis moved. Weights come from numpy
seeds (or flax's init) and go through the port's weight layouts: a
convolution's (out, in, k...), a transposed convolution's (in, out, k...).
The packed convolutions sum in another order than JAX's expansion through
a one-hot matmul, so they agree within tests/test_packing.py's rtol 2e-4,
atol 2e-5; BatchRenorm in float32 within 1e-5, and in bf16 within twice
JAX's own bf16 distance from its float32 result (the rule of
tests/test_torch_bf16.py). The packed skip's voxels read the pixels JAX's
packed centers read, and the plain backward in the port's packed voxel
order equals `jax.vjp` of the Pallas kernel within 1e-5 · Σ|dout|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as tt
import pytest
import torch

from corenet_tpu.models import layers as jax_layers
from corenet_tpu.models import packing as jax_packing
from corenet_tpu.models import skip as jax_skip
from corenet_tpu.models.batch_renorm import BatchRenorm as JaxBatchRenorm
from corenet_tpu.ops.skip_gather import skip_gather as jax_skip_gather
from corenet_tpu_torch.models import layers, packing, skip
from corenet_tpu_torch.models.batch_renorm import BatchRenorm
from corenet_tpu_torch.ops import skip_gather as op

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-5)


def _last(t: torch.Tensor) -> np.ndarray:
  """A port (N, C, spatial...) tensor in the JAX package's channel-last
  layout."""
  return t.detach().float().movedim(1, -1).numpy()


def _first(a) -> torch.Tensor:
  """A channel-last array in the port's (N, C, spatial...) layout."""
  return torch.from_numpy(np.asarray(a, np.float32)).movedim(-1, 1)


def _conv_weight(kernel) -> torch.Tensor:
  """JAX conv kernel (k, k, k, in, out) → the port's (out, in, k, k, k)."""
  return torch.from_numpy(np.ascontiguousarray(
      np.asarray(kernel).transpose(4, 3, 0, 1, 2)))


def _conv_t_weight(kernel) -> torch.Tensor:
  """JAX transposed-conv kernel (k, k, k, in, out) → (in, out, k, k, k)."""
  return torch.from_numpy(np.ascontiguousarray(
      np.asarray(kernel).transpose(3, 4, 0, 1, 2)))


def test_space_to_depth_and_back_bit_equal_jax():
  rng = np.random.default_rng(0)
  x = rng.standard_normal((2, 4, 6, 8, 3)).astype(np.float32)
  want = np.asarray(jax_packing.space_to_depth(jnp.asarray(x)))
  got = packing.space_to_depth(_first(x))
  assert got.shape == (2, 24, 2, 3, 4)
  assert np.array_equal(_last(got), want)
  back = packing.depth_to_space(got, 3)
  assert np.array_equal(
      _last(back), np.asarray(jax_packing.depth_to_space(jnp.asarray(want),
                                                         3)))
  assert torch.equal(back, _first(x))


@pytest.mark.parametrize("k", [3, 5])
def test_packed_conv_matches_jax(k):
  rng = np.random.default_rng(k)
  cin, cout = 5, 4
  x = rng.standard_normal((2, 4, 4, 4, 8 * cin)).astype(np.float32)
  kernel = (rng.random((k, k, k, cin, cout)) - 0.5).astype(np.float32)
  want = jax_packing.packed_conv(jnp.asarray(x), jnp.asarray(kernel), k // 2)
  got = packing.packed_conv(_first(x), _conv_weight(kernel), k // 2)
  tt.assert_allclose(_last(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("phase_output", [False, True])
@pytest.mark.parametrize("k,p", [(3, 1), (7, 3)])
def test_packed_conv_transpose_matches_jax(k, p, phase_output):
  rng = np.random.default_rng(k + 10)
  cin, cout = 3, 2
  x = rng.standard_normal((2, 3, 4, 4, 8 * cin)).astype(np.float32)
  kernel = (rng.random((k, k, k, cin, cout)) - 0.5).astype(np.float32)
  want = jax_packing.packed_conv_transpose(
      jnp.asarray(x), jnp.asarray(kernel), 2, p, 1,
      phase_output=phase_output)
  got = packing.packed_conv_transpose(_first(x), _conv_t_weight(kernel), p,
                                      1, phase_output=phase_output)
  assert _last(got).shape == want.shape
  tt.assert_allclose(_last(got), np.asarray(want), **TOL)


# (kernel, stride, padding, output padding, input size): the decoder's
# towers (stride 2, kernel 7 and 3), a stride that does not divide the
# output, and the seed layer's one-cell input.
CONV_T_CASES = [(7, 2, 3, 1, 5), (3, 2, 1, 1, 4), (4, 3, 1, 0, 3),
                (4, 4, 0, 0, 1)]


def _jax_conv_t(k, s, p, op_, shape, seed, **kwargs):
  m = jax_layers.ConvTranspose(3, k, ndim=3, stride=s, padding=p,
                               output_padding=op_, **kwargs)
  x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
  variables = m.init(jax.random.PRNGKey(seed), jnp.asarray(x))
  return m, variables, x


def _port_conv_t(variables, cin, k, s, p, op_, **kwargs):
  m = layers.ConvTranspose(cin, 3, k, ndim=3, stride=s, padding=p,
                           output_padding=op_, **kwargs)
  params = variables["params"]
  m.load_state_dict({"weight": _conv_t_weight(params["kernel"]),
                     "bias": torch.from_numpy(np.asarray(params["bias"]))})
  return m


@pytest.mark.parametrize("case,method", [
    (case, method) for case in CONV_T_CASES
    for method in ("auto", "dilated", "phased", "phased_fused")
    # phased_fused needs the stride to divide the output.
    if method != "phased_fused"
    or ((case[4] - 1) * case[1] - 2 * case[2] + case[0] + case[3]) % case[1]
    == 0])
def test_conv_transpose_methods_match_jax(case, method):
  """The port's one lowering (torch's conv_transpose) against each of the
  JAX layer's lowerings of the same function."""
  k, s, p, op_, size = case
  shape = (2, size, size, size, 4)
  jm, variables, x = _jax_conv_t(k, s, p, op_, shape, sum(case),
                                 method=method)
  want = np.asarray(jm.apply(variables, jnp.asarray(x)))
  got = _port_conv_t(variables, 4, k, s, p, op_)(_first(x))
  tt.assert_allclose(_last(got), want, **TOL)


@pytest.mark.parametrize("size", [4, 5])
def test_conv_transpose_phase_output_matches_jax(size):
  """The JAX layer's phase_output takes its phased_fused lowering; the
  port's takes torch's conv_transpose and reorders the phases."""
  jm, variables, x = _jax_conv_t(7, 2, 3, 1, (2,) + (size,) * 3 + (4,), 3,
                                 phase_output=True)
  want = np.asarray(jm.apply(variables, jnp.asarray(x)))
  got = _port_conv_t(variables, 4, 7, 2, 3, 1, phase_output=True)(_first(x))
  assert got.shape == want.shape == (2,) + (size,) * 3 + (24,)
  tt.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("phase_output", [False, True])
def test_packed_conv_transpose_layer_matches_jax(phase_output):
  jm, variables, x = _jax_conv_t(7, 2, 3, 1, (2, 3, 3, 3, 32), 5,
                                 packed_io=True, phase_output=phase_output)
  want = np.asarray(jm.apply(variables, jnp.asarray(x)))
  got = _port_conv_t(variables, 4, 7, 2, 3, 1, packed_io=True,
                     phase_output=phase_output)(_first(x))
  got = got.detach().numpy() if phase_output else _last(got)
  assert got.shape == want.shape
  tt.assert_allclose(got, want, **TOL)


def test_packed_conv_layer_matches_jax():
  m = jax_layers.Conv(4, 5, ndim=3, padding=2, packed_io=True)
  x = np.random.default_rng(6).standard_normal((2, 3, 3, 3, 40)).astype(
      np.float32)
  variables = m.init(jax.random.PRNGKey(6), jnp.asarray(x))
  want = np.asarray(m.apply(variables, jnp.asarray(x)))
  port = layers.Conv(5, 4, 5, ndim=3, padding=2, packed_io=True)
  port.load_state_dict({
      "weight": _conv_weight(variables["params"]["kernel"]),
      "bias": torch.from_numpy(np.asarray(variables["params"]["bias"]))})
  tt.assert_allclose(_last(port(_first(x))), want, **TOL)


def _renorm_pair(seed):
  """A JAX BatchRenorm's variables with random running statistics past the
  ramp start, and the port's module with the same state."""
  jm = JaxBatchRenorm(eps=1e-3, phase_packing=8)
  rng = np.random.default_rng(seed)
  variables = {
      "params": {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
                 "bias": rng.normal(0, 0.3, 5).astype(np.float32)},
      "batch_stats": {"mean": rng.normal(0, 0.3, 5).astype(np.float32),
                      "var": rng.uniform(0.5, 2.0, 5).astype(np.float32),
                      "steps": np.int32(6000)}}
  port = BatchRenorm(5, phase_packing=8)
  port.load_state_dict({
      "scale": torch.from_numpy(variables["params"]["scale"]),
      "bias": torch.from_numpy(variables["params"]["bias"]),
      "mean": torch.from_numpy(variables["batch_stats"]["mean"]),
      "var": torch.from_numpy(variables["batch_stats"]["var"]),
      "steps": torch.tensor(6000, dtype=torch.int32)})
  return jm, variables, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_renorm_phase_packing_train_mode_matches_jax(dtype):
  """Train mode on packed activations with a mean far from 0 (where the
  bf16 statistics need their shift)."""
  jm, variables, port = _renorm_pair(3)
  x = (np.random.default_rng(4).standard_normal((2, 3, 3, 3, 40)) * 0.5
       + 2.0).astype(np.float32)
  outs = {}
  for name, jdt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
    y, new = jm.apply(variables, jnp.asarray(x, jdt), True,
                      mutable=["batch_stats"])
    outs[name] = (np.asarray(y.astype(jnp.float32)), new["batch_stats"])
  tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
  got = port.train()(_first(x).to(tdt))
  assert got.dtype == tdt
  want, stats = outs[dtype]
  if dtype == "float32":
    tt.assert_allclose(_last(got), want, rtol=1e-5, atol=1e-5)
  else:
    d = np.abs(outs["bfloat16"][0] - outs["float32"][0]).max()
    assert 0 < d and np.abs(_last(got) - want).max() <= 2 * d
  tt.assert_allclose(port.mean.numpy(), np.asarray(stats["mean"]),
                     rtol=1e-5, atol=1e-6)
  tt.assert_allclose(port.var.numpy(), np.asarray(stats["var"]), rtol=1e-5,
                     atol=1e-6)
  assert int(port.steps) == int(stats["steps"]) == 6001


def test_batch_renorm_phase_packing_eval_mode_matches_jax():
  jm, variables, port = _renorm_pair(5)
  x = np.random.default_rng(6).standard_normal((2, 3, 3, 3, 40)).astype(
      np.float32)
  want = np.asarray(jm.apply(variables, jnp.asarray(x), False))
  tt.assert_allclose(_last(port.eval()(_first(x))), want, rtol=1e-6,
                     atol=1e-6)


def _skip_inputs(res=16, b=2, h=12, w=10):
  """Projections with voxels off-image and behind the camera
  (tests/test_torch_model.py's), in-voxel offsets, and a map whose every
  pixel holds its own number (1 + y·W + x), the pad 0."""
  mats = []
  for i in range(b):
    s = 2.6 / res
    mats.append(np.array([[s, 0, 0.01 * i, -1.2], [0, s, 0.005, -1.1],
                          [0, 0.002, 1.0 / res, -0.15],
                          [0, 0, 0.01, 1.05]], np.float32))
  loc = np.random.default_rng(1).uniform(0.2, 0.8, (b, 3)).astype(np.float32)
  ids = 1 + np.arange(h * w, dtype=np.float32).reshape(1, h, w, 1)
  grid2d = np.broadcast_to(ids, (b, h, w, 1)).copy()
  return np.stack(mats), loc, grid2d, (res,) * 3


def test_packed_skip_reads_the_pixels_of_jax_packed_centers():
  """The port's packed voxel order (phase-outer) reads, voxel for voxel,
  the pixel JAX's packed centers read (phase-inner): 0 differ."""
  mats, loc, grid2d, res = _skip_inputs()
  b = mats.shape[0]
  want = np.asarray(jax_skip.sample_grid2d(
      jnp.asarray(grid2d), jnp.asarray(mats), jnp.asarray(loc), res,
      packed=True, use_pallas=False))  # [B, D/2, H/2, W/2, 8·1]
  got = skip.sample_grid2d(torch.from_numpy(grid2d), torch.from_numpy(mats),
                           torch.from_numpy(loc), res, packed=True)
  assert got.shape == (b, 8, 8, 8, 8, 1)
  got = got[..., 0].permute(0, 2, 3, 4, 1).numpy()
  assert int((got != want).sum()) == 0
  assert 0 < (want == 0).mean() < 0.9  # some voxels read the pad
  # The fine order reads the same pixels.
  fine = skip.sample_grid2d(torch.from_numpy(grid2d), torch.from_numpy(mats),
                            torch.from_numpy(loc), res)[..., 0]
  assert torch.equal(packing.space_to_depth(fine[:, None]),
                     torch.from_numpy(got).permute(0, 4, 1, 2, 3))


def test_packed_order_backward_matches_jax_vjp():
  """The plain backward of the port's packed-order gather against
  jax.vjp of the Pallas kernel (interpret mode) fed the same voxels in
  JAX's order."""
  mats, loc, _, res = _skip_inputs(res=16, h=18, w=18)
  b, c = mats.shape[0], 6
  px, py = skip.voxel_pixel_indices(torch.from_numpy(mats),
                                    torch.from_numpy(loc), res, 18, 18,
                                    packed=True)
  m = px.shape[1] // 8
  rng = np.random.default_rng(2)
  fmap = rng.standard_normal((b, 20, 20, c)).astype(np.float32)
  dout = rng.standard_normal((b, 8, m, c)).astype(np.float32)
  # JAX's packed order: phase innermost.
  jax_order = lambda a: np.ascontiguousarray(
      np.swapaxes(a.reshape((b, 8, m) + a.shape[2:]), 1, 2)).reshape(
          (b, 8 * m) + a.shape[2:])
  _, vjp = jax.vjp(lambda f: jax_skip_gather(
      f, jnp.asarray(jax_order(px.numpy())), jnp.asarray(jax_order(
          py.numpy())), interpret=True), jnp.asarray(fmap))
  (want,) = vjp(jnp.asarray(jax_order(dout.reshape(b, 8 * m, c))))
  fmap_t = torch.from_numpy(fmap).requires_grad_(True)
  out = op.skip_gather(fmap_t, px, py, tuple(v // 2 for v in res), phases=8)
  assert out.shape == (b, 8, m, c)
  out.backward(torch.from_numpy(dout))
  mass = op.skip_gather_backward_reference(
      torch.from_numpy(np.abs(dout)).double(), px, py, 20, 20).numpy()
  err = np.abs(fmap_t.grad.numpy().astype(np.float64) - np.asarray(want))
  assert (err <= 1e-5 * mass + 1e-30).all(), float((err - 1e-5 * mass).max())
  assert np.abs(np.asarray(want)).max() > 1.0
