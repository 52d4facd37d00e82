"""The PyTorch port's bf16 compute (`compute_dtype=torch.bfloat16`)
against the JAX package's (`compute_dtype=jnp.bfloat16`), on the CPU.

bf16 results cannot be held to equality: the two frameworks' convolutions
sum in their own orders before they round to bf16. Each quantity is held
to the distance that bf16 itself puts between the JAX package's two
modes on the test's own inputs: with d = ‖JAX bf16 − JAX f32‖ / ‖JAX f32‖,
the port's bf16 result must lie within 2·d of JAX bf16 and within 2·d of
JAX f32 (relative L2). d and both distances are printed.

Covered: `Conv`, `ConvTranspose` (phase-major output included) and
`Linear` (outputs and gradients); BatchRenorm in train and eval mode at
steps 0, 6000 and 45000, and the shifted variance's freedom from
cancellation (the case of tests/test_models.py); CoreNet's eval-mode
logits at 32³, fine and phase-major; the general (C > 2) FG/BG loss on
bf16 logits; and the inference factory's twin keeping the model's dtype.
The training step in bf16 is in tests/test_torch_bf16_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corenet_tpu.models import layers as jax_layers
from corenet_tpu.models import losses as jax_losses
from corenet_tpu.models.batch_renorm import BatchRenorm as JaxBatchRenorm
from corenet_tpu.models.corenet import CoreNet as JaxCoreNet
from corenet_tpu.models.corenet import CoreNetConfig as JaxCoreNetConfig
from corenet_tpu.models.corenet import DecoderConfig as JaxDecoderConfig
from corenet_tpu_torch.eval.super_resolution import (
    super_resolution_from_model)
from corenet_tpu_torch.models import layers, losses
from corenet_tpu_torch.models.batch_renorm import BatchRenorm
from corenet_tpu_torch.models.convert import state_dict_from_jax
from corenet_tpu_torch.models.corenet import (
    CoreNet, CoreNetConfig, DecoderConfig)
from test_torch_layers import _bridged, _from_torch_layout, _to_torch_layout
from test_torch_model import BATCH, _scene, _variables

torch.set_num_threads(2)

BF16 = torch.bfloat16


def _rel(a, b) -> float:
  a = np.asarray(a, np.float64).ravel()
  b = np.asarray(b, np.float64).ravel()
  norm = np.linalg.norm(b)
  return float(np.linalg.norm(a - b) / norm) if norm else float(
      np.linalg.norm(a))


def assert_within_bf16_distance(name, port, jax_bf16, jax_f32):
  """The 2·d rule of the module docstring; returns d."""
  port, jax_bf16, jax_f32 = (np.asarray(v, np.float32)
                             for v in (port, jax_bf16, jax_f32))
  assert port.shape == jax_bf16.shape == jax_f32.shape, name
  assert np.isfinite(port).all(), name
  d = _rel(jax_bf16, jax_f32)
  to_bf16 = _rel(port, jax_bf16)
  to_f32 = _rel(port, jax_f32)
  print(f"{name}: d = {d:.3e}; port bf16 to JAX bf16 {to_bf16:.3e}, to "
        f"JAX f32 {to_f32:.3e}")
  assert to_bf16 <= 2 * d, (name, d, to_bf16)
  assert to_f32 <= 2 * d, (name, d, to_f32)
  return d


# name → (JAX module for a compute_dtype, the port's module, the input's
# channel-last shape).
LAYERS = {
    "conv2d 7x7 s2": (
        lambda dt: jax_layers.Conv(features=6, kernel_size=7, ndim=2,
                                   stride=2, padding=3, compute_dtype=dt),
        lambda: layers.Conv(5, 6, 7, 2, stride=2, padding=3,
                            compute_dtype=BF16), (2, 9, 9, 5)),
    "conv3d 5x5x5": (
        lambda dt: jax_layers.Conv(features=6, kernel_size=5, ndim=3,
                                   padding=2, compute_dtype=dt),
        lambda: layers.Conv(5, 6, 5, 3, padding=2, compute_dtype=BF16),
        (2, 7, 7, 7, 5)),
    "conv_transpose3d 7 s2": (
        lambda dt: jax_layers.ConvTranspose(
            features=4, kernel_size=7, ndim=3, stride=2, padding=3,
            output_padding=1, compute_dtype=dt),
        lambda: layers.ConvTranspose(6, 4, 7, 3, stride=2, padding=3,
                                     output_padding=1, compute_dtype=BF16),
        (2, 4, 4, 4, 6)),
    "conv_transpose3d phase-major": (
        lambda dt: jax_layers.ConvTranspose(
            features=2, kernel_size=7, ndim=3, stride=2, padding=3,
            output_padding=1, phase_output=True, compute_dtype=dt),
        lambda: layers.ConvTranspose(6, 2, 7, 3, stride=2, padding=3,
                                     output_padding=1, phase_output=True,
                                     compute_dtype=BF16),
        (2, 4, 4, 4, 6)),
    "conv_transpose3d stage_1_t": (
        lambda dt: jax_layers.ConvTranspose(
            features=8, kernel_size=2, ndim=3, stride=2, compute_dtype=dt),
        lambda: layers.ConvTranspose(6, 8, 2, 3, stride=2,
                                     compute_dtype=BF16), (2, 1, 1, 1, 6)),
    "conv3d packed 5": (
        lambda dt: jax_layers.Conv(features=6, kernel_size=5, ndim=3,
                                   padding=2, packed_io=True,
                                   compute_dtype=dt),
        lambda: layers.Conv(5, 6, 5, 3, padding=2, packed_io=True,
                            compute_dtype=BF16), (2, 3, 3, 3, 40)),
    "conv_transpose3d packed 7 s2": (
        lambda dt: jax_layers.ConvTranspose(
            features=4, kernel_size=7, ndim=3, stride=2, padding=3,
            output_padding=1, packed_io=True, compute_dtype=dt),
        lambda: layers.ConvTranspose(6, 4, 7, 3, stride=2, padding=3,
                                     output_padding=1, packed_io=True,
                                     compute_dtype=BF16), (2, 2, 2, 2, 48)),
    "conv_transpose3d packed phase-major": (
        lambda dt: jax_layers.ConvTranspose(
            features=2, kernel_size=7, ndim=3, stride=2, padding=3,
            output_padding=1, packed_io=True, phase_output=True,
            compute_dtype=dt),
        lambda: layers.ConvTranspose(6, 2, 7, 3, stride=2, padding=3,
                                     output_padding=1, packed_io=True,
                                     phase_output=True, compute_dtype=BF16),
        (2, 2, 2, 2, 48)),
    "linear": (
        lambda dt: jax_layers.Linear(features=8, compute_dtype=dt),
        lambda: layers.Linear(16, 8, compute_dtype=BF16), (3, 16)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layers_in_bf16_match_jax(name):
  """Output, input gradient and parameter gradients of one layer in bf16:
  the parameters stay float32, and so do their gradients."""
  make_jax, make_port, shape = LAYERS[name]
  rng = np.random.default_rng(len(name))
  x = rng.standard_normal(shape).astype(np.float32)
  variables = make_jax(None).init(jax.random.PRNGKey(3), jnp.asarray(x))
  out_shape = make_jax(None).apply(variables, jnp.asarray(x)).shape
  dout = rng.standard_normal(out_shape).astype(np.float32)
  # The weight bridge knows a transposed convolution by its scope's name.
  scope = "m_t" if "transpose" in name else "m"

  ref = {}
  for key, dt in (("f32", None), ("bf16", jnp.bfloat16)):
    module = make_jax(dt)

    def objective(params, xx, module=module):
      y = module.apply({"params": params}, xx)
      return (y.astype(jnp.float32) * dout).sum(), y

    (_, y), (gp, gx) = jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True)(variables["params"],
                                                 jnp.asarray(x))
    assert y.dtype == (jnp.bfloat16 if dt else jnp.float32)
    ref[key] = {"y": y, "x": gx, **state_dict_from_jax(
        {"params": {scope: jax.tree_util.tree_map(np.asarray, gp)}})}

  port = make_port()
  torch.nn.ModuleDict({scope: port}).load_state_dict(state_dict_from_jax(
      jax.tree_util.tree_map(np.asarray, {"params": {scope: variables[
          "params"]}})))
  # The port works channel-first; a linear layer's input and the
  # phase-major output are channel-last in both packages.
  linear = len(shape) == 2
  in_port = torch.from_numpy if linear else _to_torch_layout
  out_last = linear or "phase-major" in name
  xt = in_port(x).requires_grad_(True)
  y = port(xt)
  assert y.dtype == BF16
  assert all(p.dtype == torch.float32 for p in port.parameters())
  y.backward((torch.from_numpy(dout) if out_last
              else _to_torch_layout(dout)).to(BF16))
  got = {"y": (y.detach().float().numpy() if out_last
               else _from_torch_layout(y.float())),
         "x": xt.grad.numpy() if linear else _from_torch_layout(xt.grad),
         **{f"{scope}.{n}": p.grad for n, p in port.named_parameters()}}
  assert sorted(got) == sorted(ref["bf16"])
  for key, value in got.items():
    if isinstance(value, torch.Tensor):
      assert value.dtype == torch.float32, key
      value = value.numpy()
    assert_within_bf16_distance(f"{name} {key}", value, ref["bf16"][key],
                                ref["f32"][key])


def _renorm_case(steps, rng):
  c = 7
  # At 45000 the clips are widest (r_max 3, d_max 5): a wider, shifted
  # batch still reaches them.
  loc, spread = (8.0, 5.0) if steps == 45000 else (1.0, 2.0)
  x = rng.normal(loc, spread, (4, 3, 4, 5, c)).astype(np.float32)
  variables = {
      "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                 "bias": rng.normal(0, 0.3, c).astype(np.float32)},
      "batch_stats": {"mean": rng.normal(0, 0.3, c).astype(np.float32),
                      "var": rng.uniform(0.5, 2.0, c).astype(np.float32),
                      "steps": np.int32(steps)}}
  return x, variables


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("steps", [0, 6000, 45000])
def test_batch_renorm_bf16_matches_jax(steps, train):
  """bf16 activations: output (in bf16), the gradients of the input, the
  scale and the bias, and the new running statistics (float32; the
  shifted one-pass form in train mode). JAX f32 takes the same bf16
  values upcast."""
  rng = np.random.default_rng(steps + train)
  x, variables = _renorm_case(steps, rng)
  xb = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
  dout = rng.standard_normal(x.shape).astype(np.float32)
  jl = JaxBatchRenorm(eps=1e-3)

  def objective(params, xx):
    y, updates = jl.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          xx, train, mutable=["batch_stats"])
    return (y.astype(jnp.float32) * dout).sum(), (y, updates["batch_stats"])

  ref = {}
  for key, xx in (("f32", jnp.asarray(xb)),
                  ("bf16", jnp.asarray(x, jnp.bfloat16))):
    (_, (y, stats)), (gp, gx) = jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True)(variables["params"], xx)
    ref[key] = {"y": y, "x": gx, "scale": gp["scale"], "bias": gp["bias"],
                "mean": stats["mean"], "var": stats["var"]}
  assert ref["bf16"]["y"].dtype == jnp.bfloat16

  tl = _bridged("bn", BatchRenorm(7, eps=1e-3), variables).train(train)
  xt = _to_torch_layout(xb).to(BF16).requires_grad_(True)
  y = tl(xt)
  assert y.dtype == BF16
  y.backward(_to_torch_layout(dout).to(BF16))
  got = {"y": _from_torch_layout(y.float()),
         "x": _from_torch_layout(xt.grad.float()),
         "scale": tl.scale.grad.numpy(), "bias": tl.bias.grad.numpy(),
         "mean": tl.mean.numpy(), "var": tl.var.numpy()}
  for key, value in got.items():
    assert_within_bf16_distance(f"steps {steps} train {train} {key}", value,
                                ref["bf16"][key], ref["f32"][key])
  assert int(tl.steps) == steps + train
  if not train:  # eval mode leaves the statistics alone
    np.testing.assert_array_equal(got["mean"],
                                  variables["batch_stats"]["mean"])


def test_batch_renorm_bf16_variance_has_no_cancellation():
  """tests/test_models.py's case for the port: with a variance far below
  the squared mean (x ≈ 512 ± 0.01 in bf16), E[x²] − E[x]² would lose
  everything to float32 cancellation; the shift by the running mean
  recovers the batch variance within 0.1 %."""
  rng = np.random.default_rng(11)
  ch, base, momentum = 8, 512.0, 0.01
  x32 = base + rng.standard_normal((64, 16, 16, ch)).astype(np.float32) * 0.01
  x = torch.from_numpy(x32).to(BF16)
  x64 = x.double().numpy()
  bn = BatchRenorm(ch, eps=1e-3).train()
  with torch.no_grad():
    bn.mean.fill_(base)
    bn.steps.fill_(10_000)
    bn(x.permute(0, 3, 1, 2))
  new_var = bn.var.double().numpy()
  rv = np.ones(ch, np.float32)  # the running variance before the step
  b_var = ((new_var - (1 - momentum) * rv) / momentum) * (ch - 1) / ch
  exact = x64.reshape(-1, ch).var(axis=0)
  np.testing.assert_allclose(b_var, exact, rtol=1e-3)


def _jax_corenet(phase_output, dtype):
  return JaxCoreNet(JaxCoreNetConfig(decoder=JaxDecoderConfig(
      resolution=(32,) * 3, num_output_channels=2)), compute_dtype=dtype,
      phase_output=phase_output)


@pytest.mark.parametrize("phase_output", [False, True])
def test_corenet_bf16_logits_match_jax(phase_output):
  """Eval-mode logits at 32³: fine ones come back float32, phase-major
  ones stay bf16, in JAX and in the port. (Train-mode logits at batch 2
  are no witness: stage 1's BatchRenorm normalizes two samples per
  channel, and bf16 rounding flips them: there d ≈ 0.8. The training
  step's test holds what the step computes from them.)"""
  variables = _variables(32)
  image, v2s, offsets = _scene(32)
  ref = {}
  for key, dt in (("f32", None), ("bf16", jnp.bfloat16)):
    model = _jax_corenet(phase_output, dt)
    ref[key] = jax.jit(lambda v, m=model: m.apply(
        v, image, v2s, offsets, train=False))(variables)
  assert (ref["bf16"].dtype == jnp.bfloat16) == phase_output
  model = CoreNet(CoreNetConfig(DecoderConfig((32,) * 3, 2)),
                  phase_output=phase_output, compute_dtype=BF16)
  model.load_state_dict(state_dict_from_jax(variables))
  with torch.inference_mode():
    got = model.eval()(*(torch.from_numpy(a) for a in (image, v2s, offsets)))
  assert got.dtype == (BF16 if phase_output else torch.float32)
  d = assert_within_bf16_distance(
      f"logits phase_output={phase_output}", got.float().numpy(),
      ref["bf16"], ref["f32"])
  assert 1e-3 < d < 0.1  # bf16 really ran, and stayed near float32


def test_general_fgbg_loss_on_bf16_logits_matches_jax():
  """losses.py's C > 2 branch (softmax, foreground sum, clamped one-hot)
  on bf16 logits, over 8 random draws: the loss is one number per draw,
  so d and the port's distances are taken over the 8 losses together."""
  rng = np.random.default_rng(4)
  values = {"f32": [], "bf16": [], "port": []}
  for _ in range(8):
    logits = rng.normal(0, 2, (2, 6, 6, 6, 3)).astype(np.float32)
    gt = rng.integers(0, 3, (2, 6, 6, 6)).astype(np.int32)
    lb = jnp.asarray(logits, jnp.bfloat16)
    values["f32"].append(float(jax_losses.iou_fgbg(
        jnp.asarray(gt), lb.astype(jnp.float32))))
    values["bf16"].append(float(jax_losses.iou_fgbg(jnp.asarray(gt), lb)))
    values["port"].append(float(losses.iou_fgbg(
        torch.from_numpy(gt), torch.from_numpy(logits).to(BF16))))
  assert_within_bf16_distance("iou_fgbg C=3", values["port"],
                              values["bf16"], values["f32"])


def test_the_inference_twin_keeps_the_models_dtype():
  """The factory's twin evaluates a bf16 model in bf16 (the JAX package's
  recurrent evals run the training dtype), and leaves the caller's model
  in train mode with its weights and device."""
  model = CoreNet(CoreNetConfig(DecoderConfig((32,) * 3, 2)),
                  compute_dtype=BF16)
  model.load_state_dict(state_dict_from_jax(_variables(32)))
  model.train()
  weights = {k: v.clone() for k, v in model.state_dict().items()}
  image, _, offsets = _scene(32)
  camera = np.broadcast_to(np.array(
      [[2, 0, 0.1, -1], [0, 2, 0, -1], [0, 0, 2, -1], [0, 0, 0.2, 1]],
      np.float32), (BATCH, 4, 4)).copy()
  v2x = np.broadcast_to(np.diag([32.0, 32, 32, 1]).astype(np.float32),
                        (BATCH, 4, 4)).copy()
  args = [torch.from_numpy(a) for a in (image, camera, v2x, offsets)]
  pmf = super_resolution_from_model(model, model.state_dict(), (32,) * 3,
                                    packed_execution=False,
                                    device="cpu")(*args, (32,) * 3)
  f32 = CoreNet(model.config)
  f32.load_state_dict(weights)
  pmf32 = super_resolution_from_model(f32, weights, (32,) * 3,
                                      packed_execution=False,
                                      device="cpu")(*args, (32,) * 3)
  twin = CoreNet(model.config, compute_dtype=BF16)
  twin.load_state_dict(weights)
  from corenet_tpu_torch.train.step import make_eval_forward
  want = make_eval_forward(twin.eval())(*args)
  assert torch.equal(pmf, want)
  assert not torch.equal(pmf, pmf32)
  assert float((pmf - pmf32).abs().mean()) < 0.02
  assert model.training and model.compute_dtype == BF16
  for k, v in model.state_dict().items():
    assert torch.equal(v, weights[k]), k
