"""m9's training step in the PyTorch port (multi-object SEMANTIC: labeled
ground truth of three mesh slots voxelized in the step, 14 output
channels, the (1 + IoU)(1 + cross-entropy) loss) against the benchmark's
plain reference (benchmark/reference/semantic.py) and against the JAX
package, on the CPU at 32³, batch 2, on seeded triplet scenes
(benchmark/harness/triplets.py) and the benchmark's seeded weights.

Both sides compute in float32. The labeled grid is held bit for bit. The
first step's loss is held to 1e-4 relative (the later ones to 1e-3,
since they follow Adam's updates) and the gradients to the three levels of
tests/test_torch_train_step.py (a 55-layer float32 backward through
train-mode BatchRenorm amplifies two implementations' rounding with the
distance from the loss: the layers next to the loss within 5 % relative
L2, every gradient that carries mass at cosine ≥ 0.90, all of them
together at cosine ≥ 0.96). After three Adam steps each leaf's change is
held by the benchmark's measure (its gap against the larger of its own and
the median leaf's reference norm): the median leaf within 2 %, since
Adam (eps 1e-4) moves an element whose gradient is as small as its
rounding by a full step either way.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as tt
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
  sys.path.insert(0, REPO)

from benchmark.harness import triplets  # noqa: E402
from benchmark.harness import weights as seeded  # noqa: E402
from benchmark.reference import gt as ref_gt  # noqa: E402
from benchmark.reference import model as ref  # noqa: E402
from benchmark.reference import semantic  # noqa: E402
from corenet_tpu.models.corenet import CoreNet as JaxCoreNet  # noqa: E402
from corenet_tpu.models.corenet import (  # noqa: E402
    CoreNetConfig as JaxCoreNetConfig)
from corenet_tpu.models.corenet import (  # noqa: E402
    DecoderConfig as JaxDecoderConfig)
from corenet_tpu.train.state import (  # noqa: E402
    create_train_state as jax_train_state)
from corenet_tpu.train.step import (  # noqa: E402
    make_train_step as jax_make_train_step)
from corenet_tpu_torch.data import batching  # noqa: E402
from corenet_tpu_torch.data.dataset import CoreNetDatasetImpl  # noqa: E402
from corenet_tpu_torch.models import convert  # noqa: E402
from corenet_tpu_torch.models.convert import state_dict_from_jax  # noqa: E402
from corenet_tpu_torch.models.corenet import (  # noqa: E402
    CoreNet, CoreNetConfig, DecoderConfig)
from corenet_tpu_torch.train import gt  # noqa: E402
from corenet_tpu_torch.train.state import create_train_state  # noqa: E402
from corenet_tpu_torch.train.step import make_train_step  # noqa: E402
from corenet_tpu_torch.utils import tracing  # noqa: E402
from test_torch_train_step import (  # noqa: E402
    _feeds_batch_renorm, _grad_keeper)

torch.set_num_threads(2)

RES = (32, 32, 32)
BATCH = 2
SLOTS = 3
CLASSES = 14  # ShapeNet's 13 classes and void
IRM = 8
WINDOW = 24  # data/batching.py's VOXELIZE_WINDOW_PIXELS
LR, EPS = 0.0004, 0.0001
SEED = 2 ** 33 + 21
TRAFFIC = {"meshes": 13, "meshes_per_scene": SLOTS, "triangles": [256, 1024],
           "kinds": ["ellipsoid", "box", "chair", "table"],
           "scenes": BATCH, "views": 2, "scale": [0.25, 0.40],
           "image_hw": 64}
# m9's voxelization settings (configs/models/m9.json5), at 32³.
VOX = dict(resolution=RES, sub_grid_sampling=False,
           image_resolution_multiplier=IRM, conservative_rasterization=False,
           projection_depth_multiplier=1, max_bbox_pixels=WINDOW,
           fill_rounds=None, num_label_values=CLASSES)
SCENE_KEYS = ("triangles", "tri_mesh_slot", "tri_valid", "mesh_labels",
              "grid_offset")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
  """The triplet scenes: the port's batch (numpy) and the reference's
  (images, cameras, each scene's (class id, view-space triangles)) and
  class values."""
  root = str(tmp_path_factory.mktemp("triplets"))
  manifest = triplets.write_dataset(root, TRAFFIC, SEED)
  data = CoreNetDatasetImpl(manifest, os.path.join(root, "meshes"))
  hb = batching.batch([data[i] for i in range(BATCH)],
                      max_edge_view=ref_gt.max_edge_view(IRM, RES[0]))
  items = [ref_gt.read_scene(os.path.join(root, f), os.path.join(
      root, "meshes")) for f in data.files]
  with open(manifest) as f:
    classes = json.load(f)["classes"]
  values = semantic.class_values([(c["id"], c["human_readable"])
                                  for c in classes])
  return hb.step_inputs("SEMANTIC"), items, values


def _weights():
  return seeded.make(seeded.shapes(RES, CLASSES, 64, 0.75, 2), SEED, "cpu")


def _model(p0, **kwargs):
  model = CoreNet(CoreNetConfig(DecoderConfig(RES, CLASSES)), **kwargs)
  model.load_state_dict(p0, strict=True)
  return model


def _port_step(model):
  state = create_train_state(model, LR, EPS, device="cpu")
  return state, make_train_step(state.model, state.optimizer, "SEMANTIC",
                                RES, voxelization_kwargs=VOX)


def _torch(batch):
  return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _ref_batch(items, values):
  return {"image": torch.from_numpy(np.stack([x[0] for x in items])),
          "camera": torch.from_numpy(np.stack([x[1] for x in items])),
          "labels": semantic.labels([x[2] for x in items], values, RES[0],
                                    IRM, "cpu")}


def test_labeled_grid_equals_the_reference_bit_for_bit(scenes):
  batch, items, values = scenes
  inputs = _torch(batch)
  grid, _ = gt.voxelize_batch(*(inputs[k] for k in SCENE_KEYS), **VOX)
  want = semantic.labels([x[2] for x in items], values, RES[0], IRM, "cpu")
  assert grid.dtype == torch.uint8 and grid.shape == (BATCH,) + RES
  assert torch.equal(grid, want)
  # Three objects of distinct classes a scene, each 0.2-5 % of the grid.
  for b in range(BATCH):
    present = torch.unique(want[b]).tolist()
    assert present[0] == 0 and len(present) == SLOTS + 1, present
    for v in present[1:]:
      assert 0.002 < float((want[b] == v).float().mean()) < 0.05


def test_semantic_step_matches_the_reference(scenes):
  batch, items, values = scenes
  p0 = _weights()
  ref_batch = _ref_batch(items, values)
  # The reference's first-step loss and gradients, by autograd.
  p = {k: v.clone() for k, v in p0.items()}
  leaves = ref.trainable(p)
  for k in leaves:
    p[k].requires_grad_(True)
  v2x = torch.diag(torch.tensor([float(RES[0])] * 3 + [1.0])).expand(
      BATCH, 4, 4)
  logits = ref.forward(p, ref_batch["image"],
                       ref.compute_v2s(ref_batch["camera"], v2x),
                       torch.full((BATCH, 3), 0.5), RES, True,
                       ref.Precision())
  want_loss = semantic.loss(ref_batch["labels"], logits)
  want_grads = dict(zip(leaves, torch.autograd.grad(
      want_loss, [p[k] for k in leaves])))

  model = _model(p0)
  state, step = _port_step(model)
  inputs = _torch(batch)
  losses = []
  for k in range(3):
    state, metrics = step(state, inputs)
    losses.append(float(metrics["loss"]))
    if k == 0:
      grads = {n: q.grad.detach().clone()
               for n, q in model.named_parameters()}
  tt.assert_allclose(losses[0], float(want_loss.detach()), rtol=1e-4)
  _assert_gradients_agree(want_grads, grads)

  # Three Adam steps on the same batch. The later losses follow parameters
  # that Adam moved by a full step wherever a gradient element is as small
  # as its rounding, so they are held to 1e-3.
  want = semantic.steps(p0, [ref_batch] * 3, RES, LR, EPS, ref.Precision())
  tt.assert_allclose(losses[0], want["losses"][0], rtol=1e-4)
  tt.assert_allclose(losses[1:], want["losses"][1:], rtol=1e-3)
  change = {n: float((q.detach() - p0[n]).norm())
            for n, q in model.named_parameters()}
  grad_median = float(np.median(list(want["grad"].values())))
  moved = [n for n in want["change"]
           if want["grad"][n] >= 1e-3 * grad_median]
  floor = float(np.median([want["change"][n] for n in moved]))
  gaps = [abs(change[n] - want["change"][n]) / max(want["change"][n], floor)
          for n in moved]
  assert float(np.median(gaps)) <= 0.02, float(np.median(gaps))


def _assert_gradients_agree(want, got, reach=None):
  allr = torch.cat([want[k].flatten() for k in want]).double()
  allg = torch.cat([got[k].flatten() for k in want]).double()
  assert float(torch.nn.functional.cosine_similarity(allr, allg, 0)) >= 0.96
  nr = float(allr.norm())
  near_loss = ("decoder.stage_5", "decoder.stage_6", "decoder.rt_skip_5")
  checked = near = 0
  for key, r in want.items():
    r, g = r.double().flatten(), got[key].double().flatten()
    rn = float(r.norm())
    if rn < 1e-4 * nr / np.sqrt(len(want)):
      continue  # ~zero true gradient: both sides hold rounding dust
    cos = float(torch.nn.functional.cosine_similarity(r, g, 0))
    assert cos >= 0.90, (key, cos)
    checked += 1
    if key.startswith(near_loss):
      gap = float((g - r).norm())
      assert gap <= max(0.05 * rn, (reach or {}).get(key, 0.0)), (key, gap)
      near += 1
  assert checked > 150 and near >= 10, (checked, near)


def test_semantic_step_records_its_spans_and_counts_mesh_slots(scenes):
  batch, _, _ = scenes
  state, step = _port_step(_model(_weights()))
  slots = tracing.counters()["gt.mesh_slots"]
  tracing.clear()
  with profile(activities=[ProfilerActivity.CPU]):
    step(state, _torch(batch))
  recorded = tracing.spans()
  tracing.clear()
  assert tracing.counters()["gt.mesh_slots"] - slots == BATCH * SLOTS
  by_name = {s.name: s for s in recorded}
  assert by_name["gt.labels"].parent is by_name["train.gt"]
  assert by_name["train.gt"].counts == {"gt.mesh_slots": BATCH * SLOTS}
  for name in ("loss.iou", "loss.xent"):
    assert by_name[name].parent is by_name["train.loss"]


def test_packed_unphased_semantic_step_matches_jax(scenes):
  """m9's step as TrainPipeline runs it: the packed decoder without phase
  output (SEMANTIC trains on fine-order logits), against the JAX step.
  Loss and statistics within 1e-4, the gradients' cosines as above. Next
  to the loss a leaf is within 5 % or within twice the JAX step's own
  reach there: the gap between its gradients from weights one ulp apart
  (7-16 % on decoder stage 5's leaves at these weights, where the JAX
  and the port step part by up to 7.5 % and the port and the plain
  reference by 5e-6)."""
  batch, _, _ = scenes
  p0 = _weights()
  jax_model = JaxCoreNet(JaxCoreNetConfig(decoder=JaxDecoderConfig(
      resolution=RES, num_output_channels=CLASSES)), packed_decoder=True)
  optimizer = _grad_keeper()
  jax_step = jax_make_train_step(jax_model, optimizer, "SEMANTIC", RES,
                                 voxelization_kwargs=VOX, donate=False)
  jax_batch = jax.tree_util.tree_map(jnp.asarray, dict(batch))

  def jax_run(p):
    variables = convert.jax_variables_from_state_dict(_model(p).state_dict())
    state = jax_train_state(jax.tree_util.tree_map(jnp.asarray, variables),
                            optimizer)
    state, metrics = jax_step(state, jax_batch)
    grads = state_dict_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, state.opt_state["grads"])})
    return float(metrics["loss"]), grads, state

  want_loss, want, jax_state = jax_run(p0)
  _, nudged, _ = jax_run({k: torch.nextafter(v, torch.full_like(v, np.inf))
                          if v.is_floating_point() else v
                          for k, v in p0.items()})
  reach = {k: 2 * float((want[k].double() - nudged[k].double()).norm())
           for k in want}

  model = _model(p0, packed_decoder=True)
  assert not model.phase_output
  state, step = _port_step(model)
  state, metrics = step(state, _torch(batch))
  assert int(jax_state.global_step) == state.global_step == BATCH
  tt.assert_allclose(float(metrics["loss"]), want_loss, rtol=1e-4)
  stats = state_dict_from_jax({"params": {}, "batch_stats":
                               jax.tree_util.tree_map(np.asarray,
                                                      jax_state.batch_stats)})
  got = model.state_dict()
  for key, value in stats.items():
    if not key.endswith(".steps"):
      tt.assert_allclose(got[key].numpy(), value.numpy(), rtol=1e-4,
                         atol=1e-4 * float(value.abs().max()), err_msg=key)
  _assert_gradients_agree(
      {k: v for k, v in want.items() if not _feeds_batch_renorm(k)},
      {n: q.grad for n, q in model.named_parameters()}, reach)
