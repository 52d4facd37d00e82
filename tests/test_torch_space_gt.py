"""The ground truth shared over the 'space' axis (train/gt.py::space_shared):
each space rank voxelizes its share of the data group's scenes with the
blocked rasterizer (K3, the packed fill) and phases them (K4), and the
ranks trade depth slabs with an all-to-all (parallel/mesh.py), on gloo
processes on the CPU (the kernels' plain versions).

Cases: 64³ at batch 2 on data 1 × space 2, and 32³ at batch 4 on
data 1 × space 4 (the blocked route serves 32³ off the TPU). Each scene:
a cube shell moved by the scene's index and a seeded sphere, both across
the slabs' boundaries; one scene's cube has label 0. On every rank, bit
for bit (0 voxels differ): the FG_BG labels phased at s = 4 and s = 2,
and the blocked labeled grid (labels 1 and 2, uint8), shared over the
space ranks, against the same labels made whole on the rank and cut to
its slab (the replicated route), and against the JAX package's
`voxelize_batch_packed_fgbg` + `phased_gt` and `voxelize_batch` run as its
own tests run its kernels on a mesh: a registered (data 1, space S) mesh
of the virtual CPU devices with CORENET_FORCE_KERNELS=1 (Pallas in
interpret mode), whose whole-grid producers then shard the batch over
data × space (kernel_sharding.py's allow_space_batch route), cut to the
same slabs. The route counts say which route each call took; a batch that
does not divide (3 scenes on space 2) takes the replicated one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corenet_tpu.ops.phased_gt import phased_gt as jax_phased_gt
from corenet_tpu.parallel import kernel_sharding
from corenet_tpu.parallel import mesh as jax_mesh
from corenet_tpu.train import gt as jax_gt
from corenet_tpu_torch.utils import tracing
from test_torch_distributed import run_ranks

IRM = 8
WINDOW = 24  # data/batching.py's VOXELIZE_WINDOW_PIXELS
CASES = {"64³ space 2": (64, 2, 2), "32³ space 4": (32, 4, 4)}
PHASES = (4, 2)
LABELS_OF_SLOTS = (2, 1)  # the labeled grid: cube 2, sphere 1


def _routes() -> dict:
  """The labels' routes taken so far (train/gt.py::labels_slab)."""
  counts = tracing.counters()
  return {route: counts[f"gt.route.{route}"]
          for route in ("space_shared", "replicated")}


def _kwargs(m):
  return dict(resolution=(m, m, m), sub_grid_sampling=False,
              image_resolution_multiplier=IRM,
              conservative_rasterization=False,
              projection_depth_multiplier=1, max_bbox_pixels=WINDOW,
              fill_rounds=None)


@functools.lru_cache(maxsize=None)
def scene_batch(m, b):
  """`b` scenes of two mesh slots: the subdivided cube shell [0.15, 0.8]³
  moved by 0.03 per scene (label 0 in scene 1), and a seeded sphere."""
  from corenet_tpu_torch.data import batching
  from helpers import cube_mesh
  from test_torch_raster_fast import _sphere
  rng = np.random.default_rng([m, b])
  max_edge = (WINDOW - 4) / IRM / m
  tri = []
  for i in range(b):
    cube = cube_mesh(0.15, 0.8) + np.float32(0.03 * i)
    sphere = _sphere(rng, rng.uniform(0.35, 0.65, 3), 0.12)
    tri.append([batching.subdivide_triangles(cube, max_edge),
                batching.subdivide_triangles(sphere, max_edge)])
  t = batching._pad_to_bucket(max(len(a) + len(s) for a, s in tri))
  triangles = np.zeros((b, t, 3, 3), np.float32)
  slot = np.zeros((b, t), np.int32)
  valid = np.zeros((b, t), bool)
  for i, (a, s) in enumerate(tri):
    n = len(a) + len(s)
    triangles[i, :n] = np.concatenate([a, s])
    slot[i, len(a):n] = 1
    valid[i, :n] = True
  labels = np.ones((b, 2), np.int32)
  labels[1, 0] = 0
  offsets = rng.uniform(0.1, 0.9, (b, 3)).astype(np.float32)
  return triangles, slot, valid, labels, offsets


def _labeled(labels):
  return np.where(labels > 0, np.array(LABELS_OF_SLOTS, np.int32), 0)


def gt_jobs(rank, world, m, b):
  """This rank's slabs of every kind of labels by both routes, and the
  route counts of each call."""
  from corenet_tpu_torch.ops.phased_gt import phased_gt
  from corenet_tpu_torch.parallel import mesh
  from corenet_tpu_torch.train import gt
  mesh.create_mesh(space=world)
  shard = (mesh.space_index(), world)
  arrays = [torch.from_numpy(a) for a in scene_batch(m, b)]
  labeled = arrays[:3] + [torch.from_numpy(_labeled(scene_batch(m, b)[3]))
                          ] + arrays[4:]
  grid_of = functools.partial(gt.voxelize_batch, num_label_values=3,
                              **_kwargs(m))
  assert gt.blocked_grid_eligible(num_label_values=3, **_kwargs(m))
  shares = gt.shares_over_space
  out = {}
  for route in ("shared", "replicated"):
    if route == "replicated":
      gt.shares_over_space = lambda *_: False
    for s in PHASES:
      def phased(*scenes, s=s):
        packed, v2x = gt.voxelize_batch_packed_fgbg(*scenes, **_kwargs(m))
        return phased_gt(packed, s), v2x
      counts = _routes()
      labels, _ = gt.labels_slab(phased, arrays, shard, shareable=True)
      out[route, s] = (labels.numpy(), _delta(_routes(), counts))
    counts = _routes()
    grid, v2x = gt.labels_slab(grid_of, labeled, shard, shareable=True)
    out[route, "grid"] = (grid.numpy(), _delta(_routes(), counts))
    out["v2x", route] = v2x.numpy()
    gt.shares_over_space = shares
  # The batch less one scene does not divide by the space count.
  counts = _routes()
  grid, _ = gt.labels_slab(grid_of, [a[:b - 1] for a in labeled], shard,
                           shareable=True)
  out["indivisible"] = (grid.numpy(), _delta(_routes(), counts))
  return out


def _delta(counts, before):
  return {k: v - before[k] for k, v in counts.items() if v != before[k]}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
  m, b, space = CASES[request.param]
  ranks = run_ranks(tmp_path_factory.mktemp("gt"), "test_torch_space_gt",
                    "gt_jobs", {"m": m, "b": b}, world=space, timeout=600)
  return m, b, space, ranks


@pytest.fixture(scope="module")
def jax_labels(case):
  """JAX's labels on its (data 1, space S) mesh with the kernels forced."""
  m, b, space, _ = case
  mesh = jax_mesh.create_mesh(data=1, space=space,
                              devices=jax.devices()[:space])
  mp = pytest.MonkeyPatch()
  mp.setenv("CORENET_FORCE_KERNELS", "1")
  kernel_sharding.register_mesh(mesh)
  try:
    assert kernel_sharding.kernel_mode(b, allow_space_batch=True) is mesh
    for k in kernel_sharding.trace_counters:
      kernel_sharding.trace_counters[k] = 0
    inputs = [jnp.asarray(a) for a in scene_batch(m, b)]
    packed, _ = jax_gt.voxelize_batch_packed_fgbg(*inputs, **_kwargs(m))
    out = {s: np.asarray(jax_phased_gt(packed, s)) for s in PHASES}
    inputs[3] = jnp.asarray(_labeled(scene_batch(m, b)[3]))
    grid, v2x = jax_gt.voxelize_batch(*inputs, num_label_values=3,
                                      **_kwargs(m))
    out["grid"], out["v2x"] = np.asarray(grid), np.asarray(v2x)
    taken = dict(kernel_sharding.trace_counters)
  finally:
    kernel_sharding.register_mesh(None)
    mp.undo()
  assert taken["block_scatter"] >= 2 and taken["phased_gt"] == len(PHASES)
  return out


def _slab(whole, rank, space):
  depth = whole.shape[1] // space
  return whole[:, rank * depth:(rank + 1) * depth]


@pytest.mark.parametrize("kind", list(PHASES) + ["grid"])
def test_shared_labels_equal_the_replicated_and_jax_slabs(case, jax_labels,
                                                          kind):
  m, b, space, ranks = case
  whole = jax_labels[kind]
  for rank, r in enumerate(ranks):
    shared, shared_counts = r["shared", kind]
    replicated, replicated_counts = r["replicated", kind]
    assert shared_counts == {"space_shared": 1}, shared_counts
    assert replicated_counts == {"replicated": 1}, replicated_counts
    assert shared.dtype == replicated.dtype == np.uint8
    assert shared.shape == replicated.shape
    assert shared.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(shared, replicated, err_msg=f"rank {rank}")
    want = _slab(whole, rank, space)
    assert shared.shape == want.shape
    assert int((shared != want).sum()) == 0, f"rank {rank}"
    for route in ("shared", "replicated"):
      np.testing.assert_array_equal(r["v2x", route], jax_labels["v2x"])
  # Every slab holds labels: the meshes cross the slabs' boundaries.
  assert all(r["shared", kind][0].any() for r in ranks)
  if kind == "grid":
    assert set(np.unique(whole)) == {0, 1, 2}


def test_a_batch_that_does_not_divide_takes_the_replicated_route(case):
  m, b, space, ranks = case
  assert (b - 1) % space
  for rank, r in enumerate(ranks):
    grid, counts = r["indivisible"]
    assert counts == {"replicated": 1}, counts
    np.testing.assert_array_equal(grid, r["replicated", "grid"][0][:b - 1])
