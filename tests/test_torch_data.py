"""The port's host-side data and configuration modules
(corenet_tpu_torch/{config,data,utils}) against the JAX package's, on the
fixture dataset of tests/helpers.py: the same files and seeds go through
both packages, and every array and every order is equal, element for
element (both use numpy's PCG64 for their shuffles).
"""

import dataclasses
import pathlib

import numpy as np
import numpy.testing as tt
import pytest

from corenet_tpu import config as jax_config
from corenet_tpu.data import batching as jax_batching
from corenet_tpu.data import dataset as jax_dataset
from corenet_tpu.data import loader as jax_loader
from corenet_tpu.data import manager as jax_manager
from corenet_tpu.eval.pipeline import shard_range as jax_shard_range
from corenet_tpu.utils import misc as jax_misc
from corenet_tpu_torch import config
from corenet_tpu_torch.data import batching, dataset, loader, manager, scene
from corenet_tpu_torch.eval.pipeline import shard_range
from corenet_tpu_torch.utils import fs, misc
from helpers import make_fixture_dataset

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = ((jax_dataset, jax_manager, jax_config),
            (dataset, manager, config))


@pytest.fixture(scope="module")
def fixture_ds(tmp_path_factory):
  root = tmp_path_factory.mktemp("ds")
  return make_fixture_dataset(str(root), num_scenes=7, num_classes=3)


def _assert_elements_equal(a, b):
  for field in dataclasses.fields(a):
    x, y = getattr(a, field.name), getattr(b, field.name)
    if isinstance(x, str):
      assert x == y
    else:
      assert x.dtype == y.dtype, field.name
      tt.assert_array_equal(x, y, err_msg=field.name)


def test_dataset_classes_elements_and_views_match(fixture_ds):
  path, meshes = fixture_ds
  want = jax_dataset.CoreNetDatasetImpl(path, meshes)
  got = dataset.CoreNetDatasetImpl(path, meshes, high_realism=True)
  assert got.classes == want.classes and got.classes[0] == "__void__"
  assert got.class_to_int_mapping == want.class_to_int_mapping
  assert len(got) == len(want) == 7
  for i in range(len(got)):
    _assert_elements_equal(got[i], want[i])
  assert got[1].input_image.shape == (64, 64, 3)

  views = []
  for lib, impl in ((jax_dataset, want), (dataset, got)):
    ds = lib.CoreNetDataset(impl, impl.classes)
    both = lib.concatenate([ds.shuffle(5)[1:6], ds.take_fraction(0.3, 0.9)])
    views.append((ds.shuffle(123).indices, ds.take_fraction(0.2, 0.75).indices,
                  ds[2:5].indices, ds.select(np.array([4, 0])).indices,
                  [both[i].scene_id for i in range(len(both))]))
    assert lib.concatenate([ds]) is ds
  for a, b in zip(*views):
    tt.assert_array_equal(a, b)
  assert len(views[0][4]) == 5 + 5
  ds = dataset.CoreNetDataset(got, got.classes)
  other = dataset.CoreNetDataset(got, ("__void__", "x"))
  with pytest.raises(ValueError, match="classes"):
    dataset.concatenate([ds, other])


@pytest.mark.parametrize("shuffles", [("NEVER", "NEVER"), ("ONCE", "PER_EPOCH"),
                                      ("PER_EPOCH", "ONCE")])
def test_dataset_manager_epochs_and_resume_match(fixture_ds, shuffles):
  path, meshes = fixture_ds
  orders = []
  for _, mgr_lib, cfg in PACKAGES:
    pipeline = cfg.config_from_dict(cfg.DataPipeline, {
        "datasets": [
            {"dataset_path": path, "meshes_dir": meshes,
             "shuffle": shuffles[0], "data_fraction": 0.8},
            {"dataset_path": path, "meshes_dir": meshes,
             "shuffle": shuffles[0], "high_realism": False}],
        "shuffle": shuffles[1],
        "data_loader": {},
        "voxelization_config": {
            "task_type": "FG_BG",
            "resolution": {"depth": 8, "height": 8, "width": 8}}})
    mgr = mgr_lib.DatasetManager(pipeline)
    assert mgr.epoch_len == 6 + 7
    ids = lambda ds: [ds[i].scene_id for i in range(len(ds))]  # noqa: E731
    orders.append((mgr.classes, ids(mgr.create_dataset(0)),
                   ids(mgr.create_dataset(3)),
                   ids(mgr.create_dataset_from_start_step(13 * 2 + 5))))
  assert orders[0] == orders[1]
  assert len(orders[1][3]) == 13 - 5
  if shuffles[1] == "PER_EPOCH":
    assert orders[1][1] != orders[1][2]


def _elements(fixture_ds):
  path, meshes = fixture_ds
  impl = dataset.CoreNetDatasetImpl(path, meshes)
  return [impl[i] for i in range(4)]


@pytest.mark.parametrize("kwargs", [
    {}, dict(max_edge_view=0.11, max_meshes=3),
    dict(triangle_buckets=(16, 40), grid_offsets="random")])
def test_batch_and_step_inputs_match(fixture_ds, kwargs):
  elements = _elements(fixture_ds)
  kwargs = dict(kwargs)
  if kwargs.get("grid_offsets") == "random":
    kwargs["grid_offsets"] = np.random.default_rng(0).random(
        (4, 3)).astype(np.float32)
  want = jax_batching.batch(elements, **kwargs)
  got = batching.batch(elements, **kwargs)
  for field in dataclasses.fields(got):
    x, y = getattr(got, field.name), getattr(want, field.name)
    if field.name in ("scene_ids", "extra"):
      assert x == y
    else:
      assert x.dtype == y.dtype and x.shape == y.shape, field.name
      tt.assert_array_equal(x, y, err_msg=field.name)
  assert got.tri_valid.sum() >= 4 * 12 and got.mesh_valid.sum() == 6
  got.extra["grid"] = want.extra["grid"] = np.zeros((4, 2, 2, 2), np.int32)
  for task in ("FG_BG", "SEMANTIC", "MESH_INDEX"):
    a, b = got.step_inputs(task), want.step_inputs(task)
    assert sorted(a) == sorted(b) and "grid" in a
    for key in a:
      tt.assert_array_equal(a[key], b[key], err_msg=f"{task} {key}")
  assert got.step_inputs("FG_BG")["mesh_labels"].max() == 1
  assert got.step_inputs("SEMANTIC")["mesh_labels"].max() == 3
  tt.assert_array_equal(got.step_inputs("MESH_INDEX")["mesh_labels"][1, :2],
                        [1, 2])
  with pytest.raises(ValueError):
    got.step_inputs("DEPTH")


def test_indices_shards_and_misc_match():
  for n, shards, pad, shuffle in ((10, 3, True, True), (10, 3, False, True),
                                  (7, 4, True, False), (5, 8, False, True),
                                  (0, 2, False, True)):
    for shard in range(shards):
      tt.assert_array_equal(
          loader.distributed_indices(n, shards, shard, pad, shuffle=shuffle),
          jax_loader.distributed_indices(n, shards, shard, pad,
                                         shuffle=shuffle))
      assert shard_range(n, shards, shard) == jax_shard_range(n, shards,
                                                              shard)
  covered = [i for s in range(3) for i in range(*shard_range(10, 3, s))]
  assert covered == list(range(10)) and shard_range(10, 1, 0) == (0, 10)
  padded = [loader.distributed_indices(10, 3, s, True) for s in range(3)]
  assert all(len(p) == 4 for p in padded)
  assert misc.round_up(13, 4) == jax_misc.round_up(13, 4) == 16
  tt.assert_array_equal(misc.dynamic_tile_np([2, 0, 3]),
                        jax_misc.dynamic_tile_np([2, 0, 3]))
  x, y = np.array([1.0, 2.0, 3.0]), np.array([2.0, 0.0, 4.0])
  tt.assert_array_equal(misc.safe_div(x, y), jax_misc.safe_div(x, y))
  assert fs.join("gs://b/x/", "/y", "z") == "gs://b/x/y/z"
  assert fs.dirname("gs://b/x/y") == "gs://b/x" and fs.basename("a/b/") == "b"


def _batches(lib_loader, ds, **kwargs):
  return list(lib_loader.DataLoader(ds, batch_size=3, num_workers=2,
                                    max_edge_view=0.2, **kwargs))


def test_loader_pads_the_last_batch_like_jax(fixture_ds):
  path, meshes = fixture_ds
  results = []
  for (ds_lib, _, _), ld in zip(PACKAGES, (jax_loader, loader)):
    impl = ds_lib.CoreNetDatasetImpl(path, meshes)
    ds = ds_lib.CoreNetDataset(impl, impl.classes).shuffle(1)
    results.append(_batches(ld, ds, worker_processes=False,
                            random_grid_offset=True, seed=3))
    assert len(ld.DataLoader(ds, batch_size=3)) == 3
    assert len(ld.DataLoader(ds, batch_size=3, drop_last=True)) == 2
  want, got = results
  assert len(got) == len(want) == 3
  for (hb, valid), (jhb, jvalid) in zip(got, want):
    tt.assert_array_equal(valid, jvalid)
    assert hb.scene_ids == jhb.scene_ids
    tt.assert_array_equal(hb.triangles, jhb.triangles)
    tt.assert_array_equal(hb.grid_offset, jhb.grid_offset)
    tt.assert_array_equal(hb.image, jhb.image)
  # 7 scenes at batch 3: the last batch holds one scene, padded with copies
  # of it.
  hb, valid = got[-1]
  assert valid.tolist() == [True, False, False]
  assert hb.scene_ids[1] == hb.scene_ids[0] and hb.image.shape[0] == 3


def test_loader_worker_processes_and_early_exit(fixture_ds):
  """Spawned worker processes give the batches the threads give, and a
  consumer that leaves early stops the producer."""
  path, meshes = fixture_ds
  impl = dataset.CoreNetDatasetImpl(path, meshes)
  ds = dataset.CoreNetDataset(impl, impl.classes)
  threads = _batches(loader, ds, worker_processes=False)
  processes = _batches(loader, ds, worker_processes=True)
  assert len(processes) == len(threads) == 3
  for (a, va), (b, vb) in zip(processes, threads):
    tt.assert_array_equal(va, vb)
    tt.assert_array_equal(a.triangles, b.triangles)
    tt.assert_array_equal(a.mesh_labels, b.mesh_labels)
  batches = iter(loader.DataLoader(ds, batch_size=1, num_workers=2,
                                   prefetch_factor=1,
                                   worker_processes=False))
  next(batches)
  batches.close()  # joins the producer thread


def test_loader_fails_loudly_on_a_broken_scene(fixture_ds, tmp_path):
  import json
  import shutil
  path, meshes = fixture_ds
  root = tmp_path / "scenes"
  shutil.copytree(pathlib.Path(path).parent, root)
  (root / "scene_002.npz").write_bytes(b"not an npz")
  impl = dataset.CoreNetDatasetImpl(str(root / "dataset.json"), meshes)
  assert json.loads((root / "dataset.json").read_text())["files"][2] == (
      "scene_002.npz")
  ds = dataset.CoreNetDataset(impl, impl.classes)
  with pytest.raises(RuntimeError, match="producer failed"):
    _batches(loader, ds, worker_processes=False)


def test_decode_image_passes_arrays_through_and_decodes_png():
  import io

  import PIL.Image
  image = np.random.default_rng(0).integers(0, 256, (5, 6, 3)).astype(np.uint8)
  assert scene.decode_image(image) is not None
  tt.assert_array_equal(scene.decode_image(image), image)
  buf = io.BytesIO()
  PIL.Image.fromarray(image).save(buf, format="PNG")
  tt.assert_array_equal(scene.decode_image(buf.getvalue()), image)
  tt.assert_array_equal(
      scene.decode_image(np.frombuffer(buf.getvalue(), np.uint8)), image)


@pytest.mark.parametrize("name", ["h5", "h7", "m7", "m9", "y1"])
def test_model_configs_parse_the_same(name):
  path = str(REPO / "configs" / "models" / f"{name}.json5")
  overrides = dict(set_overrides=["train.max_steps=12",
                                  "eval.0.config.name=\"renamed\""],
                   template_overrides={"data_dir": "/data/x"})
  want = jax_config.load_config_file(path, jax_config.TrainPipeline,
                                     **overrides)
  got = config.load_config_file(path, config.TrainPipeline, **overrides)
  as_dict = config.config_to_dict(got)
  assert as_dict == jax_config.config_to_dict(want)
  assert as_dict["train"]["max_steps"] == 12
  assert as_dict["eval"][0]["config"]["name"] == "renamed"
  assert as_dict["train"]["data"]["datasets"][0]["dataset_path"].startswith(
      "/data/x/")
  # The round trip through plain data gives the same configuration.
  again = config.config_from_dict(config.TrainPipeline, as_dict)
  assert config.config_to_dict(again) == as_dict
  assert isinstance(got.train.data.voxelization_config.task_type,
                    config.TaskType)


def test_templates_and_overrides_match():
  data = {"string_templates": [{"key": "root", "value": "/r"},
                               {"key": "out", "value": "{root}/out"}],
          "eval_config": {
              "name": "e", "data": {
                  "datasets": [{"dataset_path": "{root}/d.json",
                                "meshes_dir": "{root}/m"}],
                  "shuffle": "NEVER", "data_loader": {"batch_size": 2},
                  "voxelization_config": {
                      "task_type": "SEMANTIC",
                      "resolution": {"depth": 1, "height": 2, "width": 3}}}},
          "frozen_graph_path": "{out}/g.pb", "output_path": "{out}"}
  results = []
  for cfg in (jax_config, config):
    import copy
    parsed = cfg.post_process_config(
        copy.deepcopy(data), cfg.TfModelEvalPipeline,
        set_overrides=["eval_config.data.data_loader.batch_size=5"],
        template_overrides=cfg.parse_template_mapping(["root=/other"]))
    results.append(cfg.config_to_dict(parsed))
  assert results[0] == results[1]
  assert results[1]["frozen_graph_path"] == "/other/out/g.pb"
  assert results[1]["eval_config"]["data"]["data_loader"]["batch_size"] == 5
  res = config.config_from_dict(config.Resolution, {"depth": 1, "height": 2,
                                                    "width": 3})
  assert res.as_tuple() == (1, 2, 3)
