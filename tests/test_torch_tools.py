"""The port's dataset and config tools, its debug helpers and its weight
importers against the JAX package's, on the CPU.

- cli/preprocess_shapenet.py: a seeded ShapeNet-shaped tree of OBJ files
  (fans, v/vt/vn faces, degenerate triangles) gives the NPZ arrays that
  the JAX tool writes, and `cleanup_mesh` drops what the JAX one drops.
- cli/generate_configs.py: the tree it writes equals configs/ and the JAX
  generator's output byte for byte.
- utils/debug.py: `array_summary` gives the JAX package's strings for
  numpy inputs (and the same for tensors); `save_debug_image` the pixels
  the JAX helper writes through PIL.
- cli/import_corenet_checkpoint.py: a seeded reference-layout CoreNet
  state dict at 32³ (built as tests/test_import.py builds one, saved with
  torch.save as a `SavedState` object and as a plain dict) converts to
  the JAX converter's tensors; the `.cpt` it writes decodes in the JAX
  package's `decode_state` to the tree of the `.cpt` that the JAX
  importer writes from the same file, and serves through the eval CLI's
  `load_model`.
- cli/import_resnet50_checkpoint.py: a small Keras-layout h5 written with
  h5py gives the JAX importer's `.npz` arrays.
"""

import filecmp
import json
import os
import sys

import numpy as np
import numpy.testing as tt
import PIL.Image
import pytest
import torch

from corenet_tpu.cli import generate_configs as jax_generate_configs
from corenet_tpu.cli import import_corenet_checkpoint as jax_import
from corenet_tpu.cli import import_resnet50_checkpoint as jax_resnet_import
from corenet_tpu.cli import preprocess_shapenet as jax_pp
from corenet_tpu.train import checkpoint as jax_cpt
from corenet_tpu.utils import debug as jax_debug
from corenet_tpu_torch.cli import generate_configs
from corenet_tpu_torch.cli import import_corenet_checkpoint
from corenet_tpu_torch.cli import import_resnet50_checkpoint
from corenet_tpu_torch.cli import preprocess_shapenet as pp
from corenet_tpu_torch.models.convert import (
    jax_variables_from_state_dict, state_dict_from_jax)
from corenet_tpu_torch.models.corenet import (
    CoreNet, CoreNetConfig, DecoderConfig)
from corenet_tpu_torch.utils import debug
from corenet_tpu_torch.utils.png import decode_png
from helpers import make_fixture_dataset
from test_import import _flatten, _torch_key_and_layout
from test_torch_saved_states import (  # noqa: F401  (an autouse fixture)
    remove_states_after_each_test)
from test_torch_train_pipeline import full_config_dict

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------ preprocess ----
def _write_obj(path, rng):
  """A seeded OBJ: a random soup of quads and triangles in mixed face
  syntax, a zero-area triangle, a collinear one and a zero-length edge."""
  vertices = rng.random((12, 3)).astype(np.float32)
  lines = ["# seeded"] + [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in
                          vertices]
  lines.append("v 0.25 0.25 0.25")   # 13
  lines.append("v 0.5 0.5 0.5")      # 14: collinear with 13 and 15
  lines.append("v 0.75 0.75 0.75")   # 15
  for _ in range(6):
    face = rng.choice(12, size=int(rng.integers(3, 6)), replace=False) + 1
    style = int(rng.integers(3))
    lines.append("f " + " ".join(
        [str(i), f"{i}/{i}", f"{i}/{i}/{i}"][style] for i in face))
  lines += ["f 1 2 1", "f 13 14 15", "f 13 13 2", "vn 0 0 1", ""]
  path.write_text("\n".join(lines))


def test_preprocess_shapenet_writes_the_jax_tools_arrays(tmp_path):
  rng = np.random.default_rng(5)
  root = tmp_path / "shapenet"
  objs = []
  for label, mesh_id in (("04379243", "mesh01"), ("04379243", "mesh02"),
                         ("02691156", "plane7")):
    models = root / label / mesh_id / "models"
    os.makedirs(models)
    _write_obj(models / "model_normalized.obj", rng)
    objs.append((label, mesh_id, str(models / "model_normalized.obj")))
  pp.main([f"--shapenet_root={root}", f"--output_root={tmp_path / 'out'}",
           "--num_workers=2"])
  for label, mesh_id, obj in objs:
    want_path = jax_pp.process_mesh(obj, str(tmp_path / "jax"))
    got_path = str(tmp_path / "out" / label / f"{mesh_id}.npz")
    with np.load(got_path) as got, np.load(want_path) as want:
      assert sorted(got.files) == sorted(want.files) == [
          "label", "mesh_id", "vertices"]
      for name in want.files:
        assert got[name].dtype == want[name].dtype, name
        tt.assert_array_equal(got[name], want[name])
      assert got["vertices"].shape[0] > 0
      assert str(got["label"]) == label and str(got["mesh_id"]) == mesh_id
    # The degenerate faces are read, then cleaned away.
    raw = pp.read_obj(obj)
    tt.assert_array_equal(raw, jax_pp.read_obj(obj))
    assert len(raw) - len(pp.cleanup_mesh(raw)) == 3


def test_cleanup_drops_what_the_jax_tool_drops():
  """tests/test_cli_tools.py's cases, and seeded near-degenerate ones."""
  tri_ok = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
  tri_line = np.array([[[0, 0, 0], [1, 0, 0], [2, 0, 0]]], np.float32)
  tri_point = np.zeros((1, 3, 3), np.float32)
  rng = np.random.default_rng(9)
  soup = rng.random((64, 3, 3)).astype(np.float32)
  soup[::4, 2] = soup[::4, 0]                     # zero-length edges
  soup[1::4, 1] = soup[1::4, 0] * 2 - soup[1::4, 2]  # collinear-ish
  for mesh in (np.concatenate([tri_ok, tri_line, tri_point]), soup,
               np.zeros((0, 3, 3), np.float32)):
    got = pp.cleanup_mesh(mesh)
    tt.assert_array_equal(got, jax_pp.cleanup_mesh(mesh))
  tt.assert_array_equal(pp.cleanup_mesh(
      np.concatenate([tri_ok, tri_line])), tri_ok)
  assert 0 < len(pp.cleanup_mesh(soup)) < len(soup)


# ------------------------------------------------- generate_configs ----
def test_generate_configs_writes_configs_and_the_jax_tree(tmp_path):
  generate_configs.main(["--output_dir", str(tmp_path / "port")])
  jax_generate_configs.main(["--output_dir", str(tmp_path / "jax")])
  for sub in ("models", "paper_tf_models", "schemas"):
    names = sorted(os.listdir(os.path.join(REPO, "configs", sub)))
    assert names and sorted(os.listdir(tmp_path / "port" / sub)) == names
    for other in (os.path.join(REPO, "configs", sub), tmp_path / "jax" / sub):
      match, mismatch, errors = filecmp.cmpfiles(
          tmp_path / "port" / sub, other, names, shallow=False)
      assert (mismatch, errors) == ([], []) and match == names


# ------------------------------------------------------------ debug ----
SUMMARY_INPUTS = [
    np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
    np.array([1.0, np.nan, -np.inf, 2.5], np.float64),
    np.array([np.nan, np.inf]),
    np.array([[True, False], [True, True]]),
    np.arange(-3, 9, dtype=np.int32).reshape(2, 2, 3),
    np.zeros((0, 4), np.float32),
    np.array(3.5, np.float32),
    np.random.default_rng(0).normal(size=(5, 6)).astype(np.float16),
    [1, 2, 3],
    {"not": "an array"},
]


@pytest.mark.parametrize("index", range(len(SUMMARY_INPUTS)))
def test_array_summary_is_the_jax_packages(index):
  x = SUMMARY_INPUTS[index]
  want = jax_debug.array_summary(x)
  assert debug.array_summary(x) == want
  a = np.asarray(x) if not isinstance(x, dict) else None
  if a is not None and a.dtype != object:
    assert debug.array_summary(torch.from_numpy(np.array(a))) == want


def test_save_debug_image_writes_the_jax_helpers_pixels(tmp_path):
  rng = np.random.default_rng(1)
  images = [rng.integers(0, 256, (6, 7, 3)).astype(np.uint8),
            rng.normal(size=(5, 4)).astype(np.float32),
            rng.random((4, 3, 3))]
  for i, image in enumerate(images):
    got = debug.save_debug_image(image, str(tmp_path / "port" / f"{i}.png"))
    want = jax_debug.save_debug_image(image, str(tmp_path / "jax" /
                                                 f"{i}.png"))
    with open(got, "rb") as f:
      pixels = decode_png(f.read())
    tt.assert_array_equal(pixels, np.asarray(PIL.Image.open(want)))
  tensor = torch.from_numpy(images[1]).to(torch.bfloat16)
  assert debug.array_summary(tensor).startswith("float32[5, 4]")
  debug.install_compact_array_repr()
  try:
    assert "..." in repr(torch.arange(1000))
  finally:
    torch.set_printoptions(profile="default")


# ---------------------------------------------- CoreNet checkpoints ----
class SavedState:
  """The released checkpoints' pickled container: the model's state dict
  and the global step."""

  def __init__(self, model_state, global_step):
    self.model_state = model_state
    self.global_step = global_step


def _reference_state_dict():
  """A released-layout CoreNet state dict (torch tensors) for a 32³ model:
  tests/test_import.py's inverse mapping of every variable, with seeded
  values, and the flat tree it must convert to."""
  model = CoreNet(CoreNetConfig(DecoderConfig((32,) * 3, 2)))
  flat = _flatten(jax_variables_from_state_dict(model.state_dict()))
  rng = np.random.default_rng(0)
  torch_state, expected = {}, {}
  for key, value in sorted(flat.items()):
    tkey, transpose = _torch_key_and_layout(key)
    if value.ndim:
      fresh = rng.standard_normal(value.shape).astype(np.float32)
    else:
      fresh = np.asarray(int(rng.integers(1, 100)), np.int64)
    expected[key] = fresh
    if transpose and fresh.ndim == len(transpose):
      fresh = np.ascontiguousarray(np.transpose(fresh, transpose))
    torch_state[tkey] = torch.from_numpy(fresh)
  return torch_state, expected


def _tree_leaves(tree, prefix=()):
  for key, value in sorted(tree.items()):
    if isinstance(value, dict):
      yield from _tree_leaves(value, prefix + (key,))
    else:
      yield prefix + (key,), np.asarray(value)


def test_convert_torch_state_is_the_jax_converters():
  torch_state, expected = _reference_state_dict()
  got = import_corenet_checkpoint.convert_torch_state(torch_state)
  want = jax_import.convert_torch_state(
      {k: v.numpy() for k, v in torch_state.items()})
  assert sorted(got) == sorted(want) == sorted(expected)
  for key in want:
    assert got[key].dtype == np.asarray(want[key]).dtype, key
    tt.assert_array_equal(got[key], want[key], err_msg=key)
  # The inverse mapping gives back the released names and layouts.
  back = import_corenet_checkpoint.reference_state_dict(expected)
  assert sorted(back) == sorted(torch_state)
  for key, value in torch_state.items():
    assert back[key].dtype == value.dtype and torch.equal(back[key], value), (
        key)
  # Into the port's CoreNet, through the JAX tree.
  nested = import_resnet50_checkpoint.flat_tree_to_nested(want)
  model = CoreNet(CoreNetConfig(DecoderConfig((32,) * 3, 2)))
  merged = import_resnet50_checkpoint.merge_variables(
      model.state_dict(), got, "reference")
  for key, value in state_dict_from_jax(nested).items():
    assert torch.equal(merged[key], value.to(merged[key].dtype)), key


@pytest.mark.parametrize("form", ["saved_state", "dict"])
def test_the_imported_cpt_is_the_jax_importers(tmp_path, form):
  from corenet_tpu_torch.cli.eval import load_model
  manifest, meshes_dir = make_fixture_dataset(str(tmp_path / "ds"),
                                              num_scenes=2, image_size=64)
  config_path = str(tmp_path / "train.json")
  with open(config_path, "w") as f:
    json.dump(full_config_dict(str(tmp_path), manifest, meshes_dir), f)
  torch_state, expected = _reference_state_dict()
  blob = (SavedState(torch_state, 12) if form == "saved_state"
          else {"model_state": torch_state, "global_step": 12})
  released = str(tmp_path / "released.cpt")
  torch.save(blob, released)

  args = [f"--torch_checkpoint={released}",
          f"--train_config={config_path}"]
  port_path = str(tmp_path / "port" / "imported.cpt")
  import_corenet_checkpoint.main(args + [f"--output_path={port_path}"])
  with open(port_path, "rb") as f:
    got, got_meta = jax_cpt.decode_state(f.read())
  os.unlink(port_path)
  jax_path = str(tmp_path / "jax" / "imported.cpt")
  os.makedirs(tmp_path / "jax")  # the JAX importer writes there first
  jax_import.main(args + [f"--output_path={jax_path}"])
  with open(jax_path, "rb") as f:
    want, want_meta = jax_cpt.decode_state(f.read())
  os.unlink(jax_path)

  assert int(got.global_step) == int(want.global_step) == 12
  assert got_meta == want_meta
  assert got_meta["imported_from"] == released
  assert got_meta["classes"] == ["__void__", "class_a", "class_b"]
  for name in ("params", "batch_stats", "opt_state"):
    got_leaves = dict(_tree_leaves(getattr(got, name)))
    want_leaves = dict(_tree_leaves(getattr(want, name)))
    assert sorted(got_leaves) == sorted(want_leaves), name
    for key, value in want_leaves.items():
      assert got_leaves[key].dtype == value.dtype, key
      tt.assert_array_equal(got_leaves[key], value, err_msg=str(key))
  assert int(got.opt_state["0"]["count"]) == 0
  for key, value in expected.items():
    collection, *path = key.split("/")
    leaf = dict(_tree_leaves(getattr(got, collection)))[tuple(path)]
    tt.assert_array_equal(leaf, value.astype(leaf.dtype), err_msg=key)

  # The eval CLI serves the file with the converted weights.
  import_corenet_checkpoint.main(args + [f"--output_path={port_path}"])
  model, full_config, classes, step = load_model(port_path)
  assert step == 12 and classes == got_meta["classes"]
  assert full_config.train.data.voxelization_config.resolution.depth == 32
  for key, value in state_dict_from_jax(
      {"params": want.params, "batch_stats": want.batch_stats}).items():
    assert torch.equal(model.state_dict()[key], value), key


# --------------------------------------------------- Keras ResNet-50 ----
def _write_keras_h5(path, rng):
  """A Keras-layout notop ResNet-50 h5 with small seeded weights; every
  other layer nests its weights under its name twice, as Keras does."""
  h5py = pytest.importorskip("h5py")
  layers = {"conv1": "conv", "bn_conv1": "bn"}
  for stage, blocks in {2: "abc", 3: "abcd", 4: "abcdef", 5: "abc"}.items():
    for block in blocks:
      for branch in ("2a", "2b", "2c", "1"):
        if branch == "1" and block != "a":
          continue
        layers[f"res{stage}{block}_branch{branch}"] = "conv"
        layers[f"bn{stage}{block}_branch{branch}"] = "bn"
  with h5py.File(path, "w") as f:
    for i, (name, kind) in enumerate(sorted(layers.items())):
      group = f.create_group(name)
      if i % 2:
        group = group.create_group(name)
      c = int(rng.integers(2, 5))
      names = (("kernel:0", (1, 1, 3, c)), ("bias:0", (c,))) if kind == "conv" \
          else (("gamma:0", (c,)), ("beta:0", (c,)),
                ("moving_mean:0", (c,)), ("moving_variance:0", (c,)))
      for key, shape in names:
        group.create_dataset(key, data=rng.normal(size=shape).astype(
            np.float32))


def test_the_keras_importer_writes_the_jax_importers_npz(tmp_path,
                                                         monkeypatch):
  h5_path = str(tmp_path / "resnet50.h5")
  _write_keras_h5(h5_path, np.random.default_rng(3))
  with open(h5_path, "rb") as f:
    want = jax_resnet_import.convert_keras_h5(f.read())
  out = str(tmp_path / "encoder.npz")
  got = import_resnet50_checkpoint.main([f"--keras_h5={h5_path}",
                                         f"--output_path={out}"])
  assert sorted(got) == sorted(want)
  assert len(want) == 7 + 16 * 21 + 4 * 7
  with np.load(out) as written:
    assert sorted(written.files) == sorted(want)
    for key, value in want.items():
      assert written[key].dtype == value.dtype, key
      tt.assert_array_equal(written[key], value, err_msg=key)
  # Without h5py the importer says what is missing.
  monkeypatch.setitem(sys.modules, "h5py", None)
  with pytest.raises(ImportError, match="h5py"):
    import_resnet50_checkpoint.convert_keras_h5(b"")
