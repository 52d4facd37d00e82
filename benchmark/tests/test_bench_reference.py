"""The benchmark's plain reference held against corenet_tpu_torch on the
CPU, at 32³ and 64³ with batches of 2; and the benchmark's isolation: its
reference imports nothing of the program, and a run without a card
prints no result and loads neither JAX nor the JAX package."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import scenes, weights
from benchmark.reference import gt as ref_gt
from benchmark.reference import model as ref
from benchmark.reference import serve as ref_serve
from benchmark.tests.bench_fixtures import REPO

TRAFFIC = dict(meshes=8, triangles=[512, 4096], scenes=6, views=16,
               kinds=["ellipsoid", "box", "chair", "table"],
               scale=[0.45, 0.65])


def _camera(b, f0=1.8):
  near, far = 0.5, 3.0
  a = (far + near) / (far - near)
  c = -2 * far * near / (far - near)
  return torch.tensor([[[f, 0, 0, -0.5 * f], [0, f, 0, -0.5 * f],
                        [0, 0, a, a + c], [0, 0, 1, 1.0]]
                       for f in f0 + 0.1 * np.arange(b)], dtype=torch.float32)


def _weights(res, seed=5):
  return weights.make(weights.shapes((res,) * 3, 2, 64, 0.75, 2), seed,
                      "cpu")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
  root = str(tmp_path_factory.mktemp("data"))
  scenes.write_dataset(root, TRAFFIC, 11)
  return root


@pytest.mark.parametrize("m", [32, 64])
def test_labels_equal_the_programs_ground_truth(dataset, m):
  from corenet_tpu_torch.data import batching
  from corenet_tpu_torch.data.dataset import CoreNetDatasetImpl
  from corenet_tpu_torch.train import gt
  from corenet_tpu_torch.voxel.packed import unpack_grid
  impl = CoreNetDatasetImpl(os.path.join(dataset, "dataset.json"),
                            os.path.join(dataset, "meshes"))
  hb = batching.batch([impl[0], impl[1]],
                      max_edge_view=ref_gt.max_edge_view(8, m))
  inputs = {k: torch.from_numpy(v) for k, v in
            hb.step_inputs("FG_BG").items()}
  packed, _ = gt.voxelize_batch_packed_fgbg(
      *(inputs[k] for k in ("triangles", "tri_mesh_slot", "tri_valid",
                            "mesh_labels", "grid_offset")),
      resolution=(m,) * 3, image_resolution_multiplier=8,
      conservative_rasterization=False, max_bbox_pixels=24)
  program = unpack_grid(packed[:, None], dtype=torch.uint8)[:, 0]
  meshes = [ref_gt.read_scene(os.path.join(dataset, f"scene_{i:05d}.npz"),
                              os.path.join(dataset, "meshes"))[2]
            for i in range(2)]
  labels = ref_gt.fgbg_labels(meshes, m, 8, "cpu")
  assert int(labels.sum()) > 0
  assert torch.equal(labels, program)


def test_subdivision_and_epoch_order_are_the_loaders(dataset):
  from corenet_tpu_torch.data.batching import subdivide_triangles
  from corenet_tpu_torch.data.manager import DatasetManager
  from corenet_tpu_torch.config import config as cfg
  tris = ref_gt.read_scene(os.path.join(dataset, "scene_00000.npz"),
                           os.path.join(dataset, "meshes"))[2][0][1]
  edge = ref_gt.max_edge_view(8, 128)
  mine = ref_gt.subdivide(tris, edge)
  theirs = subdivide_triangles(tris, edge)
  key = lambda t: np.lexsort(t.reshape(len(t), -1).T)
  assert np.array_equal(mine[key(mine)], theirs[key(theirs)])
  with open(os.path.join(REPO, "benchmark", "configs", "h7.json")) as f:
    data = json.loads(f.read().replace("{data_dir}", dataset))
  pipeline = cfg.config_from_dict(cfg.DataPipeline, data["train"]["data"])
  ds = DatasetManager(pipeline).create_dataset(local_seed=0)
  assert list(ds.indices) == list(ref_gt.epoch_order(TRAFFIC["scenes"]))


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("train", [False, True])
def test_forward_equals_the_fine_model(dtype, train):
  from corenet_tpu_torch import CoreNet, CoreNetConfig, DecoderConfig
  res = 64
  w = _weights(res)
  model = CoreNet(CoreNetConfig(DecoderConfig((res,) * 3, 2)),
                  compute_dtype=dtype)
  model.load_state_dict(w, strict=True)
  model.train(train)
  image = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(3))
  v2x = torch.diag(torch.tensor([float(res)] * 3 + [1.0])).expand(2, 4, 4)
  v2s = ref.compute_v2s(_camera(2), v2x)
  offsets = torch.full((2, 3), 0.5)
  with torch.no_grad():
    program = model(image, v2s, offsets)
    mine = ref.forward(dict(w), image, v2s, offsets, (res,) * 3, train,
                       ref.Precision(dtype))
  assert torch.equal(mine, program)


def test_super_resolution_matches_the_served_pmf():
  from corenet_tpu_torch import CoreNet, CoreNetConfig, DecoderConfig
  from corenet_tpu_torch.eval.super_resolution import (
      super_resolution_from_model)
  w = _weights(32)
  model = CoreNet(CoreNetConfig(DecoderConfig((32,) * 3, 2)))
  infer = super_resolution_from_model(model, w, (32,) * 3, device="cpu")
  image = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(4))
  camera = _camera(2)
  v2x = torch.diag(torch.tensor([64.0] * 3 + [1.0])).expand(2, 4, 4)
  offsets = torch.full((2, 3), 0.5)
  program = infer(image, camera, v2x, offsets, (64,) * 3)
  mine = ref_serve.pmf(dict(w), image, camera, v2x, offsets, 32, 64,
                       ref.Precision())
  assert mine.shape == program.shape
  assert float((mine - program).abs().max()) < 1e-4


def test_reference_imports_nothing_of_the_program():
  folder = os.path.join(REPO, "benchmark", "reference")
  for name in os.listdir(folder):
    if not name.endswith(".py"):
      continue
    tree = ast.parse(open(os.path.join(folder, name)).read())
    for node in ast.walk(tree):
      names = ([a.name for a in node.names] if isinstance(node, ast.Import)
               else [node.module or ""] if isinstance(node, ast.ImportFrom)
               else [])
      for n in names:
        assert n.split(".")[0] in ("torch", "numpy", "benchmark", "math",
                                   "os", "typing", "__future__"), (name, n)
        assert not n.startswith("benchmark.") or n.startswith(
            "benchmark.reference"), (name, n)


def test_a_run_without_a_card_prints_no_result_and_loads_no_jax():
  script = (
      "import sys; sys.path.insert(0, %r)\n"
      "from benchmark import run\n"
      "code = run.main(['--workload', 'h7.train.device_gt', '--seed', '1',"
      " '--seconds', '1', '--trace', '0'])\n"
      "from benchmark.harness import device\n"
      "print('FORBIDDEN', device.forbidden_modules())\n"
      "sys.exit(code)\n") % REPO
  proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                        capture_output=True, text=True, timeout=300,
                        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
  assert proc.returncode != 0
  lines = proc.stdout.strip().splitlines()
  assert lines == ["FORBIDDEN []"]
  for line in lines:
    with pytest.raises(json.JSONDecodeError):
      json.loads(line)
