"""A copy of the benchmark at a size a CPU test can hold: the same files,
with the configurations cut to 64³ (y1 served at 64³), batches of 2, two
loader threads and small traffic."""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
  sys.path.insert(0, REPO)


def _edit(path, change):
  with open(path) as f:
    data = json.load(f)
  change(data)
  with open(path, "w") as f:
    json.dump(data, f)


def shrink(root: str) -> None:
  """Cuts the copy of the benchmark under `root` to CPU test sizes."""
  b = os.path.join(root, "benchmark")

  def h7(c):
    c["model"]["resolution"] = 64
    c["serve"]["output_resolution"] = 64
    vc = c["train"]["data"]["voxelization_config"]
    vc["resolution"] = {"depth": 64, "height": 64, "width": 64}
    c["train"]["data"]["data_loader"].update(
        batch_size=2, num_data_workers=2, worker_processes=False)

  def y1(c):
    c["serve"]["output_resolution"] = 64

  def train(t):
    t.update(meshes=8, scenes=min(t["scenes"] // 50, 48), image_hw=64,
             warmup_steps=3, triangles=[512, 2048])

  def serve(t):
    t.update(batch=2, image_hw=64, image_pool=2, sample=2, sample_from=3,
             warmup_requests=1)

  _edit(os.path.join(b, "configs", "h7.json"), h7)
  _edit(os.path.join(b, "configs", "y1.json"), y1)
  for name in os.listdir(os.path.join(b, "traffic")):
    _edit(os.path.join(b, "traffic", name),
          train if name.startswith("train_") else serve)


def copy_benchmark(dest: str) -> str:
  """BENCHMARK.json and the benchmark's folder copied under `dest`, with
  the measured package linked beside them."""
  os.makedirs(dest, exist_ok=True)
  shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
  shutil.copytree(os.path.join(REPO, "benchmark"),
                  os.path.join(dest, "benchmark"),
                  ignore=shutil.ignore_patterns("__pycache__"))
  os.symlink(os.path.join(REPO, "corenet_tpu_torch"),
             os.path.join(dest, "corenet_tpu_torch"))
  return dest


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
  """A shrunk copy of the benchmark; temporary files go under tmp_path."""
  root = copy_benchmark(str(tmp_path / "checkout"))
  shrink(root)
  monkeypatch.setenv("TMPDIR", str(tmp_path))
  import tempfile
  monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
  return root


def run_cell(root, argv, capsys):
  """Runs benchmark/run.py's main on the CPU in this process; returns
  (exit code, the last line of standard output parsed, standard error)."""
  from benchmark import run
  code = run.main(argv, root=root, device="cpu")
  out, err = capsys.readouterr()
  lines = out.strip().splitlines()
  return code, (json.loads(lines[-1]) if lines else None), err
