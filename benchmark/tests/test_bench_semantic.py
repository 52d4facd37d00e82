"""The semantic training cell, m9.train.device_gt, shrunk to 32³ on the
CPU: the program's run is correct, and the planted faults (half the batch
left out, two classes exchanged in the labels) read over its limits; its
span readers read the program's new spans and counter."""

import json
import os

import pytest
import torch

from benchmark.harness.spec import Spec
from benchmark.tests.bench_fixtures import run_cell, tiny_root  # noqa: F401

CELL = "m9.train.device_gt"


@pytest.fixture
def m9_root(tiny_root):
  path = os.path.join(tiny_root, "benchmark", "configs", "m9.json")
  with open(path) as f:
    c = json.load(f)
  c["model"]["resolution"] = 32
  c["train"]["data"]["voxelization_config"]["resolution"] = {
      "depth": 32, "height": 32, "width": 32}
  c["train"]["data"]["data_loader"].update(
      batch_size=2, num_data_workers=2, worker_processes=False)
  with open(path, "w") as f:
    json.dump(c, f)
  return tiny_root


def test_the_programs_run_is_correct_and_reads_its_spans(m9_root, capsys):
  code, line, err = run_cell(m9_root, [
      "--workload", CELL, "--seed", str(2 ** 32 + 11), "--seconds", "1",
      "--trace", "1"], capsys)
  assert code == 0 and line["correct"] is True, (line, err[-3000:])
  metrics = line["metrics"]
  assert metrics["mesh_slots.train"]["value"] == 2 * 3  # B·M a step
  assert metrics["label_merge_ms.train"]["value"] > 0
  assert metrics["semantic_loss_ms.train"]["value"] > 0
  assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap"}


def _broken_steps(monkeypatch, fault):
  """Wraps the program's training step with `fault`: half of each batch
  left out, or the classes of each scene's first two meshes exchanged."""
  from corenet_tpu_torch.train import step as step_lib
  make = step_lib.make_train_step

  def make_broken(*args, **kwargs):
    step = make(*args, **kwargs)

    def broken(state, batch):
      if fault == "half_batch":
        half = batch["image"].shape[0] // 2
        return step(state, {k: v[:half] for k, v in batch.items()})
      labels = batch["mesh_labels"].clone()
      labels[:, [0, 1]] = labels[:, [1, 0]]
      assert bool(torch.any(labels != batch["mesh_labels"]))
      return step(state, dict(batch, mesh_labels=labels))

    return broken

  monkeypatch.setattr(step_lib, "make_train_step", make_broken)


@pytest.mark.parametrize("fault", ["half_batch", "label_swap"])
def test_a_broken_program_is_not_correct(m9_root, capsys, monkeypatch,
                                         fault):
  _broken_steps(monkeypatch, fault)
  code, line, _ = run_cell(m9_root, [
      "--workload", CELL, "--seed", "4000000009", "--seconds", "1",
      "--trace", "0"], capsys)
  assert code == 0
  assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "label_swap"])
def test_planted_faults_read_over_the_limits(m9_root, capsys, fault):
  limits = Spec(m9_root).workload(CELL)["limits"]
  code, line, _ = run_cell(m9_root, [
      "--workload", CELL, "--seed", "4000000007", "--seconds", "1",
      "--fault", fault], capsys)
  assert code == 0
  readings = line[fault]
  assert any(readings[k] > limit for k, limit in limits.items()), readings
