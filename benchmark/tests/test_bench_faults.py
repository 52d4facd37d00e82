"""Runs of the shrunk benchmark on the CPU with the timed path broken
underneath (the card's look skipped): each fault that a cell can have
turns `correct` false, and the sound run of the same seed is correct.
The controls' readings come out over the cells' limits."""

import pytest
import torch

from benchmark.harness.spec import Spec

from benchmark.tests.bench_fixtures import run_cell, tiny_root  # noqa: F401


def _broken_steps(monkeypatch, fault):
  """Wraps the program's training step with `fault`."""
  from corenet_tpu_torch.train import step as step_lib
  make = step_lib.make_train_step

  def make_broken(model, optimizer, *args, **kwargs):
    step = make(model, optimizer, *args, **kwargs)

    def broken(state, batch):
      if fault == "unchanged":
        saved = [p.detach().clone() for p in model.parameters()]
        new_state, metrics = step(state, batch)
        with torch.no_grad():
          for p, s in zip(model.parameters(), saved):
            p.copy_(s)
        return new_state, metrics
      if fault == "half_batch":
        half = batch["image"].shape[0] // 2
        return step(state, {k: v[:half] for k, v in batch.items()})
      new_state, metrics = step(state, batch)  # "loss_altered"
      return new_state, {"loss": metrics["loss"] * 1.01}

    return broken

  monkeypatch.setattr(step_lib, "make_train_step", make_broken)


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch",
                                   "loss_altered"])
def test_training_faults_fail(tiny_root, capsys, monkeypatch, fault):
  if fault:
    _broken_steps(monkeypatch, fault)
  code, line, _ = run_cell(tiny_root, [
      "--workload", "h7.train.device_gt", "--seed", "4000000001",
      "--seconds", "1", "--trace", "0"], capsys)
  assert code == 0
  assert line["correct"] is (fault is None), line["checks"]


@pytest.mark.parametrize("fault", [None, "altered"])
@pytest.mark.parametrize("cell", ["h7.serve", "y1.serve"])
def test_serving_faults_fail(tiny_root, capsys, monkeypatch, fault, cell):
  if fault:
    from corenet_tpu_torch.eval import super_resolution as sr
    call = sr.SuperResolutionInference.__call__

    def altered(self, *args, **kwargs):
      pmf = call(self, *args, **kwargs).clone()
      pmf[0, 0, 0, 0] = 0.0
      return pmf

    monkeypatch.setattr(sr.SuperResolutionInference, "__call__", altered)
  code, line, _ = run_cell(tiny_root, [
      "--workload", cell, "--seed", "4000000002", "--seconds", "1",
      "--trace", "0"], capsys)
  assert code == 0
  assert line["correct"] is (fault is None), line["checks"]


@pytest.mark.parametrize("cell,argv", [
    ("h7.serve", ["--control", "1"]),
    ("y1.serve", ["--control", "1"]),
    ("h7.train.device_gt", ["--control", "1"]),
    ("h7.train.device_gt", ["--fault", "half_batch"]),
])
def test_controls_and_planted_faults_read_over_the_limits(
    tiny_root, capsys, cell, argv):
  limits = Spec(tiny_root).workload(cell)["limits"]
  code, line, _ = run_cell(tiny_root, [
      "--workload", cell, "--seed", "4000000003", "--seconds", "1"] + argv,
      capsys)
  assert code == 0
  readings = line["control" if argv[0] == "--control" else argv[1]]
  assert any(readings[k] > limit for k, limit in limits.items()), readings


def test_the_one_ulp_witness_prints_the_look(tiny_root, capsys):
  """The rounding's own reach: the reference from weights one ulp apart,
  its compared numbers and the look at its change, printed."""
  limits = Spec(tiny_root).workload("h7.train.device_gt")["limits"]
  code, line, err = run_cell(tiny_root, [
      "--workload", "h7.train.device_gt", "--seed", "4000000005",
      "--seconds", "1", "--fault", "one_ulp"], capsys)
  assert code == 0 and "look: widest gap" in err
  assert "sign differs between the sides" in err
  readings = line["one_ulp"]
  assert set(limits) <= set(readings)
  assert all(0 < v < float("inf") for v in readings.values()), readings
