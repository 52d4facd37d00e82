"""Disk use of the port's tests that save training states.

A `.cpt` of the tests' CoreNets is 421 MB even at 32³ (the ResNet-50 and
the decoder keep their widths, and Adam adds two moments), and pytest
keeps the temporary directories of its last three runs. So the fixtures
and tests that train or save states use these helpers:

- `newest_state_only(root)`: while it is open, each state that the
  port's `CheckpointManager` saves empties the older `.cpt` files of the
  same checkpoint directory (a step saved in both tiers keeps both).
  Their names stay, for the tests that list the names a run wrote; their
  bytes go. On exit it removes every saved state under `root`.
- `remove_saved_states(root)`: removes the `.cpt` and `.cpt.tmp` files
  and the rank pickles (tests/test_torch_distributed.py::run_ranks)
  under `root`.
- `remove_states_after_each_test`: an autouse fixture for a test module
  to import; it removes the saved states under each test's `tmp_path`
  once the test is done.
"""

import contextlib
import glob
import os

import pytest
import torch

SAVED_STATE_PATTERNS = ("*.cpt", "*.cpt.tmp", "*.pkl")


def saved_states(root):
  """The paths under `root` that `remove_saved_states` removes."""
  return sorted(path for pattern in SAVED_STATE_PATTERNS
                for path in glob.glob(os.path.join(str(root), "**", pattern),
                                      recursive=True))


def remove_saved_states(root) -> None:
  """Removes the saved states under `root`."""
  for path in saved_states(root):
    os.unlink(path)


def empty_older_states(cpt_dir, newest) -> None:
  """Truncates every `.cpt` under `cpt_dir` to 0 bytes but those of
  `newest`'s step (a run may save one step in both tiers, and a reader
  takes either)."""
  for path in glob.glob(os.path.join(str(cpt_dir), "**", "*.cpt"),
                        recursive=True):
    if os.path.basename(path) != os.path.basename(newest):
      os.truncate(path, 0)


def empty_older_states_on_save():
  """Makes each save of the port's CheckpointManager empty the older
  states of its directory; returns a function that undoes it."""
  from corenet_tpu_torch.train.checkpoint import CheckpointManager
  real = CheckpointManager.save_state

  def save_state(self, *args, **kwargs):
    path = real(self, *args, **kwargs)
    empty_older_states(self.cpt_dir, path)
    return path

  CheckpointManager.save_state = save_state
  return lambda: setattr(CheckpointManager, "save_state", real)


@contextlib.contextmanager
def newest_state_only(root):
  undo = empty_older_states_on_save()
  try:
    yield
  finally:
    undo()
    remove_saved_states(root)


@pytest.fixture(autouse=True)
def remove_states_after_each_test(request):
  yield
  tmp_path = request.node.funcargs.get("tmp_path")
  if tmp_path is not None:
    remove_saved_states(tmp_path)


def test_only_the_newest_state_keeps_its_bytes(tmp_path):
  from corenet_tpu_torch.train.checkpoint import CheckpointManager
  from corenet_tpu_torch.train.state import create_train_state
  state = create_train_state(torch.nn.Linear(3, 2), device="cpu")
  manager = CheckpointManager(str(tmp_path / "cpt"))
  with newest_state_only(tmp_path):
    for step, persistent, kept in (
        (0, False, ["temp/state_000000000.cpt"]),
        (4, True, ["persistent/state_000000004.cpt"]),
        (8, False, ["temp/state_000000008.cpt"]),
        (8, True, ["persistent/state_000000008.cpt",
                   "temp/state_000000008.cpt"])):
      manager.save_state(state.__class__(state.model, state.optimizer, step),
                         {}, persistent=persistent)
      sizes = {os.path.relpath(p, str(tmp_path / "cpt")): os.path.getsize(p)
               for p in manager.list_checkpoints()}
      assert sorted(n for n, size in sizes.items() if size) == kept
    assert sorted(sizes) == ["persistent/state_000000004.cpt",
                             "persistent/state_000000008.cpt",
                             "temp/state_000000000.cpt",
                             "temp/state_000000008.cpt"]
    assert manager.read_last_checkpoint()[0].global_step == 8
    (tmp_path / "rank0.pkl").write_bytes(b"x")
    (tmp_path / "cpt" / "temp" / "state_000000012.cpt.tmp").write_bytes(b"")
  assert saved_states(tmp_path) == []
  assert CheckpointManager.save_state.__name__ == "save_state"
  assert CheckpointManager.save_state.__qualname__ == (
      "CheckpointManager.save_state")
