"""The four-card driver's rank protocol (benchmark/drivers/train_dp.py) over
gloo with 2 ranks on the CPU, with a stand-in for the program's steps
that, like the program's check of equal batches, meets the other rank on
the host once a step: both ranks stop on the step that rank 0 posts, and a
rank killed mid-run makes rank 0's process exit non-zero within seconds
instead of hanging."""

import json
import os
import signal
import subprocess
import sys
import time

from benchmark.drivers import train_dp
from benchmark.tests.bench_fixtures import REPO

WINDOW_S = 1.0


def _steps(kill_at=None):
  """Steps that meet the other ranks on the host; the rank kills itself
  before step `kill_at`."""
  import torch
  from torch import distributed as dist
  done = 0
  while True:
    if kill_at is not None and done == kill_at:
      os.kill(os.getpid(), signal.SIGKILL)
    dist.all_reduce(torch.ones(1))
    time.sleep(0.01)
    done += 1
    yield done


def _join(rank, world, ports):
  from torch import distributed as dist
  train_dp._environ(rank, world, ports[0])
  dist.init_process_group("gloo", init_method="env://", rank=rank,
                          world_size=world)
  return train_dp.store(rank, world, ports[1])


def follower(rank, world, ports, payload):
  """A child rank: steps until rank 0's stop, then writes its count."""
  train_dp._watch_parent()
  board = _join(rank, world, ports)
  done = train_dp.follow(_steps(payload["kill_at"]), 0, board)
  with open(os.path.join(payload["out"], f"rank{rank}.json"), "w") as f:
    json.dump(done, f)


def leader(out: str, kill_at) -> None:
  """Rank 0: starts rank 1, steps for WINDOW_S, posts the stop, makes the
  extra step and waits for rank 1's end."""
  ranks = train_dp.Ranks(2)
  ranks.start(follower, {"out": out, "kill_at": kill_at})
  board = _join(0, 2, ranks.ports)
  steps = _steps()
  done = 0
  t0 = time.perf_counter()
  while time.perf_counter() - t0 < WINDOW_S:
    next(steps)
    done += 1
  stop = train_dp.post_stop(board, done)
  ranks.stopped()
  for _ in range(stop - done):
    next(steps)
  ranks.end()
  with open(os.path.join(out, "rank0.json"), "w") as f:
    json.dump(stop, f)


def _run_leader(out, kill_at=None):
  script = ("import sys; sys.path.insert(0, %r); "
            "from benchmark.tests.test_bench_dp import leader; "
            "leader(%r, %r)" % (REPO, str(out), kill_at))
  t0 = time.monotonic()
  done = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                        capture_output=True, text=True, timeout=120)
  return done, time.monotonic() - t0


def test_both_ranks_stop_on_rank_zeros_step(tmp_path):
  done, _ = _run_leader(tmp_path)
  assert done.returncode == 0, done.stderr[-3000:]
  counts = [json.load(open(tmp_path / f"rank{r}.json")) for r in (0, 1)]
  assert counts[0] == counts[1] > 1, counts


def test_a_killed_rank_ends_the_run_with_an_error(tmp_path):
  done, seconds = _run_leader(tmp_path, kill_at=3)
  # The watchdog's exit, or the group's error in rank 0's step, whichever
  # comes first.
  assert done.returncode != 0, done.stderr[-3000:]
  assert seconds < 60
  assert not os.path.exists(tmp_path / "rank0.json")
