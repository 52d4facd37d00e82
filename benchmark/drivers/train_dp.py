"""Data-parallel training driver: benchmark/drivers/train.py's loop on
`chips` ranks, one card each, as the train CLI runs under torchrun: every
rank builds the same `TrainPipeline` (under more than one process: each
rank's contiguous shard of the epoch, BatchRenorm's statistics and the
loss over the global batch, one gradient all-reduce a step, the static
6-round fill) with the same seeded weights.

Set-up writes the dataset once, sets rank 0's RANK, WORLD_SIZE,
LOCAL_RANK and MASTER_* in this process, and starts ranks 1 and up as
child processes (`run.py::_join_children` reaps them). Every rank joins
the group and runs the warm-up steps; rank 0 keeps its first steps'
numbers as the training driver does.

The window is rank 0's: it steps for its seconds, then posts to a store
of its own (a TCPStore beside the group's) the number of steps it will
have made, one more than it made in the window. The other ranks read the
store before each step without waiting and stop when they have made that
many steps; the program's own host check of equal batches in every step
keeps the ranks within a step of each other, so no rank has passed the
number when it reads it. Rank 0 makes the extra step after the window
(outside its time and its trace), then waits for the ranks to end.

Every wait has a timeout: a watchdog thread in rank 0 ends the run with
exit code 1 when a rank ends before the stop or a phase outlasts its
time, and one in every other rank ends that rank when rank 0 is gone. So
a dead or stuck rank makes the run exit non-zero; it never hangs. No rank
tears its process group down, which NCCL may make a wait for every rank:
the other ranks end their processes after the stop, and rank 0 keeps its
group through the check.

`train_scenes_per_s` counts the global batch: the window's steps × the
batch × the ranks. `correct`: rank 0's first-step loss and the median
leaf's gradient and change, all of them the global batch's, against the
reference (benchmark/reference/train.py) on global batches: the ranks'
k-th batches of their shards, concatenated in rank order, so that the
reference's BatchRenorm statistics are the global batch's.
"""

from __future__ import annotations

import atexit
import multiprocessing
import os
import socket
import sys
import threading
import time
from datetime import timedelta
from typing import Callable, Dict, List

import numpy as np
import torch

from benchmark.drivers import train as single
from benchmark.drivers.train import (
    FOLLOWED, State, _batch, _release, _scene, _spec, _sync, gaps)
from benchmark.harness import scenes, training, weights
from benchmark.reference import gt as ref_gt
from benchmark.reference import model as ref
from benchmark.reference import precision
from benchmark.reference import train as ref_train

TIMEOUT_S = 600.0  # the longest set-up, or the window's close, may take
END_TIMEOUT_S = 120.0  # from rank 0's extra step to every rank's end
POLL_S = 0.5
STOP = "stop"


def _free_port() -> int:
  with socket.socket() as s:
    s.bind(("localhost", 0))
    return s.getsockname()[1]


def _environ(rank: int, world: int, port: int) -> None:
  os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                    LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                    MASTER_PORT=str(port))


def store(rank: int, world: int, port: int):
  """The stop's store: a TCPStore that rank 0 serves."""
  from torch import distributed as dist
  return dist.TCPStore("localhost", port, world, is_master=rank == 0,
                       timeout=timedelta(seconds=TIMEOUT_S))


def follow(steps, done: int, board) -> int:
  """A rank other than 0: steps while rank 0 has posted no stop, or
  fewer steps than it posted are done; returns the steps done."""
  while True:
    if board.check([STOP]) and done >= int(board.get(STOP)):
      return done
    next(steps)
    done += 1


def post_stop(board, done: int) -> int:
  """Rank 0 after its window: posts the steps it will have made, one
  more than `done`; returns that count."""
  board.set(STOP, str(done + 1))
  return done + 1


class Ranks:
  """Rank 0's children and its watchdog: `start` them, `expect` a phase
  within its seconds, `end` them after the stop."""

  def __init__(self, world: int):
    self.world = world
    self.ports = (_free_port(), _free_port())
    self.children: List = []
    self._deadline = time.monotonic() + TIMEOUT_S
    self._stopped = False
    self._ended = threading.Event()

  def start(self, entry: Callable, payload) -> None:
    spawn = multiprocessing.get_context("spawn")
    for rank in range(1, self.world):
      p = spawn.Process(target=entry, args=(rank, self.world, self.ports,
                                            payload), name=f"rank{rank}")
      p.start()
      self.children.append(p)
    atexit.register(self._terminate)
    threading.Thread(target=self._watch, daemon=True).start()

  def expect(self, seconds: float) -> None:
    self._deadline = time.monotonic() + seconds

  def stopped(self) -> None:
    """The stop is posted: from now a rank may end, with exit code 0."""
    self._stopped = True

  def _watch(self) -> None:
    while not self._ended.wait(POLL_S):
      gone = [p for p in self.children if p.exitcode is not None
              and (p.exitcode != 0 or not self._stopped)]
      late = time.monotonic() > self._deadline
      if gone or late:
        why = (f"{gone[0].name} ended with exit code {gone[0].exitcode}"
               if gone else "a phase outlasted its time")
        print(f"train_dp: {why}; the run ends", file=sys.stderr, flush=True)
        self._terminate()
        os._exit(1)

  def end(self) -> None:
    """After the stop: waits for every rank to end with exit code 0."""
    for p in self.children:
      p.join(max(self._deadline - time.monotonic(), 0.0))
    bad = [p for p in self.children if p.exitcode != 0]
    self._ended.set()
    if bad:
      self._terminate()
      raise RuntimeError(f"{bad[0].name} ended with exit code "
                         f"{bad[0].exitcode}")

  def _terminate(self) -> None:
    for p in self.children:
      if p.is_alive():
        p.kill()
        p.join(5)


def _watch_parent() -> None:
  """In a child rank: ends it when rank 0 is gone."""
  parent = multiprocessing.parent_process()

  def watch():
    parent.join()
    print("train_dp: rank 0 is gone; this rank ends", file=sys.stderr,
          flush=True)
    os._exit(1)

  threading.Thread(target=watch, daemon=True).start()


class _Ctx:
  """A child rank's view of the run's context."""

  def __init__(self, payload: Dict, device):
    self.__dict__.update(payload)
    self.device = device

  def mark(self, phase: str) -> None:
    pass


def _start(ctx, rank: int, world: int, ports, data_dir: str) -> State:
  """Joins the group and builds and warms this rank's pipeline; rank 0
  keeps the first steps' numbers (harness/training.py)."""
  from corenet_tpu_torch.parallel import mesh
  _environ(rank, world, ports[0])
  device = mesh.initialize(device=ctx.device)
  s = State()
  s.ctx = ctx
  s.rank, s.world = rank, world
  s.data_dir = data_dir
  training.pipeline(s, data_dir, os.path.join(ctx.scratch, f"out{rank}"),
                    device)
  ctx.mark(f"rank {rank}: pipeline and weights")
  s.board = store(rank, world, ports[1])
  training.warm(s, keep=rank == 0)
  s.done = ctx.traffic["warmup_steps"]
  _sync(device)
  return s


def rank_main(rank: int, world: int, ports, payload) -> None:
  """A child rank: set-up, then steps until rank 0's stop."""
  _watch_parent()
  device = (torch.device("cuda", rank) if payload["device"] == "cuda"
            else torch.device(payload["device"]))
  s = _start(_Ctx(payload["ctx"], device), rank, world, ports,
             payload["data_dir"])
  done = follow(s.steps, s.done, s.board)
  s.steps.close()
  print(f"train_dp: rank {rank} stopped after {done} steps", file=sys.stderr,
        flush=True)
  # Without the group's teardown, which may wait for every rank (rank 0
  # keeps its group for the check): the process ends here.
  sys.stdout.flush()
  os._exit(0)


def setup(ctx) -> State:
  world = ctx.chips
  data_dir = os.path.join(ctx.scratch, "data")
  scenes.write_dataset(data_dir, ctx.traffic, ctx.seed)
  ctx.mark("dataset")
  ranks = Ranks(world)
  from benchmark.drivers import train_dp  # importable by the children
  keep = ("cell", "config", "traffic", "seed", "chips", "scratch")
  ranks.start(train_dp.rank_main, {
      "ctx": {k: getattr(ctx, k) for k in keep},
      "device": ctx.device.type, "data_dir": data_dir})
  s = _start(ctx, 0, world, ranks.ports, data_dir)
  s.ranks = ranks
  return s


def _collectives() -> int:
  from corenet_tpu_torch.utils import tracing
  return tracing.counters()["mesh.collectives"]


def window(s: State, seconds: float) -> Dict:
  s.ranks.expect(seconds + TIMEOUT_S)
  before = _collectives()
  result = single.window(s, seconds)
  s.collectives = _collectives() - before
  s.done += result["steps"]
  s.stop = post_stop(s.board, s.done)
  s.ranks.stopped()
  result["e2e"]["train_scenes_per_s"] *= s.world
  print(f"window: {s.world} ranks, global scenes/s "
        f"{result['e2e']['train_scenes_per_s']:.3f}", file=sys.stderr)
  return result


def counts(s: State, result: Dict) -> Dict:
  """drivers/train.py's counts of rank 0's batches, and the collectives
  that rank 0 issued in the window."""
  return dict(single.counts(s, result), collectives=s.collectives)


def _end(s: State) -> None:
  """The extra step after the window, then the ranks' end."""
  s.ranks.expect(END_TIMEOUT_S)
  for _ in range(s.stop - s.done):
    next(s.steps)
  _sync(s.ctx.device)
  s.ranks.end()
  _release(s)


def _global_batches(ctx, world: int, steps: range) -> List[np.ndarray]:
  """The global batch of each step: rank r's k-th batch is scenes
  [k·b, (k+1)·b) of its contiguous shard of the epoch's order
  (data/loader.py::distributed_indices), concatenated in rank order."""
  n = ctx.traffic["scenes"]
  order = ref_gt.epoch_order(n)
  per = -(-n // world)
  b = _batch(ctx)
  return [np.concatenate([order[r * per + k * b:r * per + (k + 1) * b]
                          for r in range(world)]) for k in steps]


def _reference(ctx, data_dir: str, p0, world: int, low=None, keep: int = 0,
               trail: bool = False) -> Dict:
  """The reference's three steps on the first global batches; `keep` > 0
  keeps that many scenes of each (a fault: the rest left out)."""
  m = ctx.config["model"]
  res = m["resolution"]
  vc = ctx.config["train"]["data"]["voxelization_config"]
  irm = vc["voxelization_image_resolution_multiplier"]
  batches = []
  for batch in _global_batches(ctx, world, range(FOLLOWED)):
    items = [_scene(data_dir, i) for i in batch[:keep or None]]
    batches.append({
        "image": torch.from_numpy(np.stack([x[0] for x in items])).to(
            ctx.device),
        "camera": torch.from_numpy(np.stack([x[1] for x in items])).to(
            ctx.device),
        "labels": ref_gt.fgbg_labels([x[2] for x in items], res, irm,
                                     ctx.device)})
  dtype = {"bfloat16": torch.bfloat16, "float32": None}[
      ctx.config["train_precision"]]
  train = ctx.config["train"]
  return ref_train.steps(p0, batches, (res,) * 3,
                         train["initial_learning_rate"],
                         train["adam_epsilon"], ref.Precision(dtype, low),
                         trail)


def check(s: State):
  _end(s)
  return training.compare(s, _reference(s.ctx, s.data_dir, s.weights,
                                        s.world, trail=True))


def _data(ctx) -> str:
  data_dir = os.path.join(ctx.scratch, "data")
  scenes.write_dataset(data_dir, ctx.traffic, ctx.seed)
  return data_dir


def control(ctx) -> Dict:
  """The reference one precision down (fp8 operands for bf16) in the
  program's place, against the reference, on the global batches."""
  data_dir = _data(ctx)
  p0 = weights.make(_spec(ctx), ctx.seed, ctx.device)
  want = _reference(ctx, data_dir, p0, ctx.chips)
  return gaps(_reference(ctx, data_dir, p0, ctx.chips, low=precision.fp8),
              want)


def fault(ctx, name: str) -> Dict:
  """The reference with a planted fault in the program's place, against
  the reference, on the global batches: 'half_batch' leaves half of each
  global batch out; 'one_ulp' plants none, the reference from initial
  weights one ulp above (the rounding's own reach)."""
  if name not in ("half_batch", "one_ulp"):
    raise ValueError(f"the data-parallel driver plants no fault {name!r}")
  data_dir = _data(ctx)
  p0 = weights.make(_spec(ctx), ctx.seed, ctx.device)
  world = ctx.chips
  if name == "one_ulp":
    return training.one_ulp(
        lambda p, trail: _reference(ctx, data_dir, p, world, trail=trail), p0)
  want = _reference(ctx, data_dir, p0, world)
  return gaps(_reference(ctx, data_dir, p0, world,
                         keep=_batch(ctx) * world // 2), want)
