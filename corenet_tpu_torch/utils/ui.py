"""Progress reporting and logging for runs of several processes.

Counterpart of corenet_tpu/utils/ui.py. Every process logs to its own
file, <out>/logs/worker_<rank>.log, in one rank-tagged format
(`I<ts> W:<rank> file:line]`), and process 0 also to the console.
Progress is a periodic rate line with a unicode bar (safe where the
output is not a terminal). `WorkerProgress` gives rank 0 a view of every
worker: each rank writes a JSON heartbeat file under <out>/progress/ on
a throttle, and rank 0 renders one bar per worker from the files it
finds, so no rank waits on another and a stalled worker shows as a stale
heartbeat. Ranks come from parallel/mesh.py.
"""

from __future__ import annotations

import datetime
import json
import logging
import sys
import time
from typing import Iterable, Iterator, Optional

from corenet_tpu_torch.parallel import mesh
from corenet_tpu_torch.utils import fs

_BLOCKS = " ▏▎▍▌▋▊▉█"


def _bar(fraction: float, width: int = 10) -> str:
  fraction = min(max(fraction, 0.0), 1.0)
  cells = fraction * width
  full = int(cells)
  frac = int((cells - full) * (len(_BLOCKS) - 1))
  return ("█" * full + (_BLOCKS[frac] if full < width else "") +
          " " * (width - full - 1))[:width]


class _RankFormatter(logging.Formatter):

  def __init__(self, rank: int):
    super().__init__()
    self.rank = rank

  def format(self, record: logging.LogRecord) -> str:
    ts = datetime.datetime.fromtimestamp(record.created)
    prefix = (f"{record.levelname[0]}{ts:%m%d %H:%M:%S}."
              f"{int(record.msecs):03d} W:{self.rank} "
              f"{record.filename}:{record.lineno}]")
    return f"{prefix} {record.getMessage()}"


def initialize_logging(output_dir: Optional[str] = None,
                       rank: Optional[int] = None,
                       level=logging.INFO) -> None:
  """Rank-tagged logging: a file per process, and the console on rank 0."""
  if rank is None:
    rank = mesh.process_index()
  root = logging.getLogger()
  root.setLevel(level)
  for handler in list(root.handlers):
    root.removeHandler(handler)
    handler.close()
  formatter = _RankFormatter(rank)
  if rank == 0:
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(formatter)
    root.addHandler(console)
  if output_dir:
    fs.makedirs(fs.join(output_dir, "logs"))
    fh = logging.FileHandler(
        fs.join(output_dir, "logs", f"worker_{rank}.log"))
    fh.setFormatter(formatter)
    root.addHandler(fh)


class Progress:
  """Wraps an iterable; logs one line every `interval_sec` seconds."""

  def __init__(self, iterable: Iterable, total: Optional[int] = None,
               desc: str = "", interval_sec: float = 10.0,
               log: Optional[logging.Logger] = None):
    self.iterable = iterable
    self.total = total if total is not None else _try_len(iterable)
    self.desc = desc
    self.interval_sec = interval_sec
    self.log = log or logging.getLogger(__name__)

  def __iter__(self) -> Iterator:
    start = time.time()
    last = start
    for i, item in enumerate(self.iterable):
      yield item
      now = time.time()
      if now - last >= self.interval_sec:
        last = now
        rate = (i + 1) / max(now - start, 1e-9)
        if self.total:
          eta = (self.total - i - 1) / max(rate, 1e-9)
          self.log.info("%s |%s| %d/%d (%.1f/s, eta %ds)", self.desc,
                        _bar((i + 1) / self.total), i + 1, self.total, rate,
                        int(eta))
        else:
          self.log.info("%s %d (%.1f/s)", self.desc, i + 1, rate)


def _try_len(iterable) -> Optional[int]:
  try:
    return len(iterable)
  except TypeError:
    return None


class WorkerProgress:
  """Rank 0's view of every worker's progress, through heartbeat files
  under <output_dir>/progress/: each rank `report`s on a throttle, and
  rank 0 also logs one bar line per worker."""

  def __init__(self, output_dir: str, desc: str = "",
               interval_sec: float = 30.0,
               rank: Optional[int] = None,
               num_ranks: Optional[int] = None,
               log: Optional[logging.Logger] = None):
    self.rank = mesh.process_index() if rank is None else rank
    self.num_ranks = mesh.process_count() if num_ranks is None else num_ranks
    self.desc = desc
    self.interval_sec = interval_sec
    self.log = log or logging.getLogger(__name__)
    self.dir = fs.join(output_dir, "progress")
    fs.makedirs(self.dir)
    self._start = time.time()
    self._last = 0.0

  def _path(self, rank: int) -> str:
    return fs.join(self.dir, f"worker_{rank}.json")

  def report(self, current: int, total: Optional[int] = None,
             note: str = "", force: bool = False) -> None:
    """Writes this worker's heartbeat; rank 0 also renders the view."""
    now = time.time()
    if not force and now - self._last < self.interval_sec:
      return
    self._last = now
    rate = current / max(now - self._start, 1e-9)
    fs.write_text(self._path(self.rank), json.dumps({
        "rank": self.rank, "current": int(current),
        "total": None if total is None else int(total),
        "note": note, "time": now, "rate": rate}))
    if self.rank == 0:
      self.render()

  def render(self) -> None:
    """Logs one progress line per worker."""
    now = time.time()
    lines = []
    for r in range(self.num_ranks):
      rec = None
      if fs.exists(self._path(r)):
        try:
          rec = json.loads(fs.read_text(self._path(r)))
        except ValueError:  # read while its worker wrote it
          pass
      if rec is None:
        lines.append(f"W{r} |{_bar(0.0)}| (no heartbeat)")
        continue
      cur, total = rec.get("current", 0), rec.get("total")
      age = now - rec.get("time", now)
      stale = f" STALE {int(age)}s" if age > 3 * self.interval_sec else ""
      note = f" {rec['note']}" if rec.get("note") else ""
      if total:
        lines.append(f"W{r} |{_bar(cur / total)}| {cur}/{total} "
                     f"({rec.get('rate', 0.0):.2f}/s){note}{stale}")
      else:
        lines.append(f"W{r} {cur} ({rec.get('rate', 0.0):.2f}/s)"
                     f"{note}{stale}")
    self.log.info("%s workers:\n  %s", self.desc, "\n  ".join(lines))
