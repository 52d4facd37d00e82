"""Small helpers shared across the port (numpy, host side).

The port's own copy of corenet_tpu/utils/misc.py: round_up,
dynamic_tile_np, safe_div, and the training loop's triggers TimedEvent,
StepEvent and Eta.
"""

from __future__ import annotations

import datetime

import numpy as np


def dynamic_tile_np(partition_lengths: np.ndarray) -> np.ndarray:
  """Returns [0]*len[0] + [1]*len[1] + ... as one int32 vector."""
  partition_lengths = np.asarray(partition_lengths, np.int64)
  return np.repeat(
      np.arange(len(partition_lengths), dtype=np.int32),
      partition_lengths)


def safe_div(x, y):
  """x/y where y != 0, else 0."""
  return np.where(y != 0, x / np.where(y == 0, 1, y), 0)


def round_up(n: int, div: int) -> int:
  """Rounds n up to the nearest multiple of div."""
  return ((n + div - 1) // div) * div


class TimedEvent:
  """Rate-limits an event by wall-clock interval."""

  def __init__(self, interval_sec: float):
    self.last_trigger_time = datetime.datetime.min
    self.interval_sec = interval_sec

  def trigger(self) -> bool:
    cur_time = datetime.datetime.now()
    delta = (cur_time - self.last_trigger_time).total_seconds()
    if delta > self.interval_sec:
      self.last_trigger_time = cur_time
      return True
    return False

  def __repr__(self):
    return f"{type(self).__name__}@{self.interval_sec}s"


class StepEvent:
  """Semi-regular step-interval trigger.

  trigger(prev, next) fires iff an integer K >= 0 exists with
  prev_step < start_step + K * interval + 0.5 < next_step. Global steps
  advance by the batch size each iteration, so a scheduled event fires at
  the end of the iteration that crosses its step.
  """

  def __init__(self, start_step: int, interval: int):
    self.start_step = start_step
    self.interval = interval

  def trigger(self, prev_step: int, next_step: int) -> bool:
    if next_step < self.start_step:
      return False
    if prev_step < self.start_step:
      return True
    prev_rep = (prev_step - self.start_step) // self.interval
    next_rep = (next_step - self.start_step) // self.interval
    return prev_rep != next_rep

  def __repr__(self):
    return f"{type(self).__name__}@{self.start_step}+{self.interval}N"


class Eta:
  """Estimates remaining wall-clock time from step progress."""

  def __init__(self, start: int, total: int):
    self.start = start
    self.total = total
    self.start_time = datetime.datetime.now()

  def cur_eta_sec(self, current: int) -> float:
    cur_time = datetime.datetime.now()
    sec_per_it = ((cur_time - self.start_time).total_seconds() /
                  max(current - self.start, 1))
    return sec_per_it * (self.total - current)

  def cur_eta_str(self, current: int) -> str:
    s = int(self.cur_eta_sec(current))
    return f"{s // 86400}d:{s % 86400 // 3600}h:{s % 3600 // 60}m:{s % 60}s"
