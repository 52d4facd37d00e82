"""Interior flood fill of dense voxel grids, as tensor code.

Counterpart of corenet_tpu/voxel/fill.py, with the semantics of the
reference's connected-components ops (fill_voxels_cpu.cc:74-155): empty
regions (value ≤ 0) that do not touch the grid's boundary are inside and
get filled; the output is binary, 1 for occupied-or-inside voxels and 0
for empty space connected to the boundary, in the input's dtype.

The empty region connected to the boundary ("outside") is computed by
morphological reconstruction: seed with the empty boundary voxels, then
propagate through empty voxels to a fixpoint. Each round runs 6
directional sweeps (±x, ±y, ±z), each the gated prefix-OR recurrence
    r[i] = empty[i] & (r[i−1] | seed[i])
through cumulative primitives, so one sweep resolves all straight-line
reachability along its direction; the rounds needed are the turns of the
most winding cavity, a handful for real meshes. voxel/packed.py holds the
same fill on bit-packed grids.
"""

from __future__ import annotations

from typing import Optional

import torch

# Rounds of the adaptive fill run in this process (the fixpoint reads one
# flag from the device per round).
round_count = 0


def _gated_prefix_or(seed: torch.Tensor, occupied_cumsum: torch.Tensor,
                     empty: torch.Tensor, axis: int,
                     reverse: bool) -> torch.Tensor:
  """r[i] = empty[i] & (r[i−1] | seed[i]) along `axis`.

  With c = cumsum(occupied) along the sweep direction, a cell i is reached
  iff some seed j precedes it with no occupied cell in between, i.e.
  c[j] == c[i]. Since c is monotone, that is cummax(where(seed, c, −1))
  reaching c[i]."""
  c = occupied_cumsum
  val = torch.where(seed, c, -1)
  if reverse:
    r = torch.cummax(val.flip(axis), dim=axis).values.flip(axis)
  else:
    r = torch.cummax(val, dim=axis).values
  return empty & (r == c)


def _sweep_state(empty: torch.Tensor):
  """The boundary seed and the one-round propagation function of bool
  [N, D, H, W] `empty` grids."""
  seed = torch.zeros_like(empty)
  for axis in (1, 2, 3):
    size = empty.shape[axis]
    idx = torch.arange(size, device=empty.device)
    shape = [1, 1, 1, 1]
    shape[axis] = size
    seed |= empty & ((idx == 0) | (idx == size - 1)).reshape(shape)

  # The directional occupancy cumsums do not change over the rounds.
  occ = (~empty).to(torch.int32)
  cums = {}
  for axis in (1, 2, 3):
    cums[(axis, False)] = torch.cumsum(occ, dim=axis, dtype=torch.int32)
    cums[(axis, True)] = torch.cumsum(
        occ.flip(axis), dim=axis, dtype=torch.int32).flip(axis)

  def round_fn(outside):
    for axis in (1, 2, 3):
      for reverse in (False, True):
        outside = outside | _gated_prefix_or(
            outside, cums[(axis, reverse)], empty, axis, reverse)
    return outside

  return seed, round_fn


def _outside_mask(empty: torch.Tensor,
                  fill_rounds: Optional[int] = None) -> torch.Tensor:
  """Empty voxels 6-connected to the grid's boundary through empty voxels.

  empty: bool[N, D, H, W]. fill_rounds: None runs rounds until one changes
  nothing (the adaptive fixpoint; each round reads one flag from the
  device, and adds one to `round_count`); an int runs exactly that many
  rounds."""
  global round_count
  seed, round_fn = _sweep_state(empty)
  outside = seed
  if fill_rounds is not None:
    for _ in range(fill_rounds):
      outside = round_fn(outside)
    return outside
  while True:
    new = round_fn(outside)
    round_count += 1
    changed = bool((new != outside).any())
    outside = new
    if not changed:
      return outside


@torch.no_grad()
def fill_inside_voxels(grid: torch.Tensor,
                       fill_rounds: Optional[int] = None) -> torch.Tensor:
  """Fills the interior empty regions of voxel grids.

  Args:
    grid: numeric[N, D, H, W]; a voxel is occupied iff > 0.
    fill_rounds: None = adaptive fixpoint; int = static round count.

  Returns:
    Binary grids in the input's dtype: 1 where occupied or enclosed, 0
    where empty and connected to the boundary.
  """
  if grid.dim() != 4:
    raise ValueError(f"grid must be [N, D, H, W], got {tuple(grid.shape)}")
  outside = _outside_mask(grid <= 0, fill_rounds)
  return (~outside).to(grid.dtype)


@torch.no_grad()
def static_rounds_converged(grid: torch.Tensor,
                            fill_rounds: int) -> torch.Tensor:
  """Whether `fill_rounds` static rounds reach the exact fill fixpoint on
  these grids, i.e. one further round changes nothing: a cavity with more
  turns than the static count silently under-fills, which this detects at
  the cost of one extra round. Returns a bool scalar tensor on the grid's
  device."""
  if grid.dim() != 4:
    raise ValueError(f"grid must be [N, D, H, W], got {tuple(grid.shape)}")
  seed, round_fn = _sweep_state(grid <= 0)
  outside = seed
  for _ in range(fill_rounds):
    outside = round_fn(outside)
  return ~(round_fn(outside) != outside).any()
