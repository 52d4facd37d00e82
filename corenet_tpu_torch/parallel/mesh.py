"""Data parallelism over processes with torch.distributed.

Counterpart of corenet_tpu/parallel/mesh.py's 'data' axis. The JAX
package runs one SPMD program per host over a device mesh, and XLA
inserts the collectives; here one process drives one device (torchrun
starts them) and the code that needs a collective calls one:

- BatchRenorm's train-mode statistics and the losses' batch means are
  means over the global batch (`mean_over_ranks`): each rank reduces its
  shard, and an all-reduce whose backward is an all-reduce too
  (`all_reduce_sum`) joins the shards, so every rank computes the global
  statistics and the global loss, and its backward carries the other
  ranks' share of every gradient.
- So every rank's loss is the global loss L, and the ranks' gradients
  add up to world_size · dL/dθ. `all_reduce_gradients` sums them and
  divides by the world size: one all-reduce of the flattened gradients
  after the backward, and every rank takes the same Adam step.
- Host-side reductions (the eval's confusion matrix, the qualitative
  tiles, barriers and checks of equal shapes) go over a gloo group of
  CPU tensors, beside the device group (NCCL on cards): the pairing of
  NCCL and gloo in the original CoreNet's launcher.

Without a process group every function here is the one-process identity
(a count of 1, rank 0, no reduction), and callers take their one-process
path unchanged. With a group, the collectives run even at world size 1,
so one card runs the code path of N.

The 'space' axis (corenet_tpu/parallel/mesh.py's second one) shards the
decoder's depth: `create_mesh(data, space)` lays the ranks out as
data × space, space innermost (rank = data_index · space + space_index,
JAX's `reshape(data, space)`), with one process group per data index
holding its space ranks. The space ranks of a data group step on the same
batch, each on one depth slab of the decoder (models/decoder.py); the
convolutions read their neighbours' boundary slices through
`halo_exchange`, and the IoU losses sum each scene over the group
(`space_sum`, an all-reduce whose backward is the same all-reduce). The
halo exchange's backward is its adjoint, the same exchange in reverse, so
the rule above holds with world size data × space: every rank's loss is
the global loss, the encoder and the decoder's replicated stages give
every space rank the same values, and `all_reduce_gradients` over the
whole world is unchanged. The ground truth is shared over the space
group: each rank voxelizes its share of the scenes and the ranks trade
depth slabs (`space_all_to_all`, train/gt.py::space_shared). Without
`create_mesh` the layout is data = world size, space = 1.

The halos and the all-to-all travel as an all-reduce of a zeroed buffer
in which each rank fills its own slot: gloo takes CUDA tensors only in
all_reduce and broadcast, and NCCL refuses two ranks on one card, so this
one transport serves the CPU, one card with gloo ranks and several cards
with NCCL. It moves space times the bytes a neighbour needs; on four
NVLink H100s the backend's own point-to-point sends were slower at h7's
halos (PERF.md).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from corenet_tpu_torch.utils import tracing

log = logging.getLogger(__name__)

_host_group = None


@dataclasses.dataclass(frozen=True)
class Mesh:
  """The (data, space) layout of the process group (`create_mesh`)."""
  data: int
  space: int
  # This rank's space group; None when space is 1 (nothing to reduce).
  space_group: Any = None


_mesh: Optional[Mesh] = None


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None,
               device="cuda") -> torch.device:
  """Joins the process group and returns this process's device.

  Rank, world size and the rendezvous come from torchrun's environment
  (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT: init_method
  "env://") unless given. The backend defaults to NCCL for a CUDA device
  and gloo for the CPU; a CUDA device is `cuda:LOCAL_RANK`, made current
  before the group forms. A host group of gloo serves the CPU tensors.
  Every failure raises: no rank goes on alone. The layout is data only
  until `create_mesh` says otherwise."""
  global _host_group, _mesh
  if dist.is_initialized():
    raise RuntimeError("the process group is already initialized")
  device = local_device(device)
  if backend is None:
    backend = "nccl" if device.type == "cuda" else "gloo"
  if rank is None:
    rank = int(_environ("RANK"))
  if world_size is None:
    world_size = int(_environ("WORLD_SIZE"))
  if device.type == "cuda":
    torch.cuda.set_device(device)
  dist.init_process_group(backend=backend,
                          init_method=init_method or "env://",
                          rank=rank, world_size=world_size)
  _host_group = (dist.group.WORLD if backend == "gloo"
                 else dist.new_group(backend="gloo"))
  _mesh = None
  log.info("process %d of %d on %s (%s; host reductions over gloo)", rank,
           world_size, device, backend)
  return device


def shutdown() -> None:
  """Leaves the process group (a no-op without one)."""
  global _host_group, _mesh
  if dist.is_initialized():
    dist.destroy_process_group()
  _host_group = None
  _mesh = None


def _environ(name: str) -> str:
  value = os.environ.get(name)
  if value is None:
    raise RuntimeError(f"{name} is not set: start the processes with "
                       "torchrun, or pass rank and world_size")
  return value


def is_initialized() -> bool:
  return dist.is_initialized()


def process_count() -> int:
  return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
  return dist.get_rank() if dist.is_initialized() else 0


def create_mesh(data: Optional[int] = None, space: int = 1) -> Mesh:
  """Lays the processes out as data × space, space innermost, and makes
  it the layout that `data_count` and the others report; returns it.
  data × space must equal the world size (1 without a group); `data`
  defaults to world size / space. Every rank must call it, with the same
  arguments: each space group is a `dist.new_group`, and every rank
  creates every group in the same order."""
  global _mesh
  world = process_count()
  if space < 1 or (data is not None and data < 1):
    raise ValueError(f"mesh axes must be positive, got data={data}, "
                     f"space={space}")
  if data is None:
    if world % space:
      raise ValueError(f"space={space} does not divide the world size "
                       f"{world}")
    data = world // space
  if data * space != world:
    raise ValueError(f"data={data} × space={space} is not the world size "
                     f"{world}")
  group = None
  if space > 1:
    mine = process_index() // space
    for d in range(data):
      g = dist.new_group(list(range(d * space, (d + 1) * space)))
      if d == mine:
        group = g
  _mesh = Mesh(data, space, group)
  log.info("mesh: data %d × space %d", data, space)
  return _mesh


def data_count() -> int:
  return _mesh.data if _mesh is not None else process_count()


def space_count() -> int:
  return _mesh.space if _mesh is not None else 1


def data_index() -> int:
  return process_index() // space_count()


def space_index() -> int:
  return process_index() % space_count()


def local_device(device) -> torch.device:
  """A CUDA device without an index means this process's card,
  `cuda:LOCAL_RANK` (0 without torchrun), which must exist; any other
  device is returned as it is."""
  device = torch.device(device)
  if device.type != "cuda" or device.index is not None:
    return device
  index = int(os.environ.get("LOCAL_RANK", "0"))
  count = torch.cuda.device_count()
  if index >= count:
    raise RuntimeError(f"LOCAL_RANK {index} names cuda:{index}, but this "
                       f"machine has {count} CUDA device(s)")
  return torch.device("cuda", index)


def host_group():
  if _host_group is None:
    raise RuntimeError("no process group: call parallel.mesh.initialize()")
  return _host_group


def barrier(name: str) -> None:
  """Waits for every process (over the host group); a no-op alone."""
  if not dist.is_initialized():
    return
  log.debug("barrier %s", name)
  dist.barrier(group=host_group())


class _AllReduceSum(torch.autograd.Function):
  """The sum over the ranks of `group` (None: all); its backward is the
  sum over those ranks of the incoming gradients, the adjoint of the sum
  of every rank's copy."""

  @staticmethod
  def forward(ctx, x, group=None):
    ctx.group = group
    return _all_reduce(x.clone(memory_format=torch.contiguous_format), group)

  @staticmethod
  def backward(ctx, grad):
    return _all_reduce(grad.clone(memory_format=torch.contiguous_format),
                       ctx.group), None


def _all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
  tracing.count("mesh.collectives")
  dist.all_reduce(x, group=group)
  return x


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
  """The sum of `x` over ranks, differentiable; needs a group."""
  if not dist.is_initialized():
    raise RuntimeError("no process group: call parallel.mesh.initialize()")
  return _AllReduceSum.apply(x)


def space_sum(x: torch.Tensor) -> torch.Tensor:
  """The sum of `x` over this rank's space group, differentiable; `x`
  itself when space is 1."""
  if space_count() == 1:
    return x
  return _AllReduceSum.apply(x, _mesh.space_group)


def space_all_to_all(x: torch.Tensor) -> torch.Tensor:
  """Trades rows over this rank's space group: `x` is [space, ...], row j
  what this rank sends to space rank j; the result is [space, ...], row i
  what space rank i sent to this one. One slot all-reduce (module
  docstring); not differentiable (the labels it carries have no
  gradient). `x` itself when space is 1."""
  n, i = space_count(), space_index()
  if x.shape[0] != n:
    raise ValueError(f"an all-to-all over {n} space ranks takes [{n}, ...], "
                     f"got {tuple(x.shape)}")
  if n == 1:
    return x
  slots = x.new_zeros((n,) + tuple(x.shape))
  slots[i] = x
  return _all_reduce(slots, _mesh.space_group)[:, i].contiguous()


def _trade(to_prev: torch.Tensor, to_next: torch.Tensor, dim: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Sends `to_prev` to the previous space rank and `to_next` to the next
  one, and returns (what the previous one sent as its `to_next`, what the
  next one sent as its `to_prev`); zeros where there is no neighbour. One
  slot all-reduce; every rank's `to_prev` and `to_next` have the same
  shapes."""
  n, i = space_count(), space_index()
  mine = torch.cat([to_prev, to_next], dim)
  slots = torch.stack([mine if r == i else torch.zeros_like(mine)
                       for r in range(n)])
  _all_reduce(slots, _mesh.space_group)
  first = to_prev.shape[dim]
  from_prev = (slots[i - 1].narrow(dim, first, to_next.shape[dim])
               if i > 0 else torch.zeros_like(to_next))
  from_next = (slots[i + 1].narrow(dim, 0, first) if i < n - 1
               else torch.zeros_like(to_prev))
  return from_prev, from_next


class _HaloExchange(torch.autograd.Function):
  """`halo_exchange` on a space group of more than one rank. Forward: this
  rank's first `hi` slices go to the previous rank and its last `lo` to
  the next; its halos come back from them. Backward, the adjoint: the
  gradient of the halo below goes back to the previous rank, where it adds
  to its last `lo` slices, and that of the halo above to the next rank's
  first `hi`."""

  @staticmethod
  def forward(ctx, x, dim, lo, hi):
    ctx.dim, ctx.lo, ctx.hi = dim, lo, hi
    size = x.shape[dim]
    below, above = _trade(x.narrow(dim, 0, hi), x.narrow(dim, size - lo, lo),
                          dim)
    return torch.cat([below, x, above], dim)

  @staticmethod
  def backward(ctx, grad):
    dim, lo, hi = ctx.dim, ctx.lo, ctx.hi
    size = grad.shape[dim] - lo - hi
    from_prev, from_next = _trade(grad.narrow(dim, 0, lo),
                                  grad.narrow(dim, lo + size, hi), dim)
    dx = grad.narrow(dim, lo, size).clone(
        memory_format=torch.contiguous_format)
    dx.narrow(dim, 0, hi).add_(from_prev)
    dx.narrow(dim, size - lo, lo).add_(from_next)
    return dx, None, None, None


def halo_exchange(x: torch.Tensor, dim: int, lo: int, hi: int
                  ) -> torch.Tensor:
  """`x`, this rank's depth slab along `dim`, extended by `lo` slices of
  the previous space rank's slab and `hi` of the next one's, with zeros
  past the grid's two ends (the first and the last rank): what a
  convolution's zero padding reads there. Differentiable; one slot
  all-reduce over the space group forward and one backward (none when
  space is 1 or both halos are empty). Halos come from the nearest
  neighbours only, so neither may be deeper than the slab."""
  size = x.shape[dim]
  if lo < 0 or hi < 0 or lo > size or hi > size:
    raise ValueError(f"a halo of {lo} and {hi} slices does not come from "
                     f"the neighbours' slabs of {size}: halos are exchanged "
                     "with the nearest space ranks only")
  if space_count() == 1:
    shape = list(x.shape)
    return torch.cat([x.new_zeros(shape[:dim] + [lo] + shape[dim + 1:]), x,
                      x.new_zeros(shape[:dim] + [hi] + shape[dim + 1:])], dim)
  if lo == hi == 0:
    return x
  return _HaloExchange.apply(x, dim, lo, hi)


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
  """The mean over ranks of per-rank means of equal-size shards, which is
  the mean over the global batch; `x` itself without a group. Dividing by
  a world size of 1 is exact, so one rank in a group computes what no
  group does."""
  if not dist.is_initialized():
    return x
  return all_reduce_sum(x) / dist.get_world_size()


def all_reduce_gradients(parameters: Iterable[torch.nn.Parameter]) -> None:
  """Averages the parameters' gradients over ranks in place: one
  all-reduce of the flattened gradients (the ranks' sum is world_size
  times the global gradient, module docstring). A no-op without a
  group."""
  if not dist.is_initialized():
    return
  grads = [p.grad for p in parameters if p.grad is not None]
  for dtype in sorted({g.dtype for g in grads}, key=str):
    same = [g for g in grads if g.dtype == dtype]
    flat = _all_reduce(_flatten_dense_tensors(same))
    flat /= dist.get_world_size()
    for g, reduced in zip(same, _unflatten_dense_tensors(flat, same)):
      g.copy_(reduced)


@torch.no_grad()
def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
  """Overwrites `tensors` in place with rank `src`'s, one broadcast per
  dtype. A no-op without a group."""
  if not dist.is_initialized():
    return
  for dtype in sorted({t.dtype for t in tensors}, key=str):
    same = [t for t in tensors if t.dtype == dtype]
    flat = _flatten_dense_tensors(same)
    tracing.count("mesh.collectives")
    dist.broadcast(flat, src)
    for t, value in zip(same, _unflatten_dense_tensors(flat, same)):
      t.copy_(value)


def assert_equal_across_ranks(value: int, what: str) -> None:
  """Raises on every rank unless every rank passes the same integer."""
  if not dist.is_initialized():
    return
  t = torch.tensor([value, -value], dtype=torch.int64)
  dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group())
  if int(t[0]) != -int(t[1]):
    raise RuntimeError(f"{what} differs between ranks: this rank has "
                       f"{value}, the ranks span {-int(t[1])}..{int(t[0])}")


def host_all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
  """The sum over ranks of a CPU tensor, over the host group."""
  t = t.clone()
  if dist.is_initialized():
    dist.all_reduce(t, group=host_group())
  return t


def host_all_gather(t: torch.Tensor) -> List[torch.Tensor]:
  """Every rank's CPU tensor of one shape, in rank order."""
  if not dist.is_initialized():
    return [t]
  out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
  dist.all_gather(out, t.contiguous(), group=host_group())
  return out
