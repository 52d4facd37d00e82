"""Prefetching data loader: parallel scene decode + batch assembly.

A near-copy of corenet_tpu/data/loader.py with its imports renamed: a
host-side prefetch pipeline that feeds the step. Workers decode scene
NPZs, batches assemble into padded HostBatch buffers, and a bounded queue
keeps `prefetch_factor` batches in flight while the device computes.

Workers are PROCESSES by default: NPZ+WebP decode is Python/zlib-bound, so
threads would serialize on the GIL. Workers use the `spawn` start method
(forking a process whose CUDA runtime threads hold locks is unsafe) and
receive the (pickled) dataset once via the pool initializer; per-item
traffic is one int in, one DatasetElement out. A worker imports this
package, and so torch, but never touches CUDA: it only reads NPZ files
into numpy arrays. Datasets that cannot be pickled (e.g. closure
data_transforms) fall back to threads automatically.

Sharding: deterministic permutation (seed 0x1234 by default) of the
dataset, split into contiguous per-process ranges; training pads ranks to
equal length by wrapping (pad_data=True), eval leaves the tail uneven
(pad_data=False).
"""

from __future__ import annotations

import logging
import multiprocessing
import pickle
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np

from corenet_tpu_torch.data import batching
from corenet_tpu_torch.data.dataset import CoreNetDataset

log = logging.getLogger(__name__)

# Worker-process state: the dataset is shipped once via the pool
# initializer (spawn pickles these module-level functions by name).
_WORKER_DATASET = None


def _worker_init(payload: bytes) -> None:
  global _WORKER_DATASET
  _WORKER_DATASET = pickle.loads(payload)


def _worker_get(index: int):
  return _WORKER_DATASET[int(index)]


class _ProducerError:
  """Queue marker carrying a producer-side exception to the consumer."""

  def __init__(self, exc: BaseException):
    self.exc = exc


def distributed_indices(num_examples: int, num_shards: int, shard: int,
                        pad_data: bool, seed: int = 0x1234,
                        shuffle: bool = True) -> np.ndarray:
  """Deterministic per-shard index ranges (contiguous in a seeded
  permutation), padded by wrap-around when pad_data."""
  perm = (np.random.default_rng(seed).permutation(num_examples)
          if shuffle else np.arange(num_examples))
  if pad_data:
    per = -(-num_examples // num_shards)
    padded = np.concatenate([perm, perm[:per * num_shards - num_examples]])
    return padded[shard * per:(shard + 1) * per]
  per = -(-num_examples // num_shards)
  return perm[shard * per:min((shard + 1) * per, num_examples)]


class DataLoader:
  """Iterates HostBatches with background prefetch."""

  def __init__(self,
               dataset: CoreNetDataset,
               batch_size: int,
               num_workers: int = 6,
               prefetch_factor: int = 2,
               max_edge_view: Optional[float] = None,
               max_meshes: Optional[int] = None,
               triangle_buckets: Optional[Sequence[int]] = None,
               random_grid_offset: bool = False,
               seed: int = 0,
               drop_last: bool = False,
               pad_partial: bool = False,
               batch_transform=None,
               worker_processes: Optional[bool] = None):
    """batch_transform: optional fn(HostBatch) -> dict of extra step
    inputs, run in the producer thread (e.g. native host-GT grids —
    batching.host_voxelize — overlapping device compute).

    worker_processes: True = decode in spawned worker processes,
    False = threads, None (default) = processes when num_workers > 1
    and the dataset is picklable."""
    self.dataset = dataset
    self.batch_size = batch_size
    self.num_workers = max(1, num_workers)
    self.prefetch_factor = max(1, prefetch_factor)
    self.max_edge_view = max_edge_view
    self.max_meshes = max_meshes
    self.triangle_buckets = triangle_buckets
    self.random_grid_offset = random_grid_offset
    self.rng = np.random.default_rng(seed)
    self.drop_last = drop_last
    self.pad_partial = pad_partial
    self.batch_transform = batch_transform
    self.worker_processes = worker_processes
    self._dataset_payload: Optional[bytes] = None

  def _make_pool(self):
    """A per-epoch decode pool: ProcessPoolExecutor (spawn) when enabled
    and the dataset pickles, else ThreadPoolExecutor."""
    want = self.worker_processes
    if want is None:
      # Auto: processes pay off when decode can actually parallelize —
      # on a 1-2 core host the spawn/IPC overhead exceeds the GIL cost.
      import os
      want = self.num_workers > 1 and (os.cpu_count() or 1) >= 4
    if want:
      try:
        if self._dataset_payload is None:
          self._dataset_payload = pickle.dumps(
              self.dataset, protocol=pickle.HIGHEST_PROTOCOL)
        return ProcessPoolExecutor(
            self.num_workers,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init,
            initargs=(self._dataset_payload,)), _worker_get
      except Exception as e:  # unpicklable dataset / no mp support
        if self.worker_processes:
          raise
        log.warning("falling back to thread workers: %s", e)
    return (ThreadPoolExecutor(self.num_workers),
            lambda i: self.dataset[int(i)])

  def __len__(self):
    n = len(self.dataset)
    if self.drop_last:
      return n // self.batch_size
    return -(-n // self.batch_size)

  def _load_batch(self, indices, pool, fetch):
    elements = list(pool.map(fetch, indices))
    valid = np.zeros([self.batch_size], bool)
    valid[:len(elements)] = True
    while len(elements) < self.batch_size:
      elements.append(elements[0])
    offsets = None
    if self.random_grid_offset:
      offsets = self.rng.random((self.batch_size, 3)).astype(np.float32)
    hb = batching.batch(elements, max_edge_view=self.max_edge_view,
                        triangle_buckets=self.triangle_buckets,
                        max_meshes=self.max_meshes, grid_offsets=offsets)
    if self.batch_transform is not None:
      hb.extra.update(self.batch_transform(hb))
    return hb, valid

  def __iter__(self) -> Iterator:
    n = len(self.dataset)
    batch_starts = list(range(0, n, self.batch_size))
    if self.drop_last:
      batch_starts = [s for s in batch_starts if s + self.batch_size <= n]

    q: queue.Queue = queue.Queue(maxsize=self.prefetch_factor)
    sentinel = object()
    # A consumer that abandons the epoch (max_steps exit mid-epoch — the
    # normal exit path of train/pipeline.py) closes the generator; the
    # stop event unblocks the producer so no thread/batch leaks.
    stop = threading.Event()

    def put(item) -> bool:
      while not stop.is_set():
        try:
          q.put(item, timeout=0.1)
          return True
        except queue.Full:
          pass
      return False

    def producer():
      # Any worker failure (a BrokenProcessPool from a killed/unimportable
      # spawn worker, a decode error) must abort the epoch LOUDLY: if the
      # sentinel alone were enqueued, training epochs and eval shards
      # would silently truncate and eval would report metrics over a
      # partial dataset.
      try:
        pool, fetch = self._make_pool()
        with pool:
          for s in batch_starts:
            if stop.is_set():
              break
            idx = list(range(s, min(s + self.batch_size, n)))
            if not put(self._load_batch(idx, pool, fetch)):
              break
      except BaseException as e:  # re-raised in the consumer
        put(_ProducerError(e))
      else:
        put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
      while True:
        item = q.get()
        if item is sentinel:
          break
        if isinstance(item, _ProducerError):
          raise RuntimeError(
              "data loader producer failed; aborting the epoch"
          ) from item.exc
        yield item
    finally:
      stop.set()
      t.join(timeout=30)
