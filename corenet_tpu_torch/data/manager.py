"""Dataset composition + resumable epoch derivation.

A near-copy of corenet_tpu/data/manager.py with its imports renamed:
datasets are cached per (path, meshes_dir, realism); each configured
dataset is shuffled (ONCE → global seed, PER_EPOCH → f(local seed)),
truncated to data_fraction, concatenated, then the concatenation is
shuffled the same way; `create_dataset_from_start_step` derives (epoch,
offset) from the global step so training resumes mid-epoch
deterministically.
"""

from __future__ import annotations

from typing import Any, Dict

from corenet_tpu_torch.config import config as cfg
from corenet_tpu_torch.data import dataset as dataset_lib
from corenet_tpu_torch.utils import fs


def _dataset_key(d: cfg.Dataset):
  return (fs.normpath(fs.abspath(d.dataset_path)), d.meshes_dir,
          d.high_realism)


class DatasetManager:
  dataset_cache: Dict[Any, dataset_lib.CoreNetDatasetImpl] = {}

  def __init__(self, data_pipeline: cfg.DataPipeline, global_seed=0x5678):
    self.data_pipeline = data_pipeline
    self.global_seed = global_seed
    for d in data_pipeline.datasets:
      key = _dataset_key(d)
      if key not in self.dataset_cache:
        self.dataset_cache[key] = dataset_lib.CoreNetDatasetImpl(
            dataset_path=key[0], meshes_dir=d.meshes_dir,
            high_realism=d.high_realism)

    self.epoch_len = 0
    self.classes = ()
    for d in data_pipeline.datasets:
      impl = self.dataset_cache[_dataset_key(d)]
      ds = dataset_lib.CoreNetDataset(impl, impl.classes)
      ds = ds.take_fraction(0, d.data_fraction)
      self.classes = ds.classes
      self.epoch_len += len(ds)

  def create_dataset(self, local_seed: int = 0x1234
                     ) -> dataset_lib.CoreNetDataset:
    result = []
    local_seed = local_seed * 19 + 317
    for d in self.data_pipeline.datasets:
      impl = self.dataset_cache[_dataset_key(d)]
      ds = dataset_lib.CoreNetDataset(impl, impl.classes)
      if d.shuffle == cfg.ShuffleType.ONCE:
        ds = ds.shuffle(self.global_seed)
      elif d.shuffle == cfg.ShuffleType.PER_EPOCH:
        ds = ds.shuffle(local_seed)
      ds = ds.take_fraction(0, d.data_fraction)
      result.append(ds)

    out = dataset_lib.concatenate(result)
    if self.data_pipeline.shuffle == cfg.ShuffleType.ONCE:
      out = out.shuffle(self.global_seed)
    elif self.data_pipeline.shuffle == cfg.ShuffleType.PER_EPOCH:
      out = out.shuffle(local_seed)
    return out

  def create_dataset_from_start_step(self, start_step: int):
    """Derives epoch and in-epoch offset from a global step (resume)."""
    epoch = start_step // self.epoch_len
    start_step_in_epoch = start_step % self.epoch_len
    return self.create_dataset(local_seed=epoch)[start_step_in_epoch:]
