"""Manifest datasets with deterministic slicing/shuffling/concatenation.

A near-copy of corenet_tpu/data/dataset.py with its imports renamed: a
JSON manifest {classes: [{id, human_readable}], files: [...]} defines a
dataset; classes are sorted by human-readable name with `__void__`
prepended at index 0; elements load lazily from scene NPZs. The virtual
dataset supports index slicing, take_fraction, seeded shuffle and
concatenation. Seeded shuffles use numpy's PCG64 permutation, so the data
order is the JAX package's, element for element.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Callable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from corenet_tpu_torch.data import scene as scene_lib
from corenet_tpu_torch.utils import fs

VOID_LABEL_NAME = "__void__"


@dataclasses.dataclass
class DatasetClass:
  id: str
  human_readable: str


@dataclasses.dataclass
class DatasetElement:
  """One scene, flattened for batching (numpy host arrays)."""
  scene_id: str
  mesh_vertices: np.ndarray    # float32[num_total_tri, 3, 3] (untransformed)
  mesh_num_tri: np.ndarray     # int32[num_meshes]
  view_transform: np.ndarray   # float32[4, 4]
  camera_transform: np.ndarray  # float32[4, 4]
  o2w_transforms: np.ndarray   # float32[num_meshes, 4, 4]
  mesh_labels: np.ndarray      # int32[num_meshes]
  input_image: np.ndarray      # uint8[H, W, 3] (channel-last)


def build_class_structures(
    classes: Sequence[DatasetClass]
) -> Tuple[Tuple[str, ...], Mapping[str, int]]:
  """Human-readable class tuple (void first, then sorted) + id→int map."""
  sorted_classes = sorted(classes, key=lambda v: v.human_readable)
  names = tuple([VOID_LABEL_NAME] + [v.human_readable for v in sorted_classes])
  mapping = {v.id: i + 1 for i, v in enumerate(sorted_classes)}
  if len(mapping) != len(set(mapping.values())):
    raise ValueError("Found duplicate class IDs")
  return names, mapping


def to_dataset_element(ex: scene_lib.Scene, file_name: str,
                       class_to_int_mapping: Mapping[str, int],
                       high_realism: bool) -> DatasetElement:
  image = ex.pbrt_image if high_realism else ex.opengl_image
  return DatasetElement(
      scene_id=fs.splitext(file_name)[0],
      mesh_vertices=(np.concatenate(ex.mesh_vertices, axis=0)
                     if ex.mesh_vertices else
                     np.zeros([0, 3, 3], np.float32)),
      mesh_num_tri=np.array([v.shape[0] for v in ex.mesh_vertices], np.int32),
      view_transform=ex.view_transform,
      camera_transform=ex.camera_transform,
      o2w_transforms=ex.o2w_transforms,
      mesh_labels=np.array([class_to_int_mapping[v] for v in ex.mesh_labels],
                           np.int32),
      input_image=np.asarray(image, np.uint8))


# A data transform maps (scene, element) → element, applied in order
# after loading.
DataTransform = Callable[["scene_lib.Scene", "DatasetElement"],
                         "DatasetElement"]


class CoreNetDatasetImpl:
  """A dataset backed by a JSON manifest on disk."""

  def __init__(self, dataset_path: str, meshes_dir: str,
               high_realism: bool = True,
               data_transforms: Optional[List[DataTransform]] = None):
    self.dataset_path = dataset_path
    self.meshes_dir = meshes_dir
    self.high_realism = high_realism
    self.data_transforms = list(data_transforms or [])
    manifest = json.loads(fs.read_text(dataset_path))
    classes = [DatasetClass(**c) for c in manifest["classes"]]
    self.root_directory = fs.dirname(dataset_path)
    self.classes, self.class_to_int_mapping = build_class_structures(classes)
    self.files = np.array(manifest["files"])

  def __len__(self) -> int:
    return int(self.files.shape[0])

  def __getitem__(self, index: int) -> DatasetElement:
    file_name = str(self.files[index])
    ex = scene_lib.load_from_npz(
        fs.join(self.root_directory, file_name), self.meshes_dir)
    element = to_dataset_element(ex, file_name, self.class_to_int_mapping,
                                 self.high_realism)
    for transform in self.data_transforms:
      element = transform(ex, element)
    return element


class CoreNetDataset:
  """Virtual dataset: an index vector over an underlying dataset."""

  def __init__(self, dataset, classes: Sequence[str],
               indices: Optional[np.ndarray] = None):
    self._dataset = dataset
    self.classes = tuple(str(c) for c in classes)
    if indices is None:
      indices = np.arange(len(dataset), dtype=np.int64)
    self.indices = indices

  def __len__(self) -> int:
    return int(self.indices.shape[0])

  def __getitem__(self, index: Union[int, slice]):
    if isinstance(index, slice):
      return CoreNetDataset(self._dataset, self.classes, self.indices[index])
    return self._dataset[int(self.indices[index])]

  def take_fraction(self, start: float, end: float) -> "CoreNetDataset":
    assert 0 <= start <= end <= 1
    start_index = int(math.floor(start * len(self)))
    end_index = int(math.ceil(end * len(self)))
    return self[start_index:end_index]

  def shuffle(self, seed: int) -> "CoreNetDataset":
    rng = np.random.default_rng(seed)
    perm = rng.permutation(self.indices.shape[0])
    return CoreNetDataset(self._dataset, self.classes, self.indices[perm])

  def select(self, positions: np.ndarray) -> "CoreNetDataset":
    """A view over positions (into this dataset's current order)."""
    return CoreNetDataset(self._dataset, self.classes,
                          self.indices[np.asarray(positions)])


class _ConcatBackend:
  def __init__(self, datasets: List[CoreNetDataset]):
    self.datasets = datasets
    self.offsets = np.cumsum([0] + [len(d) for d in datasets])

  def __len__(self):
    return int(self.offsets[-1])

  def __getitem__(self, index: int):
    k = int(np.searchsorted(self.offsets, index, side="right")) - 1
    return self.datasets[k][index - int(self.offsets[k])]


def concatenate(datasets: Sequence[CoreNetDataset]) -> CoreNetDataset:
  datasets = list(datasets)
  if len(datasets) == 1:
    return datasets[0]
  classes = datasets[0].classes
  for d in datasets[1:]:
    if d.classes != classes:
      raise ValueError("The classes of all datasets must match")
  return CoreNetDataset(_ConcatBackend(datasets), classes)
