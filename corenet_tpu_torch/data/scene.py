"""Scene + mesh NPZ readers (host side, numpy).

A near-copy of corenet_tpu/data/scene.py with its imports renamed. The
on-disk format (docs/data_format_and_coordinate_systems.md): a scene NPZ
with view/camera transforms, per-mesh o2w transforms, labels and
WebP-encoded OpenGL/PBRT renders (or raw uint8 arrays, passed through),
plus one NPZ per ShapeNet mesh the scene names, with its 'vertices' (and
optional material/texture fields for visualization). PIL is imported only
when an image must be decoded.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Any, List, Optional

import numpy as np

from corenet_tpu_torch.utils import fs


@dataclasses.dataclass(frozen=True)
class Scene:
  """A rendered synthetic scene (numpy host arrays)."""
  mesh_vertices: List[np.ndarray]       # List[float32[T_i, 3, 3]]
  view_transform: np.ndarray            # float32[4, 4]
  o2w_transforms: np.ndarray            # float32[num_meshes, 4, 4]
  camera_transform: np.ndarray          # float32[4, 4]
  mesh_labels: List[str]
  mesh_visible_fractions: np.ndarray    # float32[num_meshes]
  opengl_image: np.ndarray              # uint8[H, W, 3]
  pbrt_image: np.ndarray                # uint8[H, W, 3]
  # Optional visualization-only fields:
  normals: List[np.ndarray] = dataclasses.field(default_factory=list)
  texcoords: List[np.ndarray] = dataclasses.field(default_factory=list)
  material_ids: List[np.ndarray] = dataclasses.field(default_factory=list)
  diffuse_colors: List[np.ndarray] = dataclasses.field(default_factory=list)
  diffuse_texture_pngs: List[List[bytes]] = dataclasses.field(
      default_factory=list)


def decode_image(data: Any) -> np.ndarray:
  """Decodes an encoded (WebP/PNG) image buffer to uint8[H, W, 3]."""
  if isinstance(data, np.ndarray) and data.ndim >= 2:
    return np.asarray(data, np.uint8)  # already decoded
  buf = bytes(data) if not isinstance(data, bytes) else data
  try:
    import PIL.Image  # type: ignore
  except ImportError as e:  # pragma: no cover
    raise RuntimeError("PIL is required to decode scene images") from e
  return np.asarray(PIL.Image.open(io.BytesIO(buf)).convert("RGB"), np.uint8)


class NpzReader:
  def __init__(self, path: str):
    self.npz = np.load(io.BytesIO(fs.read_bytes(path)), allow_pickle=True)

  def array(self, item: str, dtype: Optional[np.dtype] = None) -> np.ndarray:
    result = self.npz[item]
    return result.astype(dtype) if dtype is not None else result

  def list(self, item: str) -> List[Any]:
    result = self.npz[item]
    assert result.ndim == 1
    return list(result)

  def scalar(self, item: str) -> Any:
    result = self.npz[item]
    assert result.ndim == 0
    return result[()]


def load_from_npz(path: str, meshes_dir: str,
                  load_extra_fields: bool = False) -> Scene:
  """Loads a scene NPZ plus one NPZ per mesh it names."""
  scene_npz = NpzReader(path)
  labels = [str(v) for v in scene_npz.list("mesh_labels")]
  filenames = [str(v) for v in scene_npz.list("mesh_filenames")]
  mesh_paths = [fs.join(meshes_dir, lbl, fn) + ".npz"
                for lbl, fn in zip(labels, filenames)]

  mesh_vertices = []
  normals, texcoords, material_ids = [], [], []
  diffuse_colors, diffuse_texture_pngs = [], []
  for mesh_path in mesh_paths:
    mesh_npz = NpzReader(mesh_path)
    mesh_vertices.append(mesh_npz.array("vertices", np.float32))
    if load_extra_fields:
      normals.append(mesh_npz.array("normals", np.float32))
      material_ids.append(mesh_npz.array("material_ids", np.int32))
      texcoords.append(mesh_npz.array("texcoords", np.float32))
      diffuse_colors.append(mesh_npz.array("diffuse_colors", np.float32))
      diffuse_texture_pngs.append(mesh_npz.scalar("diffuse_texture_pngs"))

  return Scene(
      mesh_vertices=mesh_vertices,
      view_transform=scene_npz.array("view_transform", np.float32),
      o2w_transforms=scene_npz.array("mesh_object_to_world_transforms",
                                     np.float32),
      camera_transform=scene_npz.array("camera_transform", np.float32),
      mesh_labels=labels,
      mesh_visible_fractions=scene_npz.array("mesh_visible_fractions",
                                             np.float32),
      opengl_image=decode_image(scene_npz.scalar("opengl_image")),
      pbrt_image=decode_image(scene_npz.scalar("pbrt_image")),
      normals=normals, texcoords=texcoords, material_ids=material_ids,
      diffuse_colors=diffuse_colors,
      diffuse_texture_pngs=diffuse_texture_pngs)
