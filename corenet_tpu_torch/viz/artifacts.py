"""Visualization artifact framework.

A near-copy of corenet_tpu/viz/artifacts.py: artifacts expose a 3D
bounding box and render under a given camera; helpers compute four extra
tetrahedron-vertex cameras framing the union box; and `visualize_artifacts`
renders every artifact under the default + 4 extra cameras into one tiled
image (cameras as rows, artifacts as columns). Meshes and voxel grids
render on the `device` they are given (viz/renderer.py).

`MeshSurfaceArtifact` extracts marching-tetrahedra meshes
(viz/isosurface.py) with optional box-filter smoothing and rasterizes
them; `IsosurfaceArtifact` (a thresholded raycast, no mesh) is the cheaper
alternative. `ImageArtifact` resizes with torch's antialiased bicubic
interpolation (PIL's resampling filter), so no image library is needed.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from corenet_tpu_torch.viz import camera as camera_util
from corenet_tpu_torch.viz import isosurface
from corenet_tpu_torch.viz import renderer
from corenet_tpu_torch.viz.colors import DEFAULT_COLOR_PALETTE

Box = Tuple[np.ndarray, np.ndarray]


class VisualizationArtifact:

  def get_3d_box(self) -> Optional[Box]:
    raise NotImplementedError()

  def render(self, camera: np.ndarray, image_size: Tuple[int, int],
             device="cuda") -> np.ndarray:
    raise NotImplementedError()


class MultiMeshArtifact(VisualizationArtifact):
  """Triangle meshes with one palette color per mesh."""

  def __init__(self, meshes: Sequence[np.ndarray],
               mesh_labels: Optional[Sequence[int]] = None,
               palette: np.ndarray = DEFAULT_COLOR_PALETTE):
    self.meshes = [np.asarray(m, np.float32) for m in meshes]
    if mesh_labels is None:
      mesh_labels = [i + 1 for i in range(len(self.meshes))]
    self.mesh_labels = list(mesh_labels)
    self.palette = palette

  def get_3d_box(self) -> Optional[Box]:
    pts = [m.reshape(-1, 3) for m in self.meshes if m.size]
    if not pts:
      return None
    allp = np.concatenate(pts, 0)
    return allp.min(0), allp.max(0)

  def render(self, camera, image_size, device="cuda"):
    tris, cols = [], []
    for mesh, label in zip(self.meshes, self.mesh_labels):
      if not mesh.size:
        continue
      color = self.palette[label % len(self.palette)]
      if color[0] < 0:
        continue
      tris.append(mesh)
      cols.append(np.tile(color[None], (mesh.shape[0], 1)))
    if not tris:
      return np.full(image_size + (3,), 255, np.uint8)
    return renderer.render_mesh(np.concatenate(tris, 0),
                                np.concatenate(cols, 0), camera, image_size,
                                device=device)


class VoxelGridArtifact(VisualizationArtifact):
  """A labeled voxel grid int[D, H, W], raycast as cubes."""

  def __init__(self, grid: np.ndarray,
               grid_to_world: Optional[np.ndarray] = None,
               palette: np.ndarray = DEFAULT_COLOR_PALETTE):
    self.grid = np.asarray(grid, np.int32)
    self.grid_to_world = (np.asarray(grid_to_world, np.float32)
                          if grid_to_world is not None
                          else np.eye(4, dtype=np.float32))
    self.palette = palette

  def get_3d_box(self) -> Box:
    d, h, w = self.grid.shape
    corners = np.array([[0, 0, 0], [w, h, d]], np.float32)
    m = self.grid_to_world
    pts = corners @ m[:3, :3].T + m[:3, 3]
    return pts.min(0), pts.max(0)

  def render(self, camera, image_size, device="cuda"):
    return renderer.render_voxel_grid(
        self.grid, camera=camera, palette=self.palette,
        grid_to_world=self.grid_to_world, image_size=image_size,
        device=device)


class IsosurfaceArtifact(VoxelGridArtifact):
  """Predicted-surface visualization from a class PMF float[D, H, W, C]:
  argmax labels where foreground probability exceeds `threshold` (the role
  of the reference's MarchingCubesArtifact, artifacts.py:199-289)."""

  def __init__(self, pmf: np.ndarray, threshold: float = 0.5,
               grid_to_world: Optional[np.ndarray] = None,
               palette: np.ndarray = DEFAULT_COLOR_PALETTE):
    pmf = np.asarray(pmf, np.float32)
    fg = 1.0 - pmf[..., 0]
    labels = np.argmax(pmf[..., 1:], axis=-1).astype(np.int32) + 1
    grid = np.where(fg > threshold, labels, 0)
    super().__init__(grid, grid_to_world, palette)


class MeshSurfaceArtifact(MultiMeshArtifact):
  """Extracted isosurface meshes of a class PMF float[D, H, W, C] — the
  reference's MarchingCubesArtifact (artifacts.py:199-289): per class
  c ≥ 1 the 0.5 isosurface of the (optionally box-filtered) class
  probability, as a marching-tetrahedra mesh transformed to world space
  and rendered with the class palette color."""

  def __init__(self, pmf: np.ndarray,
               grid_to_world: Optional[np.ndarray] = None,
               palette: np.ndarray = DEFAULT_COLOR_PALETTE,
               filter_kernel: int = 1, level: float = 0.5):
    pmf = np.asarray(pmf, np.float32)
    num_classes = pmf.shape[-1]
    m = (np.asarray(grid_to_world, np.float32)
         if grid_to_world is not None else np.eye(4, dtype=np.float32))
    meshes, labels = [], []
    for c in range(1, num_classes):
      vol = isosurface.box_filter3d(pmf[..., c], filter_kernel)
      tris = isosurface.marching_tetrahedra(vol, level=level)
      if not tris.size:
        continue
      # Lattice point (x, y, z) samples voxel [z, y, x] → its center
      # (x+.5, y+.5, z+.5) in the grid frame of VoxelGridArtifact.
      tris = (tris + 0.5) @ m[:3, :3].T + m[:3, 3]
      meshes.append(tris.astype(np.float32))
      labels.append(c)
    super().__init__(meshes, labels, palette)


class ImageArtifact(VisualizationArtifact):
  """A 2D image, resized preserving aspect onto a white canvas."""

  def __init__(self, image: np.ndarray):
    self.image = np.asarray(image, np.uint8)

  def get_3d_box(self) -> Optional[Box]:
    return None

  def render(self, camera, image_size, device="cuda"):
    del camera, device  # an image needs no rendering; resized on the host
    th, tw = image_size
    ih, iw = self.image.shape[:2]
    scale = min(th / ih, tw / iw)
    nh, nw = max(1, int(ih * scale)), max(1, int(iw * scale))
    resized = self.image[..., :3]
    if (nh, nw) != (ih, iw):
      nchw = torch.from_numpy(np.ascontiguousarray(resized)).permute(
          2, 0, 1)[None].float()
      resized = F.interpolate(nchw, size=(nh, nw), mode="bicubic",
                              align_corners=False, antialias=True)
      resized = resized[0].permute(1, 2, 0).round().clamp(0, 255).to(
          torch.uint8).numpy()
    canvas = np.full((th, tw, 3), 255, np.uint8)
    oy, ox = (th - nh) // 2, (tw - nw) // 2
    canvas[oy:oy + nh, ox:ox + nw] = resized
    return canvas


def union_box(artifacts: Sequence[VisualizationArtifact]) -> Box:
  boxes = [a.get_3d_box() for a in artifacts]
  boxes = [b for b in boxes if b is not None]
  if not boxes:
    return (np.zeros(3, np.float32), np.ones(3, np.float32))
  mins = np.min([b[0] for b in boxes], axis=0)
  maxs = np.max([b[1] for b in boxes], axis=0)
  return mins, maxs


def visualize_artifacts(artifacts: Sequence[VisualizationArtifact],
                        image_size: Tuple[int, int] = (256, 256),
                        num_extra_views: int = 4,
                        device="cuda") -> np.ndarray:
  """Renders all artifacts under the default camera + tetrahedron views.

  Returns uint8[(1 + extra) * H, num_artifacts * W, 3]: cameras as rows,
  artifacts as columns.
  """
  box_min, box_max = union_box(artifacts)
  cameras = [camera_util.default_camera(box_min, box_max)]
  cameras += camera_util.tetrahedron_cameras(box_min, box_max)[
      :num_extra_views]
  rows = []
  for cam in cameras:
    row = [a.render(cam, image_size, device) for a in artifacts]
    rows.append(np.concatenate(row, axis=1))
  return np.concatenate(rows, axis=0)
