"""Qualitative evaluation results: rendered reconstructions on disk and in
the summaries.

Counterpart of corenet_tpu/eval/qualitative.py: for the first K scenes of
an eval, render [input image | predicted surface | predicted voxel grid |
GT voxel grid | GT meshes] under the default and four tetrahedron cameras
and write `img_{scene_id}.png` (utils/png.py) under
<output>/<eval_name>/<step>/; the first few tiles also go to the summary
writer. Extraction (argmax, isosurfaces) runs on the host; the renderers
run on `device`. Under a process group each rank renders its own shard's
first scenes, and `write_summaries` gathers the ranks' summary tiles to
rank 0's writer, as the JAX package gathers them across hosts.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from corenet_tpu_torch.parallel import mesh
from corenet_tpu_torch.utils import fs
from corenet_tpu_torch.utils.png import encode_png
from corenet_tpu_torch.viz import artifacts as art
from corenet_tpu_torch.viz import isosurface


def visualize_scene_output(input_image: np.ndarray,
                           pmf: np.ndarray,
                           gt_grid: np.ndarray,
                           meshes: Sequence[np.ndarray],
                           mesh_labels: Sequence[int],
                           grid_to_view: np.ndarray,
                           image_size=(256, 256),
                           max_surface_triangles: int = 30_000,
                           device="cuda") -> np.ndarray:
  """One scene's qualitative tile, uint8[5·H, 5·W, 3].

  The predicted surface renders as an extracted marching-tetrahedra mesh
  unless it exceeds max_surface_triangles (a barely trained model's
  near-noise PMF can yield millions of sliver triangles, and
  rasterization costs O(T·H·W)); then it renders as the raycast
  isosurface. The cap is checked first with an O(voxels) count of active
  cells, so the near-noise case never pays for the full extraction."""
  pred_labels = np.argmax(pmf, axis=-1).astype(np.int32)
  pmf_f = np.asarray(pmf, np.float32)
  # Every active cell emits at least one triangle, so `cells > cap` is a
  # sound reason to skip extraction; the exact check below still holds
  # the cap.
  est_cells = sum(
      isosurface.count_active_cells(isosurface.box_filter3d(pmf_f[..., c], 1))
      for c in range(1, pmf_f.shape[-1]))
  surface = None
  if est_cells <= max_surface_triangles:
    surface = art.MeshSurfaceArtifact(pmf, grid_to_world=grid_to_view)
    if sum(m.shape[0] for m in surface.meshes) > max_surface_triangles:
      surface = None
  if surface is None:
    surface = art.IsosurfaceArtifact(pmf, grid_to_world=grid_to_view)
  items = [
      art.ImageArtifact(input_image),
      surface,
      art.VoxelGridArtifact(pred_labels, grid_to_world=grid_to_view),
      art.VoxelGridArtifact(gt_grid, grid_to_world=grid_to_view),
      art.MultiMeshArtifact(meshes, mesh_labels),
  ]
  return art.visualize_artifacts(items, image_size, device=device)


class QualitativeResults:
  """Renders the first `num_results` scenes to disk; the first
  `num_results_in_summary` tiles also go to the summary writer when
  `write_summaries` is called."""

  def __init__(self, output_dir: str, num_results: int,
               num_results_in_summary: int = 4, summary_writer=None,
               image_size=(256, 256), device="cuda"):
    self.output_dir = output_dir
    self.num_results = num_results
    self.num_results_in_summary = num_results_in_summary
    self.summary_writer = summary_writer
    self.image_size = image_size
    self.device = device
    self.rendered = 0
    self._summary_tiles = []

  def want_more(self) -> bool:
    return self.rendered < self.num_results

  def add_scene(self, scene_id: str, input_image, pmf, gt_grid, meshes,
                mesh_labels, grid_to_view):
    if not self.want_more():
      return
    tile = visualize_scene_output(
        np.asarray(input_image), np.asarray(pmf), np.asarray(gt_grid),
        meshes, mesh_labels, np.asarray(grid_to_view), self.image_size,
        device=self.device)
    safe_id = scene_id.replace("/", "_")
    fs.makedirs(self.output_dir)
    fs.write_bytes(fs.join(self.output_dir, f"img_{safe_id}.png"),
                   encode_png(tile))
    if len(self._summary_tiles) < self.num_results_in_summary:
      self._summary_tiles.append(tile)
    self.rendered += 1

  def write_summaries(self, global_step: int = 0) -> None:
    """Writes the first K tiles to the summary writer. Under a process
    group it is a collective, which every rank calls, with or without a
    writer: the ranks' tiles, (K, 5H, 5W, 3) uint8 with their counts, are
    gathered, and the writer takes the first K in rank order."""
    k = self.num_results_in_summary
    tiles = self._summary_tiles[:k]
    self._summary_tiles = []
    if k <= 0:
      return
    if mesh.is_initialized():
      h, w = self.image_size
      buf = torch.zeros((k, 5 * h, 5 * w, 3), dtype=torch.uint8)
      for i, tile in enumerate(tiles):
        if tile.shape != (5 * h, 5 * w, 3):
          raise ValueError(f"a tile of {tile.shape}, expected "
                           f"{(5 * h, 5 * w, 3)}")
        buf[i] = torch.from_numpy(tile)
      counts = mesh.host_all_gather(torch.tensor([len(tiles)]))
      tiles = [t[i].numpy()
               for t, n in zip(mesh.host_all_gather(buf), counts)
               for i in range(int(n))]
    if self.summary_writer is None:
      return
    for i, tile in enumerate(tiles[:k]):
      self.summary_writer.add_image(f"rec_{i}", tile, global_step)
