"""Converts ShapeNet CAD models (OBJ) to the per-mesh NPZ format.

Counterpart of corenet_tpu/cli/preprocess_shapenet.py: a simple OBJ reader
(vertex positions and faces, polygons split into fans), degenerate-
triangle cleanup (zero-length edges or a near-zero cross product), and
one NPZ per mesh with (vertices float32[T, 3, 3], label, mesh_id), laid
out as <output_root>/<label>/<mesh_id>.npz, which data/scene.py reads.
The meshes fan out over a pool of spawned processes (not forked: a
caller may hold CUDA and loader threads).

Usage:
  python -m corenet_tpu_torch.cli.preprocess_shapenet \\
      --shapenet_root=<ShapeNetCore.v2> --output_root=<meshes_dir>
"""

from __future__ import annotations

import dataclasses
import io
import logging
import multiprocessing
import os

import numpy as np

from corenet_tpu_torch.utils import flags, fs

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Args:
  shapenet_root: str = flags.flag("Path to ShapeNet's root directory")
  output_root: str = flags.flag("Path to the output root directory")
  num_workers: int = flags.flag("Parallel worker processes", default=0)


def read_obj(obj_path: str) -> np.ndarray:
  """Reads triangle vertices from an OBJ file, float32[T, 3, 3]."""
  vertices = []
  faces = []
  for line in fs.read_text(obj_path).split("\n"):
    parts = line.strip().split()
    if not parts:
      continue
    if parts[0] == "v":
      vertices.append([float(v) for v in parts[1:4]])
    elif parts[0] == "f":
      face = [int(p.split("/")[0]) - 1 for p in parts[1:]]
      # Triangulate fans for polygons with > 3 vertices.
      for i in range(1, len(face) - 1):
        faces.append([face[0], face[i], face[i + 1]])
  vertices = np.array(vertices, np.float32)
  faces = np.array(faces, np.int32)
  if faces.size == 0:
    return np.zeros([0, 3, 3], np.float32)
  return vertices[faces]


def cleanup_mesh(mesh: np.ndarray) -> np.ndarray:
  """Removes degenerate triangles: an edge shorter than 1e-27, or unit
  edges whose cross product is shorter than 1e-10."""
  if mesh.shape[0] == 0:
    return mesh
  s1 = mesh[:, 2] - mesh[:, 0]
  s2 = mesh[:, 1] - mesh[:, 0]
  l1 = np.linalg.norm(s1, axis=-1)
  l2 = np.linalg.norm(s2, axis=-1)
  eps = 1e-27
  is_degenerate = (l1 < eps) | (l2 < eps)
  cross = np.cross(s1 / np.maximum(l1, eps)[:, None],
                   s2 / np.maximum(l2, eps)[:, None], axis=-1)
  is_degenerate |= np.linalg.norm(cross, axis=-1) < 1e-10
  return mesh[~is_degenerate]


def process_mesh(input_path: str, output_root: str) -> str:
  """<root>/<label>/<mesh_id>/models/model_normalized.obj →
  <output_root>/<label>/<mesh_id>.npz; returns the NPZ's path."""
  parts = fs.normpath(input_path).split(os.sep)
  label = parts[-4]
  mesh_id = parts[-3]
  mesh = cleanup_mesh(read_obj(input_path))
  npz_path = fs.join(output_root, label, mesh_id + ".npz")
  buf = io.BytesIO()
  np.savez_compressed(buf, vertices=mesh, label=label, mesh_id=mesh_id)
  fs.makedirs(fs.dirname(npz_path))
  fs.write_bytes(npz_path, buf.getvalue())
  return npz_path


def main(argv=None):
  logging.basicConfig(level=logging.INFO)
  args = flags.parse_flags(Args, argv)
  root = fs.normpath(fs.abspath(args.shapenet_root))
  obj_files = sorted(
      fs.glob_pattern(fs.join(root, "*/*/models/model_normalized.obj")))
  out_dir = fs.normpath(fs.abspath(args.output_root))
  log.info("Converting %d meshes from %s to %s", len(obj_files), root,
           out_dir)

  workers = args.num_workers or os.cpu_count() or 4
  with multiprocessing.get_context("spawn").Pool(workers) as pool:
    for i, _ in enumerate(
        pool.starmap(process_mesh, ((v, out_dir) for v in obj_files),
                     chunksize=8)):
      if (i + 1) % 500 == 0:
        log.info("%d / %d", i + 1, len(obj_files))


if __name__ == "__main__":
  main()
