"""Seeded synthetic training data in the on-disk format of the CoreNet
datasets: closed meshes (one NPZ each, `vertices` float32 [T, 3, 3]), one
scene NPZ per example and a manifest listing them.

Every number comes from the traffic file's parameters and the seed:
`meshes` distinct meshes of `triangles` = [lo, hi] triangles, log-uniform,
of the kinds `kinds` (ellipsoid, box, chair, table: the last two concave
unions of boxes shaped like ShapeNet's chairs and tables), and `scenes`
scenes of one mesh each, scaled by `scale` = [lo, hi], turned about the
vertical axis and centred in the unit cube of view space, seen by one of
`views` perspective cameras, with a seeded 256² image.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

CLASSES = (("02691156", "ellipsoid"), ("02828884", "box"),
           ("03001627", "chair"), ("04379243", "table"))
IMAGE_HW = 256


def _box(center, half, n) -> np.ndarray:
  """A closed box tessellated n × n per face: float32 [12·n², 3, 3]."""
  g = np.linspace(-1.0, 1.0, n + 1, dtype=np.float32)
  u, v = np.meshgrid(g, g, indexing="ij")
  quads = np.stack([np.stack([u[:-1, :-1], v[:-1, :-1]], -1),
                    np.stack([u[1:, :-1], v[1:, :-1]], -1),
                    np.stack([u[1:, 1:], v[1:, 1:]], -1),
                    np.stack([u[:-1, 1:], v[:-1, 1:]], -1)], 2).reshape(
                        -1, 4, 2)
  tris2 = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
  faces = []
  for axis in range(3):
    for sign in (-1.0, 1.0):
      pts = np.zeros(tris2.shape[:2] + (3,), np.float32)
      a, b = [i for i in range(3) if i != axis]
      pts[..., axis] = sign
      pts[..., a] = tris2[..., 0]
      pts[..., b] = tris2[..., 1]
      faces.append(pts)
  unit = np.concatenate(faces)
  return (unit * np.asarray(half, np.float32)
          + np.asarray(center, np.float32)).astype(np.float32)


def _parts(kind: str, rng) -> List[tuple]:
  """(centre, half extents) of a mesh's boxes in [-0.5, 0.5]³."""
  if kind == "chair":
    seat = rng.uniform(0.05, 0.08)
    leg = rng.uniform(0.03, 0.05)
    parts = [((0, 0, 0), (0.4, seat, 0.4)),
             ((0, 0.25, -0.36), (0.4, 0.25, 0.04))]
    for x in (-0.34, 0.34):
      for z in (-0.34, 0.34):
        parts.append(((x, -0.25, z), (leg, 0.25, leg)))
    return parts
  if kind == "table":
    top = rng.uniform(0.04, 0.07)
    leg = rng.uniform(0.03, 0.06)
    parts = [((0, 0.2, 0), (0.48, top, 0.3))]
    for x in (-0.42, 0.42):
      for z in (-0.24, 0.24):
        parts.append(((x, -0.1, z), (leg, 0.3, leg)))
    return parts
  half = rng.uniform(0.2, 0.48, 3)
  return [((0, 0, 0), tuple(half))]


def make_mesh(kind: str, triangles: int, rng) -> np.ndarray:
  """A closed mesh of about `triangles` triangles, within [-0.5, 0.5]³."""
  parts = _parts(kind, rng)
  area = np.array([h[0] * h[1] + h[1] * h[2] + h[0] * h[2] for _, h in parts])
  per = triangles * area / area.sum()
  boxes = [_box(c, h, max(1, int(round(np.sqrt(t / 12)))))
           for (c, h), t in zip(parts, per)]
  mesh = np.concatenate(boxes)
  if kind == "ellipsoid":
    half = np.asarray(parts[0][1], np.float32)
    unit = mesh / half
    mesh = unit / np.linalg.norm(unit, axis=-1, keepdims=True) * half
  return mesh.astype(np.float32)


def views(count: int, rng) -> np.ndarray:
  """`count` perspective cameras [count, 4, 4] looking at the unit cube of
  view space from one unit in front of it, each with its own focal length
  and principal point."""
  near, far = 0.5, 3.0
  a = (far + near) / (far - near)
  b = -2 * far * near / (far - near)
  out = np.zeros((count, 4, 4), np.float32)
  for i in range(count):
    f = rng.uniform(1.7, 2.1)
    cx, cy = rng.uniform(-0.04, 0.04, 2)
    out[i] = [[f, 0, 0, -0.5 * f + cx], [0, f, 0, -0.5 * f + cy],
              [0, 0, a, a + b], [0, 0, 1, 1.0]]
  return out


def _turn(angle: float, scale: float, shift) -> np.ndarray:
  c, s = np.cos(angle), np.sin(angle)
  m = np.eye(4, dtype=np.float32)
  m[:3, :3] = scale * np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
  m[:3, 3] = 0.5 + np.asarray(shift)
  return m


def write_dataset(root: str, traffic: Dict, seed: int) -> str:
  """Writes the meshes, the scenes and the manifest under `root`; returns
  the manifest's path."""
  rng = np.random.default_rng(seed)
  lo, hi = traffic["triangles"]
  kinds = traffic["kinds"]
  meshes_dir = os.path.join(root, "meshes")
  ids = dict((name, cid) for cid, name in CLASSES)
  mesh_names = []
  for i in range(traffic["meshes"]):
    kind = kinds[i % len(kinds)]
    t = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
    os.makedirs(os.path.join(meshes_dir, ids[kind]), exist_ok=True)
    name = f"{kind}_{i:04d}"
    np.savez(os.path.join(meshes_dir, ids[kind], name),
             vertices=make_mesh(kind, t, rng))
    mesh_names.append((ids[kind], name))
  cams = views(traffic["views"], rng)
  n = traffic["scenes"]
  pick = rng.integers(0, len(mesh_names), n)
  view = rng.integers(0, len(cams), n)
  angle = rng.uniform(0, 2 * np.pi, n)
  scale = rng.uniform(*traffic["scale"], n)
  shift = rng.uniform(-0.02, 0.02, (n, 3))
  images = rng.integers(0, 256, (n, IMAGE_HW, IMAGE_HW, 3), dtype=np.uint8)
  placeholder = np.empty((), dtype=object)
  placeholder[()] = np.zeros((1, 1, 3), np.uint8)
  files = []
  for i in range(n):
    label, name = mesh_names[pick[i]]
    boxed = np.empty((), dtype=object)
    boxed[()] = images[i]
    files.append(f"scene_{i:05d}.npz")
    np.savez(os.path.join(root, files[-1]),
             mesh_labels=np.array([label]), mesh_filenames=np.array([name]),
             view_transform=np.eye(4, dtype=np.float32),
             mesh_object_to_world_transforms=_turn(
                 angle[i], scale[i], shift[i])[None],
             camera_transform=cams[view[i]],
             mesh_visible_fractions=np.ones(1, np.float32),
             pbrt_image=boxed, opengl_image=placeholder)
  manifest = os.path.join(root, "dataset.json")
  with open(manifest, "w") as f:
    json.dump({"classes": [{"id": c, "human_readable": h}
                           for c, h in CLASSES], "files": files}, f)
  return manifest
