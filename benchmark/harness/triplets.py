"""Seeded synthetic multi-object training data in the on-disk format of
the CoreNet triplets datasets: closed meshes (one NPZ each), one scene
NPZ per example with several meshes, and a manifest of ShapeNet's 13
classes.

Every number comes from the traffic file's parameters and the seed: a
pool of `meshes` meshes, mesh i of class i mod 13 (the classes of Choy et
al., in the manifest under their synset ids and names) and of the kind
`kinds`[class mod len(kinds)] (harness/scenes.py's ellipsoid, box, chair
and table), with `triangles` = [lo, hi] triangles, log-uniform; and
`scenes` scenes of `meshes_per_scene` distinct meshes of the pool, each
scaled by `scale` = [lo, hi] of the grid's extent and turned about the
vertical axis, standing on one ground plane with footprints that do not
overlap and lie inside the grid (as the paper's triplets are placed),
seen by one of `views` perspective cameras, with a seeded image of
`image_hw`² pixels.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from benchmark.harness.scenes import _turn, make_mesh, views

# ShapeNet's 13 classes of Choy et al. (3D-R2N2), sorted by name as the
# dataset's class mapping sorts them: class k is label k + 1, void 0.
CLASSES = (("02691156", "airplane"), ("02828884", "bench"),
           ("02933112", "cabinet"), ("02958343", "car"),
           ("03001627", "chair"), ("03211117", "display"),
           ("03636649", "lamp"), ("03691459", "loudspeaker"),
           ("04090263", "rifle"), ("04256520", "sofa"),
           ("04379243", "table"), ("04401088", "telephone"),
           ("04530566", "watercraft"))
GROUND = 0.3  # the ground plane's height in the unit cube of view space
GAP = 1.0 / 128  # the least gap between two footprints
PLACE_TRIES = 200
TURN_TRIES = 100


def _place(halves: List[Tuple[float, float]], rng):
  """Footprint centres (x, z) in the unit square for boxes of half extents
  `halves`, each inside the square and apart from the others by GAP; None
  when PLACE_TRIES draws find none."""
  for _ in range(PLACE_TRIES):
    centres = []
    for hx, hz in halves:
      c = (rng.uniform(hx, 1 - hx), rng.uniform(hz, 1 - hz))
      if all(abs(c[0] - x) >= hx + ox + GAP or abs(c[1] - z) >= hz + oz + GAP
             for (x, z), (ox, oz) in zip(centres, halves)):
        centres.append(c)
      else:
        break
    if len(centres) == len(halves):
      return centres
  return None


def _arrange(extents, scales, rng):
  """Angles and o2w transforms [n, 4, 4] for meshes of (half x, half z,
  min y) `extents` at `scales`: turned, footprints apart, on the ground."""
  for _ in range(TURN_TRIES):
    angles = rng.uniform(0, 2 * np.pi, len(scales))
    halves = [(s * (a * abs(np.cos(t)) + b * abs(np.sin(t))),
               s * (a * abs(np.sin(t)) + b * abs(np.cos(t))))
              for (a, b, _), s, t in zip(extents, scales, angles)]
    centres = _place(halves, rng)
    if centres is not None:
      return np.stack([
          _turn(t, s, (x - 0.5, GROUND - s * ymin - 0.5, z - 0.5))
          for (x, z), (_, _, ymin), s, t in zip(centres, extents, scales,
                                                angles)])
  raise RuntimeError(f"no placement of scales {scales} found")


def write_dataset(root: str, traffic: Dict, seed: int) -> str:
  """Writes the meshes, the scenes and the manifest under `root`; returns
  the manifest's path."""
  rng = np.random.default_rng(seed)
  lo, hi = traffic["triangles"]
  kinds = traffic["kinds"]
  per_scene = traffic["meshes_per_scene"]
  meshes_dir = os.path.join(root, "meshes")
  pool = []  # (class id, name, (half x, half z, min y))
  for i in range(traffic["meshes"]):
    c = i % len(CLASSES)
    kind = kinds[c % len(kinds)]
    cid = CLASSES[c][0]
    t = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
    mesh = make_mesh(kind, t, rng)
    os.makedirs(os.path.join(meshes_dir, cid), exist_ok=True)
    name = f"{kind}_{i:04d}"
    np.savez(os.path.join(meshes_dir, cid, name), vertices=mesh)
    v = mesh.reshape(-1, 3)
    pool.append((cid, name, (float(np.abs(v[:, 0]).max()),
                             float(np.abs(v[:, 2]).max()),
                             float(v[:, 1].min()))))
  cams = views(traffic["views"], rng)
  n = traffic["scenes"]
  view = rng.integers(0, len(cams), n)
  hw = traffic["image_hw"]
  images = rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
  placeholder = np.empty((), dtype=object)
  placeholder[()] = np.zeros((1, 1, 3), np.uint8)
  files = []
  for i in range(n):
    picked = [pool[k] for k in rng.choice(len(pool), per_scene,
                                          replace=False)]
    scales = rng.uniform(*traffic["scale"], per_scene)
    o2w = _arrange([p[2] for p in picked], scales, rng)
    boxed = np.empty((), dtype=object)
    boxed[()] = images[i]
    files.append(f"scene_{i:05d}.npz")
    np.savez(os.path.join(root, files[-1]),
             mesh_labels=np.array([p[0] for p in picked]),
             mesh_filenames=np.array([p[1] for p in picked]),
             view_transform=np.eye(4, dtype=np.float32),
             mesh_object_to_world_transforms=o2w.astype(np.float32),
             camera_transform=cams[view[i]],
             mesh_visible_fractions=np.ones(per_scene, np.float32),
             pbrt_image=boxed, opengl_image=placeholder)
  manifest = os.path.join(root, "dataset.json")
  with open(manifest, "w") as f:
    json.dump({"classes": [{"id": c, "human_readable": h}
                           for c, h in CLASSES], "files": files}, f)
  return manifest
