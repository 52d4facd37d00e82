"""High-level scene rendering with materials and texture sampling.

A near-copy of corenet_tpu/viz/scene_renderer.py: renders a Scene's meshes
in world space on `device`. Each triangle takes its material's diffuse
texture when one exists (packed into a deduplicated texture array by
`load_textures`, sampled bilinearly with perspective-correct UVs by
viz/renderer.py), its material's diffuse color otherwise (or the palette
when the scene has no materials), with eye-light diffuse shading.
`load_textures` decodes images with PIL, imported when it is called.
"""

from __future__ import annotations

import io
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from corenet_tpu_torch import geom
from corenet_tpu_torch.data.scene import Scene
from corenet_tpu_torch.viz import renderer
from corenet_tpu_torch.viz.colors import DEFAULT_COLOR_PALETTE


def load_textures(encoded_images: Iterable[bytes],
                  texture_size: Tuple[int, int] = (256, 256)
                  ) -> Tuple[np.ndarray, np.ndarray]:
  """Packs encoded images into a deduplicated texture array.

  The reference's load_textures contract: empty entries map to index -1;
  identical byte strings share one layer; images are resized to texture_size
  (bicubic) and flipped along Y (GL's bottom-origin UV convention, which
  the renderer's sampler assumes).

  Returns (uint8[K, H, W, 3] texture array, int32[N] image→layer map).
  """
  import PIL.Image
  height, width = texture_size
  index_of = {b"": -1}
  layers: List[np.ndarray] = []
  indices = []
  for data in encoded_images:
    data = bytes(data) if not isinstance(data, (bytes, bytearray)) else data
    if data not in index_of:
      img = PIL.Image.open(io.BytesIO(data)).convert("RGB").resize(
          (width, height), resample=PIL.Image.BICUBIC)
      index_of[data] = len(layers)
      layers.append(np.asarray(img, np.uint8)[::-1])  # Y flip
    indices.append(index_of[data])
  if not layers:
    layers = [np.zeros((1, 1, 3), np.uint8)]
  return np.stack(layers), np.asarray(indices, np.int32)


def scene_triangle_colors(sc: Scene) -> Sequence[np.ndarray]:
  """Per-triangle RGB colors per mesh: material diffuse colors when the
  scene was loaded with extra fields, palette colors otherwise."""
  colors = []
  for i, mesh in enumerate(sc.mesh_vertices):
    t = mesh.shape[0]
    if sc.material_ids and sc.diffuse_colors and len(sc.material_ids) > i:
      ids = np.clip(sc.material_ids[i], 0, len(sc.diffuse_colors[i]) - 1)
      colors.append(np.asarray(sc.diffuse_colors[i], np.float32)[ids])
    else:
      palette_color = DEFAULT_COLOR_PALETTE[(i + 1) %
                                            len(DEFAULT_COLOR_PALETTE)]
      colors.append(np.tile(palette_color[None], (t, 1)))
  return colors


def render_scene(sc: Scene,
                 camera: Optional[np.ndarray] = None,
                 image_size: Tuple[int, int] = (256, 256),
                 world_space: bool = True,
                 texture_size: Tuple[int, int] = (256, 256),
                 device="cuda") -> np.ndarray:
  """Renders all meshes of a scene (o2w-transformed when world_space).

  camera defaults to the scene's own view+camera transform
  (camera_transform @ view_transform), i.e. the input render's viewpoint.
  Triangles whose material carries a diffuse texture sample it; others
  use the diffuse/palette color. The rasterizer runs on `device`.
  """
  has_textures = any(
      len(png) > 0 for pngs in sc.diffuse_texture_pngs for png in pngs)
  tex_array = layer_map = offsets = None
  if has_textures:
    flat = [bytes(p) for pngs in sc.diffuse_texture_pngs for p in pngs]
    tex_array, layer_map = load_textures(flat, texture_size)
    offsets = np.cumsum(
        [0] + [len(pngs) for pngs in sc.diffuse_texture_pngs])

  colors = scene_triangle_colors(sc)
  tris, cols, uvs, texs = [], [], [], []
  for i, mesh in enumerate(sc.mesh_vertices):
    if not mesh.size:
      continue
    m = mesh
    if world_space:
      m = geom.transform_mesh(m, sc.o2w_transforms[i])
    tris.append(m)
    cols.append(colors[i])
    t = mesh.shape[0]
    uv = np.zeros((t, 3, 2), np.float32)
    tx = np.full((t,), -1, np.int32)
    if (has_textures and i < len(sc.texcoords) and sc.texcoords[i].size
        and i < len(sc.material_ids)
        and len(sc.diffuse_texture_pngs[i]) > 0):
      # The per-mesh texture-list guard keeps a texture-less mesh (with
      # texcoords/material_ids present) on the color path: clipping its
      # ids against an empty list would wrap offsets[i]-1 into ANOTHER
      # mesh's texture layer.
      uv = np.asarray(sc.texcoords[i], np.float32)
      ids = np.clip(sc.material_ids[i], 0,
                    len(sc.diffuse_texture_pngs[i]) - 1)
      tx = layer_map[offsets[i] + ids]
    uvs.append(uv)
    texs.append(tx)
  if not tris:
    return np.full(image_size + (3,), 255, np.uint8)
  all_tris = np.concatenate(tris, 0)
  all_cols = np.concatenate(cols, 0)

  if camera is None:
    camera = np.asarray(sc.camera_transform @ sc.view_transform
                        if world_space else sc.camera_transform)
    # The stored camera may not be Y-flipped for image rows; use it as-is.
  return renderer.render_mesh(
      all_tris, np.clip(all_cols, 0, 1), camera, image_size,
      tri_uvs=np.concatenate(uvs, 0) if has_textures else None,
      tri_tex=np.concatenate(texs, 0) if has_textures else None,
      textures=tex_array, device=device)
