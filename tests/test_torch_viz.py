"""The port's qualitative visualization (corenet_tpu_torch/geom, viz/,
eval/qualitative.py, utils/png.py and utils/summary.py) against the JAX
package's, on the CPU, after tests/test_viz.py, tests/test_isosurface.py and
tests/test_transforms.py.

The renderers are held to the JAX renderers on the same seeded inputs
(meshes moved off pixel-centre ties) and to tests/golden/*.png by the mean
absolute difference per channel value, L1 < 1.0 (the measure of
tests/test_viz.py); isosurfaces are bit-equal; transforms and cameras
agree within 1e-6; a whole qualitative tile agrees with JAX's within
L1 < 1.0. The port's PNG bytes decode through PIL to the same pixels.
"""

import io
import json
import os

import numpy as np
import numpy.testing as tt
import PIL.Image
import pytest
import torch

from corenet_tpu import geom as jax_geom
from corenet_tpu.data import scene as jax_scene
from corenet_tpu.eval import qualitative as jax_qualitative
from corenet_tpu.viz import artifacts as jax_artifacts
from corenet_tpu.viz import camera as jax_camera
from corenet_tpu.viz import isosurface as jax_isosurface
from corenet_tpu.viz import renderer as jax_renderer
from corenet_tpu.viz import scene_renderer as jax_scene_renderer
from corenet_tpu_torch import geom
from corenet_tpu_torch.data import scene as scene_lib
from corenet_tpu_torch.eval import qualitative
from corenet_tpu_torch.utils.png import decode_png, encode_png
from corenet_tpu_torch.utils.summary import SummaryWriter
from corenet_tpu_torch.viz import artifacts, camera, isosurface, renderer
from corenet_tpu_torch.viz import scene_renderer
from helpers import cube_mesh, make_fixture_dataset

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
OFF_TIES = np.float32(0.0123)  # moves vertices off pixel-centre ties


def _l1(a, b):
  assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
  return float(np.abs(a.astype(np.int32) - b.astype(np.int32)).mean())


def _soup(seed, n):
  """n seeded triangles inside [0, 1]³ with seeded colors."""
  rng = np.random.default_rng(seed)
  centres = rng.uniform(0.2, 0.8, (n, 1, 3))
  tris = (centres + rng.normal(0, 0.12, (n, 3, 3))).astype(np.float32)
  return tris, rng.uniform(0, 1, (n, 3)).astype(np.float32)


def _textured_quad():
  tex = np.zeros((1, 8, 8, 3), np.uint8)
  tex[:, :, :4, 0] = 255  # left half red
  tex[:, :, 4:, 1] = 255  # right half green
  tex[:, 2:4, :, 2] = 200
  v = {"bl": [-1, -1, 0.1], "br": [1, -1, 0.2], "tr": [1, 1, 0.3],
       "tl": [-1, 1, 0.2]}
  uv = {"bl": [0, 0], "br": [1, 0], "tr": [1, 1], "tl": [0, 1]}
  tris = np.array([[v["bl"], v["br"], v["tr"]],
                   [v["bl"], v["tr"], v["tl"]]], np.float32) * 0.9
  uvs = np.array([[uv["bl"], uv["br"], uv["tr"]],
                  [uv["bl"], uv["tr"], uv["tl"]]], np.float32)
  cam = np.eye(4, dtype=np.float32)
  cam[3, 2] = 0.3  # some perspective
  cam[3, 3] = 1.0
  return tris, uvs, tex, cam


def _mesh_case(name):
  """(args, kwargs) of render_mesh for each case."""
  default = camera.default_camera([0, 0, 0], [1, 1, 1])
  if name == "cube":
    tris = cube_mesh(0.2, 0.8) + OFF_TIES
    return (tris, np.tile([[0.9, 0.2, 0.1]], (12, 1)).astype(np.float32),
            default, (96, 96)), {}
  if name == "depth_order":
    front = cube_mesh(0.3, 0.7)
    back = cube_mesh(0.3, 0.7) + np.array([0, 0, -3], np.float32)
    colors = np.concatenate([np.tile([[0.0, 0.9, 0.0]], (12, 1)),
                             np.tile([[0.9, 0.0, 0.0]], (12, 1))])
    cam = camera._framing([0.3, 0.3, 0.3], [0.7, 0.7, 0.7],
                          np.array([0., 0., 1.], np.float32))
    return (np.concatenate([back, front]) + OFF_TIES,
            colors.astype(np.float32), cam, (64, 64)), {}
  if name == "soup_many_chunks":
    tris, colors = _soup(0, 300)
    cam = camera.tetrahedron_cameras([0, 0, 0], [1, 1, 1])[1]
    return (tris, colors, cam, (48, 64)), {"chunk": 64}
  if name in ("textured", "textured_color_path"):
    tris, uvs, tex, cam = _textured_quad()
    layers = np.zeros((2,), np.int32) if name == "textured" else np.array(
        [0, -1], np.int32)
    return (tris, np.full((2, 3), 0.5, np.float32), cam, (32, 40)), {
        "tri_uvs": uvs, "tri_tex": layers, "textures": tex}
  raise ValueError(name)


@pytest.mark.parametrize("case", ["cube", "depth_order", "soup_many_chunks",
                                  "textured", "textured_color_path"])
def test_render_mesh_matches_jax(case):
  args, kwargs = _mesh_case(case)
  want = jax_renderer.render_mesh(*args, **kwargs)
  got = renderer.render_mesh(*args, **kwargs, device="cpu")
  assert got.shape == want.shape
  assert _l1(got, want) < 1.0
  assert len(np.unique(got.reshape(-1, 3), axis=0)) >= 2  # not blank


def _voxel_case(name):
  rng = np.random.default_rng(len(name))
  if name == "labels":
    grid = np.zeros((12, 12, 12), np.int32)
    grid[2:10, 3:9, 2:11] = rng.integers(0, 4, (8, 6, 9))
    return (grid,), {"image_size": (64, 64)}
  if name == "grid_to_world_tetra_camera":
    grid = (rng.random((10, 14, 8)) > 0.7).astype(np.int32) * 2
    g2w = np.eye(4, dtype=np.float32)
    g2w[:3, :3] /= 14.0
    g2w[:3, 3] = [0.1, -0.05, 0.2]
    box = artifacts.VoxelGridArtifact(grid, g2w).get_3d_box()
    cam = camera.tetrahedron_cameras(*box)[2]
    return (grid,), {"camera": cam, "grid_to_world": g2w,
                     "image_size": (40, 56)}
  if name == "transparent_palette_entry":
    grid = np.zeros((8, 8, 8), np.int32)
    grid[1:7, 1:7, 1:7] = 1
    grid[3:5, 3:5, 0:8] = 2
    palette = np.array(artifacts.DEFAULT_COLOR_PALETTE)
    palette[1, 0] = -1  # label 1 is see-through
    return (grid,), {"palette": palette, "image_size": (48, 48)}
  if name == "empty":
    return (np.zeros((4, 4, 4), np.int32),), {"image_size": (32, 32)}
  raise ValueError(name)


@pytest.mark.parametrize("case", ["labels", "grid_to_world_tetra_camera",
                                  "transparent_palette_entry", "empty"])
def test_render_voxel_grid_matches_jax(case):
  args, kwargs = _voxel_case(case)
  want = jax_renderer.render_voxel_grid(*args, **kwargs)
  got = renderer.render_voxel_grid(*args, **kwargs, device="cpu")
  assert _l1(got, want) < 1.0
  if case == "empty":
    tt.assert_array_equal(got, np.full((32, 32, 3), 255, np.uint8))


def test_renders_match_the_goldens():
  """tests/test_viz.py's golden images, with its L1 < 1.0."""
  tris = cube_mesh(0.25, 0.75)
  colors = np.tile(np.array([[0.894, 0.102, 0.110]], np.float32), (12, 1))
  cam = camera.default_camera([0, 0, 0], [1, 1, 1])
  mesh = renderer.render_mesh(tris, colors, cam, (128, 128), device="cpu")
  golden = np.asarray(PIL.Image.open(os.path.join(GOLDEN,
                                                  "expected_image_mesh.png")))
  assert _l1(mesh, golden) < 1.0
  grid = np.zeros((16, 16, 16), np.int32)
  grid[4:12, 4:12, 4:12] = 1
  grid[6:10, 6:10, 11:16] = 2
  voxels = renderer.render_voxel_grid(grid, image_size=(128, 128),
                                      device="cpu")
  golden = np.asarray(PIL.Image.open(
      os.path.join(GOLDEN, "expected_image_voxels.png")))
  assert _l1(voxels, golden) < 1.0


def test_renderers_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    renderer.render_mesh(cube_mesh(), np.ones((12, 3), np.float32),
                         np.eye(4, dtype=np.float32))
  with pytest.raises(RuntimeError, match="no CUDA device"):
    renderer.render_voxel_grid(np.ones((2, 2, 2), np.int32))


def _volume(name):
  rng = np.random.default_rng(7)
  if name == "sphere":
    z, y, x = np.mgrid[:20, :20, :20].astype(np.float32)
    return (np.sqrt((x - 9.5) ** 2 + (y - 9.5) ** 2 + (z - 9.5) ** 2) < 7
            ).astype(np.float32)
  if name == "noise":
    return rng.random((9, 11, 10)).astype(np.float32)
  if name == "box_filtered_blob":
    v = np.zeros((12, 12, 12), np.float32)
    v[3:9, 2:10, 4:8] = 1.0
    return isosurface.box_filter3d(v, 3)
  raise ValueError(name)


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("name", ["sphere", "noise", "box_filtered_blob"])
def test_isosurface_is_bit_equal_to_jax(name, pad):
  v = _volume(name)
  for size in (1, 2, 3):
    assert np.array_equal(isosurface.box_filter3d(v, size),
                          jax_isosurface.box_filter3d(v, size))
  got = isosurface.marching_tetrahedra(v, 0.5, pad=pad)
  want = jax_isosurface.marching_tetrahedra(v, 0.5, pad=pad)
  assert got.dtype == want.dtype == np.float32 and got.shape[0] > 10
  assert np.array_equal(got, want)
  assert (isosurface.count_active_cells(v, 0.5, pad=pad) ==
          jax_isosurface.count_active_cells(v, 0.5, pad=pad))


def test_class_meshes_are_bit_equal_to_jax():
  rng = np.random.default_rng(3)
  labels = rng.integers(0, 3, (8, 9, 10)).astype(np.int32)
  pmf = rng.random((3, 8, 9, 10)).astype(np.float32)
  for grid, kernel in ((labels, 1), (pmf, 3)):
    got = isosurface.extract_class_meshes(grid, 3, filter_kernel=kernel)
    want = jax_isosurface.extract_class_meshes(grid, 3, filter_kernel=kernel)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
      assert np.array_equal(a, b)


TRANSFORM_CASES = {
    "scale": lambda g: g.scale([2.0, 0.5, 3.0]),
    "translate_batched": lambda g: g.translate(
        np.arange(12, dtype=np.float32).reshape(2, 2, 3)),
    "rotate": lambda g: g.rotate(0.7, [0.3, -1.0, 0.5]),
    "transform_points_homogeneous": lambda g: g.transform_points_homogeneous(
        np.linspace(-1, 1, 24, dtype=np.float32).reshape(2, 4, 3),
        np.stack([np.eye(4), np.diag([1, 2, 3, 1.0])]).astype(np.float32),
        w=0),
    "transform_points": lambda g: g.transform_points(
        np.linspace(-1, 1, 12, dtype=np.float32).reshape(4, 3),
        g.perspective_rh(0.9, 1.3, 0.1, 10.0)),
    "transform_mesh_points": lambda g: g.transform_mesh(
        cube_mesh(), g.chain([g.translate([0.1, 0.2, 0.3]),
                              g.rotate(0.4, [0, 0, 1])])),
    "transform_mesh_vectors": lambda g: g.transform_mesh(
        cube_mesh(), g.rotate(1.1, [1, 1, 0]), vertices_are_points=False),
    "look_at_lh": lambda g: g.look_at_lh([1, 2, 3], [0, 0.5, 0], [0, 1, 0]),
    "look_at_rh": lambda g: g.look_at_rh([1, 2, 3], [0, 0.5, 0], [0, 1, 0]),
    "perspective_lh": lambda g: g.perspective_lh(0.8, 1.5, 0.2, 30.0),
    "perspective_rh": lambda g: g.perspective_rh(0.8, 1.5, 0.2, 30.0),
    "ortho_lh": lambda g: g.ortho_lh(-1, 2, -0.5, 1.5, 0.1, 9.0),
    "chain": lambda g: g.chain([g.scale([1, 2, 3]), g.translate([1, 0, 0]),
                                g.rotate(0.3, [0, 1, 0])]),
}


@pytest.mark.parametrize("case", sorted(TRANSFORM_CASES))
def test_transforms_match_jax(case):
  got = TRANSFORM_CASES[case](geom)
  want = np.asarray(TRANSFORM_CASES[case](jax_geom))
  assert isinstance(got, np.ndarray) and got.dtype == np.float32
  assert got.shape == want.shape
  tt.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_cameras_match_jax():
  box = (np.array([-0.2, 0.1, 0.3], np.float32),
         np.array([0.9, 1.4, 0.8], np.float32))
  pairs = [(camera.default_camera(*box), jax_camera.default_camera(*box)),
           (camera.frontal_camera(*box), jax_camera.frontal_camera(*box)),
           (camera.perspective_flipped_y(0.7, 1.2, 0.1, 5.0),
            jax_camera.perspective_flipped_y(0.7, 1.2, 0.1, 5.0))]
  pairs += zip(camera.tetrahedron_cameras(*box),
               jax_camera.tetrahedron_cameras(*box))
  assert len(pairs) == 7
  for got, want in pairs:
    tt.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


def _scene_output(seed=0, res=16):
  """A PMF with a noisy blob of class 1, its GT grid, a GT mesh, and the
  grid → view transform the eval pipeline builds."""
  rng = np.random.default_rng(seed)
  z, y, x = np.mgrid[:res, :res, :res].astype(np.float32) + 0.5
  r = np.sqrt((x - 8.3) ** 2 + (y - 7.6) ** 2 + (z - 8.9) ** 2)
  fg = np.clip(1.5 - r / 4 + rng.normal(0, 0.05, r.shape), 0, 1)
  pmf = np.stack([1 - fg, fg], -1).astype(np.float32)
  gt = (r < 4.5).astype(np.int32)
  w2x = np.eye(4, dtype=np.float32)
  w2x[:3, :3] *= res
  w2x[:3, 3] = 0.5 - 0.5
  image = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
  return image, pmf, gt, [cube_mesh(0.3, 0.7) + OFF_TIES], [1], \
      np.linalg.inv(w2x)


@pytest.mark.parametrize("max_surface_triangles", [30_000, 10])
def test_scene_tile_matches_jax(max_surface_triangles):
  """visualize_scene_output: the extracted-surface column, and the raycast
  isosurface it falls back to above the triangle cap."""
  inputs = _scene_output()
  want = jax_qualitative.visualize_scene_output(
      *inputs, image_size=(64, 64),
      max_surface_triangles=max_surface_triangles)
  got = qualitative.visualize_scene_output(
      *inputs, image_size=(64, 64),
      max_surface_triangles=max_surface_triangles, device="cpu")
  assert got.shape == want.shape == (5 * 64, 5 * 64, 3)
  assert _l1(got, want) < 1.0
  # The surface column shows the blob in both ways of drawing it.
  assert (got[:64, 64:128] != 255).any()


def test_image_artifact_resizes_like_pil():
  image = np.random.default_rng(1).integers(0, 256, (30, 50, 3),
                                            dtype=np.uint8)
  got = artifacts.ImageArtifact(image).render(None, (64, 96), "cpu")
  want = jax_artifacts.ImageArtifact(image).render(None, (64, 96))
  assert _l1(got, want) < 1.0
  same = artifacts.ImageArtifact(image).render(None, (30, 50), "cpu")
  tt.assert_array_equal(same, image)


def test_png_bytes_decode_through_pil():
  rng = np.random.default_rng(2)
  for shape in ((1, 1, 3), (17, 5, 3), (64, 80, 3)):
    image = rng.integers(0, 256, shape, dtype=np.uint8)
    data = encode_png(image)
    tt.assert_array_equal(np.asarray(PIL.Image.open(io.BytesIO(data))), image)
    tt.assert_array_equal(decode_png(data), image)
  with pytest.raises(ValueError, match="expected uint8"):
    encode_png(np.zeros((4, 4), np.uint8))
  with pytest.raises(ValueError, match="CRC"):
    decode_png(data[:20] + bytes([data[20] ^ 1]) + data[21:])


def test_load_textures_and_textured_scene_match_jax():
  def png(image):
    buf = io.BytesIO()
    PIL.Image.fromarray(image).save(buf, format="PNG")
    return buf.getvalue()

  a = np.zeros((4, 4, 3), np.uint8)
  a[0] = [255, 0, 0]
  b = np.full((8, 8, 3), 64, np.uint8)
  args = ([png(a), b"", png(b), png(a)],)
  got, want = (scene_renderer.load_textures(*args, texture_size=(4, 4)),
               jax_scene_renderer.load_textures(*args, texture_size=(4, 4)))
  for x, y in zip(got, want):
    tt.assert_array_equal(x, y)

  quad = np.array([[[0, 0, 0.5], [1, 0, 0.5], [1, 1, 0.5]],
                   [[0, 0, 0.5], [1, 1, 0.5], [0, 1, 0.5]]], np.float32)
  uvs = np.array([[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]],
                 np.float32)
  stripes = np.zeros((8, 8, 3), np.uint8)
  stripes[::2, :, 0] = 255
  stripes[1::2, :, 2] = 255
  fields = dict(
      mesh_vertices=[quad + OFF_TIES],
      view_transform=np.eye(4, dtype=np.float32),
      o2w_transforms=np.eye(4, dtype=np.float32)[None],
      camera_transform=np.array([[2, 0, 0, -1], [0, 2, 0, -1],
                                 [0, 0, 2, -1], [0, 0, 0, 1]], np.float32),
      mesh_labels=["x"], mesh_visible_fractions=np.ones([1], np.float32),
      opengl_image=np.zeros((4, 4, 3), np.uint8),
      pbrt_image=np.zeros((4, 4, 3), np.uint8),
      texcoords=[uvs], material_ids=[np.zeros((2,), np.int32)],
      diffuse_colors=[np.array([[0, 0, 1]], np.float32)],
      diffuse_texture_pngs=[[png(stripes)]])
  got = scene_renderer.render_scene(scene_lib.Scene(**fields),
                                    image_size=(32, 32), device="cpu")
  want = jax_scene_renderer.render_scene(jax_scene.Scene(**fields),
                                         image_size=(32, 32))
  assert _l1(got, want) < 1.0
  assert got[16, 16, 0] > 50  # the red and blue stripes, not flat blue


def test_fixture_scene_renders_like_jax(tmp_path):
  manifest, meshes_dir = make_fixture_dataset(str(tmp_path), num_scenes=1)
  path = os.path.join(os.path.dirname(manifest),
                      json.load(open(manifest))["files"][0])
  got = scene_renderer.render_scene(
      scene_lib.load_from_npz(path, meshes_dir), image_size=(64, 64),
      device="cpu")
  want = jax_scene_renderer.render_scene(
      jax_scene.load_from_npz(path, meshes_dir), image_size=(64, 64))
  assert _l1(got, want) < 1.0 and (got != 255).any()


def test_qualitative_results_write_tiles_and_summaries(tmp_path):
  writer = SummaryWriter(str(tmp_path / "tb"), use_tensorboard=False)
  results = qualitative.QualitativeResults(
      str(tmp_path / "out"), num_results=2, num_results_in_summary=1,
      summary_writer=writer, image_size=(32, 32), device="cpu")
  inputs = _scene_output(seed=1)
  for scene_id in ("scenes/s1", "scenes/s2", "scenes/s3"):
    results.add_scene(scene_id, *inputs)
  assert not results.want_more()
  assert sorted(os.listdir(tmp_path / "out")) == ["img_scenes_s1.png",
                                                   "img_scenes_s2.png"]
  tile = decode_png((tmp_path / "out" / "img_scenes_s1.png").read_bytes())
  tt.assert_array_equal(tile, qualitative.visualize_scene_output(
      *inputs, image_size=(32, 32), device="cpu"))
  assert not any(n.endswith(".png") for n in os.listdir(tmp_path / "tb"))
  results.write_summaries(7)
  writer.add_scalar("IoU/a", 0.25, 7)
  writer.close()
  tt.assert_array_equal(
      decode_png((tmp_path / "tb" / "rec_0_7.png").read_bytes()), tile)
  lines = (tmp_path / "tb" / "scalars.jsonl").read_text().splitlines()
  assert [json.loads(line)["tag"] for line in lines] == ["IoU/a"]
  assert json.loads(lines[0])["value"] == 0.25
