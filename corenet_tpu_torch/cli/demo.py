"""Single-scene reconstruction demo (the role of corenet_demo.ipynb).

Counterpart of corenet_tpu/cli/demo.py: loads a `.cpt` checkpoint (written
by either package) or a frozen TF graph (`.pb`, through eval/tf_model.py;
TensorFlow is optional), reconstructs one scene NPZ, voxelizes its meshes
as the ground truth (image resolution multiplier 4, a 24-pixel window),
and writes a qualitative tile as PNG (utils/png.py):
[input image | predicted surface | predicted voxels | GT voxels | GT mesh]
under five cameras.

Usage:
  python -m corenet_tpu_torch.cli.demo --scene=<scene.npz> \\
      --meshes_dir=<dir> --checkpoint=<state.cpt | model.pb> \\
      --output=recon.png \\
      [--resolution=128] [--device=cpu]
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from corenet_tpu_torch.utils import flags, fs
from corenet_tpu_torch.utils.device import checked_device

log = logging.getLogger(__name__)

DEMO_IMAGE_RESOLUTION_MULTIPLIER = 4
DEMO_WINDOW_PIXELS = 24


@dataclasses.dataclass
class ProgramArgs:
  scene: str = flags.flag("Path to a scene NPZ")
  meshes_dir: str = flags.flag("Directory with mesh NPZs")
  checkpoint: str = flags.flag("corenet-tpu .cpt or frozen-TF .pb")
  output: str = flags.flag("Output PNG path", default="reconstruction.png")
  resolution: int = flags.flag("Output grid resolution", default=128)
  high_realism: bool = flags.flag("Use the PBRT render as input",
                                  default=True)
  packed_inference: bool = flags.flag(
      "Packed (space-to-depth) decoder execution for eligible models: the "
      "same weights, logits within the convolutions' rounding",
      default=True)
  device: str = flags.flag(
      "Torch device to run on; without a CUDA card pass 'cpu'",
      default="cuda")


def main(argv=None):
  logging.basicConfig(level=logging.INFO)
  args = flags.parse_flags(ProgramArgs, argv)
  device = checked_device(args.device)

  from corenet_tpu_torch.cli.eval import load_model
  from corenet_tpu_torch.data import batching, scene as scene_lib
  from corenet_tpu_torch.data.dataset import DatasetElement
  from corenet_tpu_torch.eval.qualitative import visualize_scene_output
  from corenet_tpu_torch.eval.super_resolution import (
      super_resolution_from_model)
  from corenet_tpu_torch.train import gt as gt_lib
  from corenet_tpu_torch.utils.png import encode_png

  sc = scene_lib.load_from_npz(args.scene, args.meshes_dir)
  element = DatasetElement(
      scene_id=fs.splitext(fs.basename(args.scene))[0],
      mesh_vertices=np.concatenate(sc.mesh_vertices, 0),
      mesh_num_tri=np.array([v.shape[0] for v in sc.mesh_vertices],
                            np.int32),
      view_transform=sc.view_transform,
      camera_transform=sc.camera_transform,
      o2w_transforms=sc.o2w_transforms,
      mesh_labels=np.arange(1, len(sc.mesh_vertices) + 1, dtype=np.int32),
      input_image=(sc.pbrt_image if args.high_realism else sc.opengl_image))

  res = (args.resolution,) * 3
  m = float(args.resolution)
  hb = batching.batch([element], max_edge_view=5.0 / m)
  inputs = {k: torch.from_numpy(v).to(device)
            for k, v in hb.step_inputs("MESH_INDEX").items()}
  grid, v2x = gt_lib.voxelize_batch(
      inputs["triangles"], inputs["tri_mesh_slot"], inputs["tri_valid"],
      inputs["mesh_labels"], inputs["grid_offset"], resolution=res,
      image_resolution_multiplier=DEMO_IMAGE_RESOLUTION_MULTIPLIER,
      max_bbox_pixels=DEMO_WINDOW_PIXELS)

  if args.checkpoint.endswith(".pb"):
    from corenet_tpu_torch.eval.tf_model import (
        super_resolution_from_tf_model)
    inference = super_resolution_from_tf_model(args.checkpoint,
                                               device=device)
  else:
    model, _, _, _ = load_model(args.checkpoint)
    inference = super_resolution_from_model(
        model, model.state_dict(), model.config.decoder.resolution,
        packed_execution=args.packed_inference, device=device)
  pmf = inference(inputs["image"], inputs["camera"], v2x,
                  inputs["grid_offset"], res)

  w2x = np.eye(4, dtype=np.float32)
  w2x[:3, :3] *= m
  meshes = [hb.triangles[0][hb.tri_valid[0] & (hb.tri_mesh_slot[0] == j)]
            for j in range(int(hb.mesh_valid[0].sum()))]
  tile = visualize_scene_output(
      hb.image[0], pmf[0].cpu().numpy(), grid[0].cpu().numpy(), meshes,
      list(hb.mesh_labels[0]), np.linalg.inv(w2x), device=device)
  fs.write_bytes(args.output, encode_png(tile))
  log.info("Wrote %s", args.output)
  return tile


if __name__ == "__main__":
  main()
