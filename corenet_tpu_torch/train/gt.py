"""On-device ground-truth voxelization for the training step.

Counterpart of corenet_tpu/train/gt.py, blocked rasterizer only: a
batch's subdivided triangles become, on its device, either a labeled grid
(`voxelize_batch`) or, for FG_BG, one bit-packed grid per scene
(`voxelize_batch_packed_fgbg`), which the phase-loss step turns into
phase-major labels with ops/phased_gt.py. The configurations the blocked
rasterizer does not serve (voxel/raster_fast.py::blocked_eligible: sub-grid
sampling, non-cubic grids, windows wider than the subdivision contract)
need the general rasterizer, which is not ported yet; they raise.

Per-scene layout (data/batching.py):
  triangles      float32[B, T, 3, 3]   view space, padded
  tri_mesh_slot  int32[B, T]           mesh slot within the scene
  tri_valid      bool[B, T]
  mesh_labels    int32[B, M]           voxel value per mesh slot (0 = none)
  grid_offset    float32[B, 3]         in-voxel sampling offset

The view → voxel transform is scale(m), m = max(D, H, W), followed by a
shift of grid_offset − 0.5, so voxels are tested at their sampled
locations; the returned v2x is the unshifted scale.
"""

from __future__ import annotations

import torch

from corenet_tpu_torch.voxel import raster_fast

_GENERAL_PATH = (
    "needs the general rasterizer (sub-grid sampling, non-cubic grids, "
    "projection depth multipliers, windows beyond the subdivision "
    "contract), which comes with the port's next slice (ROADMAP slice 4)")


def _v2x(b: int, m: float, device) -> torch.Tensor:
  """The unshifted view → voxel transform diag(m, m, m, 1), [B, 4, 4]."""
  diag = torch.tensor([m, m, m, 1.0], dtype=torch.float32, device=device)
  return torch.diag(diag).expand(b, 4, 4).contiguous()


def _view2voxel_uniform(grid_offsets: torch.Tensor, m: float,
                        num_mesh_slots: int) -> torch.Tensor:
  """Per-scene scale(m) + (grid_offset − 0.5) shift, the same for every
  mesh slot: [B, M, 4, 4]."""
  b = grid_offsets.shape[0]
  w2x = _v2x(b, m, grid_offsets.device)
  w2x[:, :3, 3] = grid_offsets - 0.5
  return w2x[:, None].expand(b, num_mesh_slots, 4, 4)


def packed_fgbg_eligible(**kwargs) -> bool:
  """Whether the blocked rasterizer, and so the bit-packed FG_BG path
  (voxelize_batch_packed_fgbg), serves these voxelization kwargs."""
  return raster_fast.blocked_eligible(
      resolution=kwargs["resolution"],
      sub_grid_sampling=kwargs.get("sub_grid_sampling", False),
      image_resolution_multiplier=kwargs.get(
          "image_resolution_multiplier", 4),
      projection_depth_multiplier=kwargs.get(
          "projection_depth_multiplier", 1),
      max_bbox_pixels=kwargs.get("max_bbox_pixels"))


def _blocked_settings(grid_offsets, num_mesh_slots, m, **kwargs):
  """The blocked rasterizer's view → voxel matrices and settings from the
  voxelization kwargs."""
  return _view2voxel_uniform(grid_offsets, m, num_mesh_slots), dict(
      num_meshes=num_mesh_slots, resolution=tuple(kwargs["resolution"]),
      image_resolution_multiplier=int(kwargs.get(
          "image_resolution_multiplier", 4)),
      conservative_rasterization=kwargs.get(
          "conservative_rasterization", True),
      fill_inside=kwargs.get("fill_inside", True),
      fill_rounds=kwargs.get("fill_rounds"))


def _blocked_batch(triangles, tri_mesh_slot, tri_valid, mesh_labels,
                   grid_offsets, m, label_dtype, **kwargs):
  """Blocked rasterizer → label_dtype[B, D, H, W]: each voxel holds the
  largest label of the meshes that occupy or enclose it."""
  view2voxel, settings = _blocked_settings(grid_offsets, mesh_labels.shape[1],
                                           m, **kwargs)
  grids = raster_fast.voxelize_blocked(triangles, tri_mesh_slot, view2voxel,
                                       tri_valid, dtype=label_dtype,
                                       **settings)  # [B, M, D, H, W]
  labeled = grids * mesh_labels.to(label_dtype)[:, :, None, None, None]
  return labeled.amax(dim=1)


def voxelize_batch_packed_fgbg(triangles, tri_mesh_slot, tri_valid,
                               mesh_labels, grid_offsets, **kwargs):
  """Binary (FG_BG) ground truth as bit-packed grids: (int32[B, H, W, NW],
  bit = 1 where a mesh with label > 0 occupies or encloses the voxel;
  v2x float32[B, 4, 4]). The unpacked grid is never made. The caller
  checks packed_fgbg_eligible first."""
  d, h, w = kwargs["resolution"]
  m = float(max(d, h, w))
  b, num_mesh_slots = mesh_labels.shape
  view2voxel, settings = _blocked_settings(grid_offsets, num_mesh_slots, m,
                                           **kwargs)
  packed = raster_fast.voxelize_blocked_packed(
      triangles, tri_mesh_slot, view2voxel, tri_valid, **settings)
  # OR over the slots with a label (FG_BG labels are 0/1).
  masked = torch.where((mesh_labels > 0)[:, :, None, None, None], packed, 0)
  out = masked[:, 0]
  for slot in range(1, num_mesh_slots):
    out = out | masked[:, slot]
  return out.contiguous(), _v2x(b, m, triangles.device)


def voxelize_batch(triangles, tri_mesh_slot, tri_valid, mesh_labels,
                   grid_offsets, **kwargs):
  """Batched ground-truth voxelization → (labels [B, D, H, W], v2x
  float32[B, 4, 4]).

  Each voxel holds the largest label of the meshes that occupy or enclose
  it. num_label_values (the number of distinct label values, when known)
  ≤ 256 attests that labels fit a byte: the grid is uint8; without it the
  grid is int32 (same values). Configurations the blocked rasterizer does
  not serve raise NotImplementedError, as does num_label_values > 256."""
  kwargs = dict(kwargs)
  num_label_values = kwargs.pop("num_label_values", None)
  if not packed_fgbg_eligible(**kwargs):
    raise NotImplementedError(f"voxelization {kwargs} {_GENERAL_PATH}")
  if num_label_values is not None and num_label_values > 256:
    raise NotImplementedError(
        f"num_label_values {num_label_values} > 256 {_GENERAL_PATH}")
  d, h, w = kwargs["resolution"]
  m = float(max(d, h, w))
  label_dtype = torch.uint8 if num_label_values is not None else torch.int32
  grid = _blocked_batch(triangles, tri_mesh_slot, tri_valid, mesh_labels,
                        grid_offsets, m, label_dtype, **kwargs)
  return grid, _v2x(triangles.shape[0], m, triangles.device)
