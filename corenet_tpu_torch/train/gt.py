"""On-device ground-truth voxelization for the training step.

Counterpart of corenet_tpu/train/gt.py: a batch's triangles become, on
its device, either a labeled grid (`voxelize_batch`) or, for FG_BG, one
bit-packed grid per scene (`voxelize_batch_packed_fgbg`), which the
phase-loss step turns into phase-major labels with ops/phased_gt.py.
`voxelize_batch` takes the blocked rasterizer (voxel/raster_fast.py: the
block_scatter_or kernel and the packed fill) where the configuration
meets its contract, and the general one (voxel/voxelize.py with the dense
fill of voxel/fill.py) for the rest: sub-grid sampling, non-cubic grids,
projection depth multipliers, windows wider than the subdivision
contract, more than 256 label values.

Per-scene layout (data/batching.py):
  triangles      float32[B, T, 3, 3]   view space, padded
  tri_mesh_slot  int32[B, T]           mesh slot within the scene
  tri_valid      bool[B, T]
  mesh_labels    int32[B, M]           voxel value per mesh slot (0 = none)
  grid_offset    float32[B, 3]         in-voxel sampling offset

The view → voxel transform is scale(m), m = max(D, H, W), followed by a
shift of grid_offset − 0.5, so voxels are tested at their sampled
locations; the returned v2x is the unshifted scale.

Under the 'space' axis (parallel/mesh.py) a rank trains on its depth slab
of the labels. The blocked routes (K3, and K4 for the phased labels) share
the voxelization over the space group as the JAX package does
(corenet_tpu/parallel/kernel_sharding.py's allow_space_batch): where the
data group's batch divides by the space count, each space rank voxelizes
its share of the scenes and the ranks trade depth slabs with an
all-to-all (`space_shared`). Elsewhere (a batch that does not divide, the
general rasterizer, the parity GT, a grid from the host) every space rank
holds the whole labels and keeps its slab (`depth_slab`), where the JAX
package would take its general voxelizer. The labels are the same bits
either way.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from corenet_tpu_torch.parallel import mesh
from corenet_tpu_torch.utils import tracing
from corenet_tpu_torch.voxel import raster_fast
from corenet_tpu_torch.voxel.fill import fill_inside_voxels
from corenet_tpu_torch.voxel.voxelize import (
    get_sub_grid_centers, voxelize_triangles)


def _slab_depth(depth: int, count: int) -> int:
  if depth % count:
    raise ValueError(f"a depth of {depth} does not split into {count} "
                     "slabs")
  return depth // count


def depth_slab(labels: torch.Tensor, depth_shard: Tuple[int, int]
               ) -> torch.Tensor:
  """Slab `index` of `count` equal slabs of dim 1, for depth_shard =
  (index, count): the depth of a grid [B, D, H, W], or the coarse depth
  of phase-major labels [B, D/s, H/s, (W/s)·s³], whose slabs are
  fine-contiguous. A view; `labels` itself for a count of 1."""
  index, count = depth_shard
  if count == 1:
    return labels
  depth = _slab_depth(labels.shape[1], count)
  return labels.narrow(1, index * depth, depth)


def shares_over_space(batch_size: int, depth_shard: Tuple[int, int]) -> bool:
  """Whether `space_shared` serves a batch: a space group of more than one
  rank whose count divides the batch (the JAX package's
  `batch % (data · space) == 0` for a data group's batch)."""
  count = depth_shard[1]
  return count > 1 and batch_size % count == 0


GroundTruth = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def space_shared(ground_truth: GroundTruth, arrays: Sequence[torch.Tensor],
                 depth_shard: Tuple[int, int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
  """`labels_slab` with the voxelization shared over the space group:
  space rank k runs `ground_truth` on scenes [k·B/S, (k+1)·B/S) of the
  batch arrays, cuts each scene's labels into S depth slabs along dim 1
  and sends slab j to rank j (`mesh.space_all_to_all`); it returns its
  slab of all B scenes in batch order, contiguous, the same bits as
  `depth_slab` of the whole batch's labels, and the batch's v2x.
  `ground_truth` maps arrays with leading dim B/S to (labels [B/S, depth,
  ...], v2x [B/S, 4, 4]), each scene's alone, and v2x the same for every
  scene (the blocked voxelizers' unshifted scale). S must be more than 1
  and divide B."""
  index, count = depth_shard
  b = arrays[0].shape[0]
  if not shares_over_space(b, depth_shard):
    raise ValueError(f"a batch of {b} does not share over {count} space "
                     "ranks")
  tracing.count("gt.route.space_shared")
  per = b // count
  mine, v2x = ground_truth(*(a[index * per:(index + 1) * per]
                             for a in arrays))
  rest = tuple(mine.shape[2:])
  depth = _slab_depth(mine.shape[1], count)
  slabs = mine.reshape((per, count, depth) + rest).transpose(0, 1)
  labels = mesh.space_all_to_all(slabs).reshape((b, depth) + rest)
  return labels, v2x[:1].expand((b,) + tuple(v2x.shape[1:])).contiguous()


def labels_slab(ground_truth: GroundTruth, arrays: Sequence[torch.Tensor],
                depth_shard: Tuple[int, int], shareable: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(this rank's depth slab of the labels, v2x) for `ground_truth(*arrays)`
  → (labels [B, depth, ...], v2x [B, 4, 4]): the one place that picks the
  labels' route. A `shareable` ground truth (a blocked route, each scene
  voxelized alone) is shared over the space group where the batch divides
  (`space_shared`); any other, or a batch that does not divide, is made
  whole on every rank and cut (`depth_slab`)."""
  if shareable and shares_over_space(arrays[0].shape[0], depth_shard):
    return space_shared(ground_truth, arrays, depth_shard)
  if depth_shard[1] > 1:
    tracing.count("gt.route.replicated")
  labels, v2x = ground_truth(*arrays)
  return depth_slab(labels, depth_shard), v2x


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


def _general_batch(triangles: torch.Tensor,
                   tri_mesh_slot: torch.Tensor,
                   tri_valid: torch.Tensor,
                   mesh_labels: torch.Tensor,
                   grid_offsets: torch.Tensor,
                   *,
                   resolution: Tuple[int, int, int],
                   sub_grid_sampling: bool = False,
                   image_resolution_multiplier: float = 4,
                   conservative_rasterization: bool = True,
                   projection_depth_multiplier: int = 1,
                   fill_inside: bool = True,
                   max_bbox_pixels: Optional[int] = None,
                   fill_rounds: Optional[int] = None) -> torch.Tensor:
  """General rasterizer → dense fill → sub-grid centres → labels:
  int32[B, D, H, W]. The scenes' mesh slots are rasterized and filled as
  one array of B·M meshes (triangles do not interact, so the grids are
  those of one call per scene)."""
  d, h, w = resolution
  b, num_mesh_slots = mesh_labels.shape
  view2voxel = _view2voxel_uniform(grid_offsets, float(max(d, h, w)),
                                   num_mesh_slots)
  scene = torch.arange(b, dtype=tri_mesh_slot.dtype,
                       device=tri_mesh_slot.device)[:, None]
  # A slot outside the scene's drops the triangle; it must not reach a
  # neighbouring scene's slots.
  in_scene = (tri_mesh_slot >= 0) & (tri_mesh_slot < num_mesh_slots)
  mesh_grids = voxelize_triangles(
      triangles.reshape(-1, 3, 3),
      (scene * num_mesh_slots + tri_mesh_slot).reshape(-1),
      view2voxel.reshape(b * num_mesh_slots, 4, 4),
      (tri_valid & in_scene).reshape(-1),
      num_meshes=b * num_mesh_slots, resolution=tuple(resolution),
      sub_grid_sampling=sub_grid_sampling,
      image_resolution_multiplier=image_resolution_multiplier,
      conservative_rasterization=conservative_rasterization,
      projection_depth_multiplier=projection_depth_multiplier,
      max_bbox_pixels=max_bbox_pixels)
  if fill_inside:
    mesh_grids = fill_inside_voxels(mesh_grids, fill_rounds=fill_rounds)
  if sub_grid_sampling:
    mesh_grids = get_sub_grid_centers(mesh_grids)
  labeled = (mesh_grids.reshape(b, num_mesh_slots, d, h, w)
             * mesh_labels.to(torch.float32)[:, :, None, None, None])
  return labeled.amax(dim=1).to(torch.int32)


def voxelize_scene(triangles: torch.Tensor,      # float32[T, 3, 3]
                   tri_mesh_slot: torch.Tensor,  # int32[T]
                   tri_valid: torch.Tensor,      # bool[T]
                   mesh_labels: torch.Tensor,    # int32[M]
                   grid_offset: torch.Tensor,    # float32[3]
                   **kwargs) -> torch.Tensor:
  """Voxelizes one scene with the general rasterizer into an int32
  [D, H, W] labeled grid. kwargs: resolution, sub_grid_sampling,
  image_resolution_multiplier, conservative_rasterization,
  projection_depth_multiplier, fill_inside, max_bbox_pixels, fill_rounds
  (a static interior-fill round count; None = adaptive fixpoint)."""
  return _general_batch(triangles[None], tri_mesh_slot[None],
                        tri_valid[None], mesh_labels[None],
                        grid_offset[None], **kwargs)[0]


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


def blocked_grid_eligible(**kwargs) -> bool:
  """Whether `voxelize_batch` takes the blocked rasterizer for these
  kwargs: packed_fgbg_eligible, and num_label_values (when known) ≤ 256."""
  num_label_values = kwargs.pop("num_label_values", None)
  return ((num_label_values is None or num_label_values <= 256)
          and packed_fgbg_eligible(**kwargs))


def voxelize_batch(triangles, tri_mesh_slot, tri_valid, mesh_labels,
                   grid_offsets, **kwargs):
  """Batched ground-truth voxelization → (labels [B, D, H, W], v2x
  float32[B, 4, 4]).

  Each voxel holds the largest label of the meshes that occupy or enclose
  it. Where the blocked rasterizer serves the configuration
  (packed_fgbg_eligible) it is used: num_label_values (the number of
  distinct label values, when known) ≤ 256 attests that labels fit a byte,
  and the grid is uint8; without it the grid is int32 (same values). Every
  other configuration, and num_label_values > 256, takes the general
  rasterizer and returns int32."""
  kwargs = dict(kwargs)
  num_label_values = kwargs.pop("num_label_values", None)
  d, h, w = kwargs["resolution"]
  m = float(max(d, h, w))
  if blocked_grid_eligible(num_label_values=num_label_values, **kwargs):
    label_dtype = (torch.uint8 if num_label_values is not None
                   else torch.int32)
    grid = _blocked_batch(triangles, tri_mesh_slot, tri_valid, mesh_labels,
                          grid_offsets, m, label_dtype, **kwargs)
  else:
    grid = _general_batch(triangles, tri_mesh_slot, tri_valid, mesh_labels,
                          grid_offsets, **kwargs)
  return grid, _v2x(triangles.shape[0], m, triangles.device)
