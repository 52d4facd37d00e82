"""The blocked rasterizer in one step, triangles in and OR-ed occupancy
words out: a CUDA kernel for CUDA tensors, its plain PyTorch version for
CPU tensors.

Counterpart of corenet_tpu/voxel/raster_fast.py's phase A together with
corenet_tpu/ops/block_scatter.py::block_scatter_or. The plain version is
that composition in the port, `voxel/raster_fast.py::_phase_a` (the
per-triangle blocks and origins) followed by
`ops/block_scatter.py::block_scatter_or_reference`; the kernel,
`csrc/blocked_raster.cu`, gives the same words bit for bit without the
block tensor and the sample temporaries between the two. Its note says
what bounds it and how it is laid out.

  triangles f32[B, T, 3, 3], tri_mesh_slot i32[B, T],
  view2voxel f32[B, M', 4, 4] (slot 0's matrix per scene), tri_valid
  bool[B, T] → int32[B, meshes, m, m·NW] (NW = m / 32), the words holding
  uint32 bit patterns (voxel/packed.py's layout once reshaped to
  [B, meshes, m, m, NW]).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from corenet_tpu_torch import kernels
from corenet_tpu_torch.ops.block_scatter import block_scatter_or_reference

# Launches of the CUDA kernel in this process. Incremented only where the
# kernel is launched, so a run can show that its path went through it.
launch_count = 0

_SIGNATURES = {
    "blocked_raster_fwd": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
                           ctypes.c_int),
    "blocked_raster_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def blocked_raster_reference(triangles, tri_mesh_slot, view2voxel,
                             tri_valid, *, meshes: int, m: int, irm: int,
                             conservative: bool) -> torch.Tensor:
  """The plain version: phase A's blocks, then the scatter's plain
  version."""
  # Imported here: voxel/raster_fast.py imports this module.
  from corenet_tpu_torch.voxel import raster_fast
  origins, pw = raster_fast._phase_a(triangles, tri_mesh_slot, view2voxel,
                                     tri_valid, m=m, irm=irm,
                                     conservative=conservative)
  return block_scatter_or_reference(origins, pw, meshes=meshes, h=m, w=m,
                                    nw=m // 32)


def _check(triangles, tri_mesh_slot, view2voxel, tri_valid, meshes, m, irm):
  dtypes = ((triangles, torch.float32), (tri_mesh_slot, torch.int32),
            (view2voxel, torch.float32), (tri_valid, torch.bool))
  if any(x.dtype != dtype for x, dtype in dtypes):
    raise TypeError(f"triangles, tri_mesh_slot, view2voxel and tri_valid "
                    f"must be float32, int32, float32 and bool, got "
                    f"{[x.dtype for x, _ in dtypes]}")
  if triangles.dim() != 4 or triangles.shape[2:] != (3, 3):
    raise ValueError(f"triangles must be [B, T, 3, 3], got "
                     f"{tuple(triangles.shape)}")
  bt = triangles.shape[:2]
  if tri_mesh_slot.shape != bt or tri_valid.shape != bt:
    raise ValueError(f"tri_mesh_slot and tri_valid must be {tuple(bt)}, got "
                     f"{tuple(tri_mesh_slot.shape)} and "
                     f"{tuple(tri_valid.shape)}")
  if (view2voxel.dim() != 4 or view2voxel.shape[0] != bt[0]
      or view2voxel.shape[1] < 1 or view2voxel.shape[2:] != (4, 4)):
    raise ValueError(f"view2voxel must be [{bt[0]}, M, 4, 4], got "
                     f"{tuple(view2voxel.shape)}")
  if m < 32 or m % 32 or meshes < 1 or irm < 1:
    raise ValueError(f"bad grid: m {m} (a multiple of 32), meshes {meshes}, "
                     f"irm {irm}")
  device = triangles.device
  if device.type not in ("cpu", "cuda"):
    raise ValueError(f"blocked_raster_or runs on CPU or CUDA tensors, not "
                     f"{device}")
  for name, x in (("tri_mesh_slot", tri_mesh_slot),
                  ("view2voxel", view2voxel), ("tri_valid", tri_valid)):
    if x.device != device:
      raise ValueError(f"{name} is on {x.device}, triangles on {device}")
  # view2voxel may be a view: the kernel takes a copy of slot 0's matrices.
  for name, x in (("triangles", triangles), ("tri_mesh_slot", tri_mesh_slot),
                  ("tri_valid", tri_valid)):
    if not x.is_contiguous():
      raise ValueError(f"{name} must be contiguous")


def blocked_raster_forward(triangles, tri_mesh_slot, view2voxel, tri_valid,
                           *, meshes: int, m: int, irm: int,
                           conservative: bool) -> torch.Tensor:
  """The rasterization on checked inputs: the CUDA kernel on the current
  stream for a CUDA input, the plain version for a CPU one."""
  if triangles.device.type == "cpu":
    return blocked_raster_reference(triangles, tri_mesh_slot, view2voxel,
                                    tri_valid, meshes=meshes, m=m, irm=irm,
                                    conservative=conservative)
  b, t = triangles.shape[:2]
  out = torch.zeros((b, meshes, m, m * (m // 32)), dtype=torch.int32,
                    device=triangles.device)
  if b * t == 0:
    return out
  # The sample spacing m / (m·irm) rounded to float32, as
  # raster_fast._project makes it; slot 0's matrix of each scene.
  s = float(np.float32(m / (m * irm)))
  mats = view2voxel[:, 0].contiguous()
  lib = kernels.library("blocked_raster", _SIGNATURES)
  with torch.cuda.device(triangles.device):
    stream = torch.cuda.current_stream(triangles.device).cuda_stream
    err = lib.blocked_raster_fwd(
        triangles.data_ptr(), tri_mesh_slot.data_ptr(), mats.data_ptr(),
        tri_valid.data_ptr(), out.data_ptr(), b, t, meshes, m, irm, s,
        int(conservative), stream)
  if err != 0:
    msg = lib.blocked_raster_error_string(err).decode()
    raise RuntimeError(f"blocked_raster_or kernel launch failed: CUDA error "
                       f"{err} ({msg})")
  global launch_count
  launch_count += 1
  return out


def blocked_raster_or(triangles: torch.Tensor,      # f32[B, T, 3, 3]
                      tri_mesh_slot: torch.Tensor,  # i32[B, T]
                      view2voxel: torch.Tensor,     # f32[B, M', 4, 4]
                      tri_valid: torch.Tensor,      # bool[B, T]
                      *,
                      meshes: int,
                      m: int,
                      irm: int,
                      conservative: bool) -> torch.Tensor:
  """Returns int32[B, meshes, m, m·NW]: every valid triangle's sampled
  block ORed into zeroed grids. Looks up `blocked_raster_forward` at call
  time.

  A CUDA input launches the kernel on the current stream, or raises: it
  never takes the plain version. A CPU input takes the plain version."""
  _check(triangles, tri_mesh_slot, view2voxel, tri_valid, meshes, m, irm)
  return blocked_raster_forward(triangles, tri_mesh_slot, view2voxel,
                                tri_valid, meshes=meshes, m=m, irm=irm,
                                conservative=conservative)
