"""The native C++ ground-truth ops: the build, the ctypes bindings.

Counterpart of corenet_tpu/cc/native.py, with the same functions and
arguments, over the port's own copies of its sources (`fill_voxels.cc`,
`voxelize.cc` beside this file). The shared library is built at first
use with `g++` and the JAX package's flags (`-O3 -march=native -std=c++17
-shared -fPIC -pthread`), so that it computes what the JAX package's
library computes, into `corenet_tpu_torch/_build/` (listed in
`.gitignore`). The library's file name carries a hash of its sources and
flags, and a build is written to a temporary name and renamed, so an
edited source is rebuilt and processes that load it at once (ranks,
pytest workers) never load a half-written file. A failed build raises.
`$CORENET_PRECOMPILED_CC_LIBRARY` names a library to load instead.

Nothing is built at import. The calls release the GIL (ctypes does), so
the data loader's producer thread voxelizes while the step runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

CC_DIR = Path(__file__).resolve().parent
BUILD_DIR = CC_DIR.parent / "_build"
SOURCES = ("fill_voxels.cc", "voxelize.cc")
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread")

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()

_I64 = ctypes.c_int64
_FILL_SIGNATURES = {
    "corenet_fill_inside_voxels_u8": ctypes.POINTER(ctypes.c_uint8),
    "corenet_fill_inside_voxels_i32": ctypes.POINTER(ctypes.c_int32),
    "corenet_fill_inside_voxels_f32": ctypes.POINTER(ctypes.c_float),
}
_VOXELIZE_ARGTYPES = [
    ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
    _I64, _I64, _I64, _I64, _I64, ctypes.c_int, ctypes.c_double,
    ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
]


def library_path() -> Path:
  """Where the library built from this directory's sources lives."""
  digest = hashlib.sha256("\0".join(GXX_FLAGS).encode())
  for name in SOURCES:
    digest.update((CC_DIR / name).read_bytes())
  return BUILD_DIR / f"libcorenet_cc-{digest.hexdigest()[:16]}.so"


def build() -> Path:
  """Compiles the sources with g++ unless they are built already; returns
  the library's path. Raises with the compiler's output on failure."""
  target = library_path()
  if target.exists():
    return target
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  fd, tmp = tempfile.mkstemp(prefix=f".{target.name}.", dir=BUILD_DIR)
  os.close(fd)
  command = ["g++", *GXX_FLAGS, "-o", tmp,
             *(str(CC_DIR / name) for name in SOURCES)]
  try:
    run = subprocess.run(command, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
  except BaseException:
    os.unlink(tmp)
    raise
  if run.returncode != 0:
    os.unlink(tmp)
    raise RuntimeError(f"native GT library build failed (g++ exit "
                       f"{run.returncode}):\n{run.stdout}")
  os.replace(tmp, target)
  return target


def load_library() -> ctypes.CDLL:
  """The loaded library, built on first use (or the precompiled one that
  $CORENET_PRECOMPILED_CC_LIBRARY names), its signatures declared."""
  global _LIB
  with _LOCK:
    if _LIB is None:
      path = os.environ.get("CORENET_PRECOMPILED_CC_LIBRARY") or build()
      lib = ctypes.CDLL(str(path))
      for name, pointer in _FILL_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [pointer, _I64, _I64, _I64, _I64]
        fn.restype = None
      lib.corenet_voxelize_triangles.argtypes = _VOXELIZE_ARGTYPES
      lib.corenet_voxelize_triangles.restype = None
      _LIB = lib
  return _LIB


def fill_inside_voxels(grid: np.ndarray) -> np.ndarray:
  """Native flood fill; numeric[N, D, H, W] → binary grid, same dtype
  (uint8, int32 and float32 natively; any other dtype through float32)."""
  lib = load_library()
  if grid.ndim != 4:
    raise ValueError(f"expected [N, D, H, W], got shape {grid.shape}")
  n, d, h, w = grid.shape
  if grid.dtype == np.uint8:
    out, name = np.array(grid, order="C"), "corenet_fill_inside_voxels_u8"
  elif grid.dtype == np.int32:
    out, name = np.array(grid, order="C"), "corenet_fill_inside_voxels_i32"
  else:
    out = np.array(grid, np.float32, order="C")
    name = "corenet_fill_inside_voxels_f32"
  fn = getattr(lib, name)
  fn(out.ctypes.data_as(fn.argtypes[0]), n, d, h, w)
  return out.astype(grid.dtype) if out.dtype != grid.dtype else out


def voxelize_triangles(triangles: np.ndarray,
                       tri_mesh_index: np.ndarray,
                       num_meshes: int,
                       resolution,
                       image_resolution_multiplier: float = 4,
                       conservative_rasterization: bool = False,
                       projection_depth_multiplier: float = 1,
                       sub_grid_sampling: bool = False) -> np.ndarray:
  """Native voxelizer. Triangles float32[T, 3, 3] must already be in voxel
  space, each with its mesh's index in `tri_mesh_index` int32[T].

  The arguments are voxel/voxelize.py's `voxelize_triangles`'; returns
  float32[M, D, H, W] (with sub-grid sampling [M, 2D+1, 2H+1, 2W+1]).
  """
  lib = load_library()
  d, h, w = (int(v) for v in resolution)
  image_res = int(round(max(w, h, d * projection_depth_multiplier) *
                        image_resolution_multiplier))
  if sub_grid_sampling:
    out_shape = (num_meshes, 2 * d + 1, 2 * h + 1, 2 * w + 1)
    sub = int(image_resolution_multiplier)
    if sub % 2 != 1:
      raise ValueError("sub-grid sampling needs an odd image resolution "
                       f"multiplier, got {image_resolution_multiplier}")
  else:
    out_shape = (num_meshes, d, h, w)
    sub = -1
  out = np.zeros(out_shape, np.float32)
  triangles = np.ascontiguousarray(triangles, np.float32)
  tri_mesh_index = np.ascontiguousarray(tri_mesh_index, np.int32)
  if (triangles.ndim != 3 or triangles.shape[1:] != (3, 3)
      or tri_mesh_index.shape != triangles.shape[:1]):
    raise ValueError(f"expected triangles [T, 3, 3] and their mesh indices "
                     f"[T], got {triangles.shape} and {tri_mesh_index.shape}")
  # The library counts triangles per mesh into num_meshes + 1 slots.
  if tri_mesh_index.size and not (
      0 <= tri_mesh_index[0] and tri_mesh_index[-1] < num_meshes
      and (np.diff(tri_mesh_index) >= 0).all()):
    raise ValueError(f"tri_mesh_index must ascend within [0, {num_meshes})")
  lib.corenet_voxelize_triangles(
      triangles.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
      tri_mesh_index.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
      triangles.shape[0], num_meshes, d, h, w, image_res,
      float(projection_depth_multiplier),
      int(conservative_rasterization), sub,
      out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
  return out
