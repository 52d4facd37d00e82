"""Builds and loads the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface (no PyTorch headers, so a
build takes seconds) and is compiled by `nvcc` for Hopper (`sm_90a`) into
its own shared library, loaded with `ctypes`. `build_all` starts one
`nvcc` per source, all at once. Builds happen at first use,
into `_build/` inside this package (listed in `.gitignore`). A library's
file name carries a hash of its source and flags, so an edited source is
rebuilt, and a build is written to a temporary name and renamed, so
concurrent processes never load a half-written file.

Nothing here runs at import: `import corenet_tpu_torch` works on a machine
with neither `nvcc` nor a GPU. There only CPU tensors can go through the
ops, whose wrappers then take their plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("skip_gather", "fgbg_sums", "block_scatter", "phased_gt",
           "blocked_raster")
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# C signature of every exported function: name → (argtypes, restype).
Signatures = Dict[str, Tuple[Sequence[type], type]]

_libraries: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
  """The CUDA compiler: `nvcc` on PATH, else the toolkit's default place."""
  found = shutil.which("nvcc")
  if found:
    return found
  if DEFAULT_NVCC.is_file():
    return str(DEFAULT_NVCC)
  raise RuntimeError(
      f"nvcc not found (neither on PATH nor at {DEFAULT_NVCC}): the CUDA "
      "kernels of corenet_tpu_torch cannot be built here")


def library_path(name: str) -> Path:
  """Where the library built from `csrc/<name>.cu` lives."""
  source = (CSRC_DIR / f"{name}.cu").read_bytes()
  digest = hashlib.sha256(source + "\0".join(NVCC_FLAGS).encode())
  return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def nvcc_command(name: str, output: Path) -> list:
  return [nvcc_path(), *NVCC_FLAGS, "-o", str(output),
          str(CSRC_DIR / f"{name}.cu")]


def build(name: str) -> Path:
  """Compiles `csrc/<name>.cu` unless it is built already; returns the
  library's path. Raises with the compiler's output on a failed build."""
  return build_all((name,))[name]


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
  """Compiles every named source that is not built yet, one `nvcc` for
  each, all started together; returns each library's path. Raises with
  the compiler's output if any build failed."""
  targets = {name: library_path(name) for name in names}
  jobs = {}
  for name, target in targets.items():
    if target.exists():
      continue
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{target.name}.", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(nvcc_command(name, Path(tmp)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    jobs[name] = (proc, tmp)
  failures = []
  for name, (proc, tmp) in jobs.items():
    output, _ = proc.communicate()
    if proc.returncode != 0:
      os.unlink(tmp)
      failures.append(f"CUDA kernel build of {name} failed (nvcc exit "
                      f"{proc.returncode}):\n{output}")
    else:
      os.replace(tmp, targets[name])
  if failures:
    raise RuntimeError("\n".join(failures))
  return targets


def library(name: str, signatures: Signatures) -> ctypes.CDLL:
  """The loaded library of `csrc/<name>.cu`, built on first use, with the
  given C signatures declared on its functions."""
  lib = _libraries.get(name)
  if lib is None:
    lib = ctypes.CDLL(str(build(name)))
    for fn_name, (argtypes, restype) in signatures.items():
      fn = getattr(lib, fn_name)
      fn.argtypes = list(argtypes)
      fn.restype = restype
    _libraries[name] = lib
  return lib
