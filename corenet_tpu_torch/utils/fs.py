"""Unified local + ``gs://`` file I/O.

A near-copy of corenet_tpu/utils/fs.py (the port keeps its own copy of
the host-side modules it needs): byte/text read/write, glob, unlink,
rename, makedirs and path algebra that transparently handle Google Cloud
Storage paths. GCS operations retry 3 times. The GCS client is imported
lazily and gated, so local-only environments need no cloud deps.
"""

from __future__ import annotations

import glob as _glob
import os
import os.path as _osp
import shutil
import time
from typing import List, Tuple

_GCS_PREFIX = "gs://"
_NUM_RETRIES = 3
_RETRY_SLEEP_SEC = 2.0


def is_gcs_path(path: str) -> bool:
  return path.startswith(_GCS_PREFIX)


def _split_gcs_path(path: str) -> Tuple[str, str]:
  assert is_gcs_path(path)
  rest = path[len(_GCS_PREFIX):]
  bucket, _, blob = rest.partition("/")
  return bucket, blob


_gcs_client = None


def _get_gcs_client():
  global _gcs_client
  if _gcs_client is None:
    try:
      from google.cloud import storage  # type: ignore
    except ImportError as e:  # pragma: no cover - gated dependency
      raise RuntimeError(
          "google-cloud-storage is required for gs:// paths but is not "
          "installed in this environment") from e
    _gcs_client = storage.Client()
  return _gcs_client


def _retry(fn):
  last_exc = None
  for attempt in range(_NUM_RETRIES):
    try:
      return fn()
    except Exception as e:  # pylint: disable=broad-except
      last_exc = e
      if attempt + 1 < _NUM_RETRIES:
        time.sleep(_RETRY_SLEEP_SEC)
  raise last_exc


# ------------------------------------------------------------------ I/O ----
def read_bytes(path: str) -> bytes:
  if is_gcs_path(path):
    bucket, blob = _split_gcs_path(path)

    def op():
      return _get_gcs_client().bucket(bucket).blob(blob).download_as_bytes()

    return _retry(op)
  with open(path, "rb") as f:
    return f.read()


def write_bytes(path: str, data: bytes) -> None:
  if is_gcs_path(path):
    bucket, blob = _split_gcs_path(path)

    def op():
      _get_gcs_client().bucket(bucket).blob(blob).upload_from_string(data)

    _retry(op)
    return
  with open(path, "wb") as f:
    f.write(data)


def read_text(path: str, encoding: str = "utf-8") -> str:
  return read_bytes(path).decode(encoding)


def write_text(path: str, text: str, encoding: str = "utf-8") -> None:
  write_bytes(path, text.encode(encoding))


def exists(path: str) -> bool:
  if is_gcs_path(path):
    bucket, blob = _split_gcs_path(path)

    def op():
      return _get_gcs_client().bucket(bucket).blob(blob).exists()

    return _retry(op)
  return _osp.exists(path)


def unlink(path: str) -> None:
  if is_gcs_path(path):
    bucket, blob = _split_gcs_path(path)

    def op():
      _get_gcs_client().bucket(bucket).blob(blob).delete()

    _retry(op)
    return
  os.unlink(path)


def rename(src: str, dst: str) -> None:
  """Renames a file. Both paths must live on the same file system."""
  src_gcs, dst_gcs = is_gcs_path(src), is_gcs_path(dst)
  if src_gcs != dst_gcs:
    raise ValueError("Cannot rename across file systems")
  if src_gcs:
    src_bucket, src_blob = _split_gcs_path(src)
    dst_bucket, dst_blob = _split_gcs_path(dst)

    def op():
      client = _get_gcs_client()
      bucket = client.bucket(src_bucket)
      blob = bucket.blob(src_blob)
      bucket.copy_blob(blob, client.bucket(dst_bucket), dst_blob)
      blob.delete()

    _retry(op)
    return
  os.replace(src, dst)


def makedirs(path: str, exist_ok: bool = True) -> None:
  if is_gcs_path(path):
    return  # GCS has no directories
  os.makedirs(path, exist_ok=exist_ok)


def rmtree(path: str) -> None:
  if is_gcs_path(path):
    bucket, prefix = _split_gcs_path(path)

    def op():
      client = _get_gcs_client()
      for blob in client.list_blobs(bucket, prefix=prefix.rstrip("/") + "/"):
        blob.delete()

    _retry(op)
    return
  shutil.rmtree(path)


def glob_pattern(pattern: str) -> List[str]:
  """Expands a glob pattern. For GCS, only a single trailing '*' in the last
  path segment is supported (sufficient for checkpoint discovery)."""
  if is_gcs_path(pattern):
    bucket, blob = _split_gcs_path(pattern)
    if "*" not in blob:
      return [pattern] if exists(pattern) else []
    prefix, star, suffix = blob.partition("*")
    assert "*" not in suffix, "Only one wildcard supported for gs:// globs"

    def op():
      client = _get_gcs_client()
      names = [b.name for b in client.list_blobs(bucket, prefix=prefix)]
      return [
          f"{_GCS_PREFIX}{bucket}/{n}" for n in names if n.endswith(suffix)
      ]

    return sorted(_retry(op))
  return sorted(_glob.glob(pattern))


# ----------------------------------------------------------- path algebra --
def join(*parts: str) -> str:
  if parts and is_gcs_path(parts[0]):
    result = parts[0].rstrip("/")
    for p in parts[1:]:
      result += "/" + p.strip("/")
    return result
  return _osp.join(*parts)


def dirname(path: str) -> str:
  if is_gcs_path(path):
    return path.rsplit("/", 1)[0]
  return _osp.dirname(path)


def basename(path: str) -> str:
  return path.rstrip("/").rsplit("/", 1)[-1]


def splitext(path: str) -> Tuple[str, str]:
  return _osp.splitext(path)


def abspath(path: str) -> str:
  if is_gcs_path(path):
    return path
  return _osp.abspath(path)


def normpath(path: str) -> str:
  if is_gcs_path(path):
    return path
  return _osp.normpath(path)
