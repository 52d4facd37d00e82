"""PNG bytes from RGB images and back, with the standard library only.

The JAX package writes its PNGs through PIL (eval/qualitative.py,
cli/demo.py). The port writes every `img_*.png`, `reconstruction.png` and
summary image through `encode_png`, whether or not PIL is installed: one
8-bit RGB image, no interlace, filter 0 on every row, one zlib stream.
`decode_png` reads exactly that subset back (the port's own files), so a
machine without PIL can check what the port wrote.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_IHDR_RGB8 = (8, 2, 0, 0, 0)  # bit depth, colour type RGB, deflate, filter, no interlace


def _chunk(kind: bytes, data: bytes) -> bytes:
  crc = zlib.crc32(data, zlib.crc32(kind))
  return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(image: np.ndarray) -> bytes:
  """uint8[H, W, 3] → PNG bytes."""
  image = np.asarray(image)
  if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
    raise ValueError(f"expected uint8[H, W, 3], got {image.dtype}"
                     f"{list(image.shape)}")
  h, w, _ = image.shape
  rows = np.zeros((h, 1 + 3 * w), np.uint8)  # a leading 0: filter "none"
  rows[:, 1:] = image.reshape(h, 3 * w)
  header = struct.pack(">IIBBBBB", w, h, *_IHDR_RGB8)
  return (_SIGNATURE + _chunk(b"IHDR", header) +
          _chunk(b"IDAT", zlib.compress(rows.tobytes())) +
          _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
  """PNG bytes as `encode_png` writes them → uint8[H, W, 3]. Raises on any
  other kind of PNG (palette, alpha, 16 bits, interlace, row filters)."""
  if data[:8] != _SIGNATURE:
    raise ValueError("not a PNG file")
  offset, header, idat = 8, None, []
  while offset < len(data):
    (length,) = struct.unpack(">I", data[offset:offset + 4])
    kind = data[offset + 4:offset + 8]
    body = data[offset + 8:offset + 8 + length]
    (crc,) = struct.unpack(">I", data[offset + 8 + length:offset + 12 + length])
    if crc != zlib.crc32(body, zlib.crc32(kind)):
      raise ValueError(f"PNG chunk {kind!r} fails its CRC")
    if kind == b"IHDR":
      header = struct.unpack(">IIBBBBB", body)
    elif kind == b"IDAT":
      idat.append(body)
    elif kind == b"IEND":
      break
    offset += 12 + length
  if header is None or header[2:] != _IHDR_RGB8:
    raise ValueError(f"unsupported PNG header {header}")
  w, h = header[:2]
  rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
  rows = rows.reshape(h, 1 + 3 * w)
  if rows[:, 0].any():
    raise ValueError("PNG rows use filters other than 0")
  return rows[:, 1:].reshape(h, w, 3).copy()
