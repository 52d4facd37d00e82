"""The subset of msgpack that flax.serialization writes, without msgpack or
flax.

flax's `to_bytes` (the body of a `.cpt` checkpoint) packs a tree of
string-keyed maps whose leaves are arrays, numpy scalars and plain values.
This codec reads and writes that subset: nil, bool, ints of every width,
float32/64, str, bin, array and map, and two extension types,

  ExtType 1: an ndarray, packed as the msgpack tuple
             (shape, dtype name, C-order bytes);
  ExtType 3: a numpy scalar, packed the same way as a 0-d array

(flax/serialization.py `_msgpack_ext_pack`, `_ndarray_to_bytes`). It
encodes as msgpack.packb(tree, use_bin_type=True) does, each value in its
shortest form, so flax's bytes decode and re-encode unchanged.

flax splits an array leaf above 2³⁰ bytes into chunks (a map with the key
`__msgpack_chunked_array__`); no CoreNet leaf is that large, so such a
leaf raises. Arrays decode as read-only views of the input buffer
(`np.frombuffer`): a 400 MiB state is not copied per byte in Python.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"


# ------------------------------------------------------------- encoder ---

def _pack_int(n: int, out: List[bytes]) -> None:
  if 0 <= n <= 0x7F:
    out.append(struct.pack("B", n))
  elif -32 <= n < 0:
    out.append(struct.pack("b", n))
  elif n > 0:
    for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                           (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
      if n < top:
        out.append(bytes([code]) + struct.pack(fmt, n))
        return
    raise OverflowError(f"{n} does not fit msgpack's uint64")
  else:
    for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                           (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
      if n >= low:
        out.append(bytes([code]) + struct.pack(fmt, n))
        return
    raise OverflowError(f"{n} does not fit msgpack's int64")


def _pack_length(n: int, fix_base: int, fix_max: int, codes: Tuple[int, ...],
                 out: List[bytes]) -> None:
  """The header of a str/bin/array/map of n items; codes = the 8-, 16- and
  32-bit forms (None where the type has no 8-bit form)."""
  if fix_base is not None and n <= fix_max:
    out.append(bytes([fix_base | n]))
    return
  for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                            (1 << 8, 1 << 16, 1 << 32)):
    if code is not None and n < top:
      out.append(bytes([code]) + struct.pack(fmt, n))
      return
  raise OverflowError(f"{n} items do not fit one msgpack object")


def _pack_ext(code: int, payload: List[bytes], out: List[bytes]) -> None:
  n = sum(len(p) for p in payload)
  fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
  if n in fixed:
    out.append(bytes([fixed[n], code]))
  else:
    _pack_length(n, None, 0, (0xC7, 0xC8, 0xC9), out)
    out.append(bytes([code]))
  out.extend(payload)


def _ndarray_payload(arr: np.ndarray) -> List[bytes]:
  if arr.dtype.hasobject or arr.dtype.fields is not None:
    raise ValueError(f"cannot pack arrays of dtype {arr.dtype}")
  if not arr.flags.c_contiguous:
    arr = arr.copy(order="C")  # (np.ascontiguousarray would make 0-d 1-d)
  data = memoryview(arr.reshape(-1)).cast("B") if arr.size else b""
  out: List[bytes] = []
  _pack_length(3, 0x90, 15, (None, 0xDC, 0xDD), out)
  _pack_value(tuple(int(s) for s in arr.shape), out)
  _pack_value(arr.dtype.name, out)
  _pack_length(len(data), None, 0, (0xC4, 0xC5, 0xC6), out)
  out.append(data)
  return out


def _pack_value(value: Any, out: List[bytes]) -> None:
  if value is None:
    out.append(b"\xc0")
  elif value is True or value is False:
    out.append(b"\xc3" if value else b"\xc2")
  elif isinstance(value, np.ndarray):
    _pack_ext(EXT_NDARRAY, _ndarray_payload(value), out)
  elif isinstance(value, np.generic):
    _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(value)), out)
  elif type(value) is int:
    _pack_int(value, out)
  elif type(value) is float:
    out.append(b"\xcb" + struct.pack(">d", value))
  elif type(value) is str:
    data = value.encode("utf-8")
    _pack_length(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
    out.append(data)
  elif isinstance(value, (bytes, bytearray, memoryview)):
    _pack_length(len(value), None, 0, (0xC4, 0xC5, 0xC6), out)
    out.append(bytes(value))
  elif isinstance(value, (list, tuple)):
    _pack_length(len(value), 0x90, 15, (None, 0xDC, 0xDD), out)
    for item in value:
      _pack_value(item, out)
  elif isinstance(value, dict):
    _pack_length(len(value), 0x80, 15, (None, 0xDE, 0xDF), out)
    for key, item in value.items():
      _pack_value(key, out)
      _pack_value(item, out)
  else:
    raise TypeError(f"cannot pack {type(value).__name__}")


def packb(tree: Any) -> bytes:
  """Packs a tree as flax.serialization.msgpack_serialize does (for trees
  without chunked leaves)."""
  out: List[bytes] = []
  _pack_value(tree, out)
  return b"".join(out)


# ------------------------------------------------------------- decoder ---

class _Reader:

  def __init__(self, data):
    self.view = memoryview(data).cast("B")
    self.pos = 0

  def take(self, n: int) -> memoryview:
    if self.pos + n > len(self.view):
      raise ValueError("truncated msgpack data")
    out = self.view[self.pos:self.pos + n]
    self.pos += n
    return out

  def unpack(self, fmt: str):
    return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {  # code → struct format of a fixed-width int or float
    0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTH = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",   # bin
           0xD9: ">B", 0xDA: ">H", 0xDB: ">I",   # str
           0xDC: ">H", 0xDD: ">I",               # array
           0xDE: ">H", 0xDF: ">I",               # map
           0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}   # ext
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _ndarray_from_payload(payload: memoryview) -> np.ndarray:
  reader = _Reader(payload)
  shape, dtype_name, data = _read(reader)
  if reader.pos != len(reader.view):
    raise ValueError("trailing bytes in an ndarray payload")
  dtype = np.dtype(dtype_name)
  return np.frombuffer(data, dtype=dtype).reshape(shape)


def _ext(code: int, payload: memoryview) -> Any:
  if code == EXT_NDARRAY:
    return _ndarray_from_payload(payload)
  if code == EXT_NPSCALAR:
    return _ndarray_from_payload(payload)[()]
  raise ValueError(f"msgpack extension type {code} is not flax's ndarray "
                   "(1) or numpy scalar (3)")


def _read(reader: _Reader) -> Any:
  code = reader.unpack("B")
  if code <= 0x7F:
    return code
  if code >= 0xE0:
    return code - 0x100
  if 0x80 <= code <= 0x8F:
    return _read_map(reader, code & 0x0F)
  if 0x90 <= code <= 0x9F:
    return [_read(reader) for _ in range(code & 0x0F)]
  if 0xA0 <= code <= 0xBF:
    return str(reader.take(code & 0x1F), "utf-8")
  if code == 0xC0:
    return None
  if code in (0xC2, 0xC3):
    return code == 0xC3
  if code in _FIXED:
    return reader.unpack(_FIXED[code])
  if code in _FIXEXT:
    ext = reader.unpack("b")
    return _ext(ext, reader.take(_FIXEXT[code]))
  if code in _LENGTH:
    n = reader.unpack(_LENGTH[code])
    if code <= 0xC6:
      return reader.take(n)
    if code <= 0xC9:
      ext = reader.unpack("b")
      return _ext(ext, reader.take(n))
    if code <= 0xDB:
      return str(reader.take(n), "utf-8")
    if code <= 0xDD:
      return [_read(reader) for _ in range(n)]
    return _read_map(reader, n)
  raise ValueError(f"msgpack type byte 0x{code:02x} is not supported")


def _read_map(reader: _Reader, n: int) -> dict:
  out = {}
  for _ in range(n):
    key = _read(reader)
    if not isinstance(key, str):
      raise ValueError(f"map key {key!r} is not a string")
    out[key] = _read(reader)
  if CHUNKED_KEY in out:
    raise ValueError("chunked array leaves (over 2**30 bytes) are not "
                     "supported")
  return out


def unpackb(data) -> Any:
  """Unpacks flax msgpack bytes (or any buffer) into a tree of dicts,
  lists, plain values, numpy scalars and read-only ndarrays that view
  `data`. bin values come back as memoryviews of `data`."""
  reader = _Reader(data)
  out = _read(reader)
  if reader.pos != len(reader.view):
    raise ValueError("trailing bytes after the msgpack object")
  return out
