"""Dataclass-driven command-line flags.

A near-copy of corenet_tpu/utils/flags.py: dataclass fields marked with
`flag()` become argparse arguments (typed from the annotation), booleans
get automatic `--no<name>` negative forms, fields can be positional,
repeated or capture the remainder, and `parse_flags` returns a populated
instance of the dataclass.
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import typing
from typing import Any, List, Optional, Sequence, Type, TypeVar

_FLAG_META = "corenet_flag"


class ArgKind(enum.Enum):
  FLAG = "flag"
  POSITIONAL = "positional"
  REMAINDER = "remainder"


def flag(help: str = "", default: Any = dataclasses.MISSING,
         kind: ArgKind = ArgKind.FLAG, short_name: Optional[str] = None,
         repeated: bool = False):
  meta = {"help": help, "kind": kind, "short_name": short_name,
          "repeated": repeated}
  if default is dataclasses.MISSING:
    return dataclasses.field(metadata={_FLAG_META: meta})
  if isinstance(default, (list, dict, set)):
    return dataclasses.field(default_factory=lambda: default,
                             metadata={_FLAG_META: meta})
  return dataclasses.field(default=default, metadata={_FLAG_META: meta})


T = TypeVar("T")


def parse_flags(cls: Type[T], argv: Optional[Sequence[str]] = None) -> T:
  parser = argparse.ArgumentParser(
      description=cls.__doc__, fromfile_prefix_chars="@")
  hints = typing.get_type_hints(cls)
  for f in dataclasses.fields(cls):
    meta = f.metadata.get(_FLAG_META)
    if meta is None:
      continue
    ftype = hints[f.name]
    has_default = (f.default is not dataclasses.MISSING or
                   f.default_factory is not dataclasses.MISSING)
    default = (f.default if f.default is not dataclasses.MISSING
               else (f.default_factory()
                     if f.default_factory is not dataclasses.MISSING
                     else None))
    kind = meta["kind"]
    if kind == ArgKind.REMAINDER:
      parser.add_argument(f.name, nargs=argparse.REMAINDER,
                          help=meta["help"])
      continue
    if kind == ArgKind.POSITIONAL:
      parser.add_argument(f.name, type=ftype, help=meta["help"],
                          **({"default": default, "nargs": "?"}
                             if has_default else {}))
      continue

    names = [f"--{f.name}"]
    if meta["short_name"]:
      names.insert(0, f"-{meta['short_name']}")
    origin = typing.get_origin(ftype)
    if ftype is bool:
      parser.add_argument(*names, dest=f.name, action="store_true",
                          default=default, help=meta["help"])
      parser.add_argument(f"--no{f.name}", dest=f.name, action="store_false")
    elif meta["repeated"] or origin in (list, List):
      elem = (typing.get_args(ftype) or (str,))[0]
      parser.add_argument(*names, dest=f.name, type=elem, action="append",
                          default=None, help=meta["help"])
    else:
      parser.add_argument(*names, dest=f.name, type=ftype, default=default,
                          required=not has_default, help=meta["help"])

  ns = parser.parse_args(argv)
  kwargs = {}
  for f in dataclasses.fields(cls):
    if f.metadata.get(_FLAG_META) is None:
      continue
    v = getattr(ns, f.name)
    meta = f.metadata[_FLAG_META]
    if (meta["repeated"] or typing.get_origin(hints[f.name]) in (list, List)
       ) and meta["kind"] == ArgKind.FLAG and v is None:
      v = (f.default_factory() if f.default_factory is not dataclasses.MISSING
           else [])
    kwargs[f.name] = v
  return cls(**kwargs)
