"""Checkpoint store: the whole training state in one `.cpt` file, with temp
and persistent tiers.

Counterpart of corenet_tpu/train/checkpoint.py, in the same container, so
that a file written by either package loads in the other:

  MAGIC `CORENET-TPU-CPT1`, a u64-LE header length, the JSON header
  {"global_step", "extra_metadata"}, then the flax-msgpack body
  {"params", "batch_stats", "opt_state"} in the JAX package's names,
  layouts and dtypes (models/convert.py maps them onto the port's
  state_dict and torch Adam's state; train/flax_msgpack.py is the codec).

Two tiers: `cpt/temp/` (rolling, the last `keep_temp` kept) and
`cpt/persistent/` (kept forever), files `state_{step:09d}.cpt`, each
written to a temporary name and renamed.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Any, Dict, List, Mapping, Optional, Tuple

from corenet_tpu_torch.models import convert
from corenet_tpu_torch.train import flax_msgpack
from corenet_tpu_torch.train.state import TrainState
from corenet_tpu_torch.utils import fs

_MAGIC = b"CORENET-TPU-CPT1"


@dataclasses.dataclass
class RawState:
  """A decoded checkpoint body: nested dicts of numpy arrays in the JAX
  package's layouts (read-only views of the file's bytes)."""
  global_step: int
  params: Dict[str, Any]
  batch_stats: Dict[str, Any]
  opt_state: Dict[str, Any]

  @property
  def variables(self) -> Dict[str, Any]:
    """{"params", "batch_stats"}: what models/convert.py's
    `state_dict_from_jax` takes."""
    return {"params": self.params, "batch_stats": self.batch_stats}


def encode_state(state: TrainState,
                 extra_metadata: Optional[Mapping[str, Any]] = None) -> bytes:
  """The port's training state (its model's weights and statistics, its
  Adam state, its global step) → `.cpt` bytes."""
  header = json.dumps({
      "global_step": int(state.global_step),
      "extra_metadata": dict(extra_metadata or {}),
  }).encode("utf-8")
  variables = convert.jax_variables_from_state_dict(state.model.state_dict())
  body = flax_msgpack.packb({
      "params": variables["params"],
      "batch_stats": variables["batch_stats"],
      "opt_state": convert.adam_state_to_jax(state.model, state.optimizer),
  })
  return _MAGIC + struct.pack("<Q", len(header)) + header + body


def restore_state(raw: RawState, target: TrainState) -> TrainState:
  """Loads a decoded checkpoint into `target`'s model (strictly: every key
  and shape must match) and optimizer, in place, and returns the state at
  the checkpoint's global step."""
  target.model.load_state_dict(convert.state_dict_from_jax(raw.variables))
  convert.load_adam_state_from_jax(target.model, target.optimizer,
                                   raw.opt_state)
  return dataclasses.replace(target, global_step=raw.global_step)


def decode_state(data: bytes, target: Optional[TrainState] = None
                 ) -> Tuple[Any, Mapping[str, Any]]:
  """Decodes checkpoint bytes.

  Args:
    data: Bytes produced by either package's encode_state.
    target: Optional TrainState; when given, its model and optimizer are
      loaded from the checkpoint (restore_state) and returned at the
      checkpoint's global step. Without it, a RawState is returned.

  Returns:
    (state, extra_metadata)
  """
  if data[:len(_MAGIC)] != _MAGIC:
    raise ValueError("not a corenet-tpu checkpoint")
  off = len(_MAGIC)
  (hlen,) = struct.unpack("<Q", data[off:off + 8])
  off += 8
  header = json.loads(bytes(data[off:off + hlen]).decode("utf-8"))
  tree = flax_msgpack.unpackb(memoryview(data)[off + hlen:])
  raw = RawState(global_step=int(header["global_step"]),
                 params=tree["params"], batch_stats=tree["batch_stats"],
                 opt_state=tree["opt_state"])
  state = raw if target is None else restore_state(raw, target)
  return state, header["extra_metadata"]


def _step_of(path: str) -> int:
  name = fs.basename(path)
  return int(name[len("state_"):-len(".cpt")])


class CheckpointReader:
  """Read-only view over a checkpoint directory tree."""

  def __init__(self, cpt_dir: str):
    self.cpt_dir = cpt_dir
    self.temp_dir = fs.join(cpt_dir, "temp")
    self.persistent_dir = fs.join(cpt_dir, "persistent")

  def list_checkpoints(self) -> List[str]:
    """All checkpoint paths, sorted by step (temp + persistent)."""
    paths = (fs.glob_pattern(fs.join(self.temp_dir, "state_*.cpt")) +
             fs.glob_pattern(fs.join(self.persistent_dir, "state_*.cpt")))
    return sorted(set(paths), key=_step_of)

  def last_checkpoint_path(self) -> Optional[str]:
    paths = self.list_checkpoints()
    return paths[-1] if paths else None

  def read_last_checkpoint(self, target: Optional[TrainState] = None):
    """(state, extra_metadata, path) of the newest checkpoint, or None."""
    path = self.last_checkpoint_path()
    if path is None:
      return None
    state, meta = decode_state(fs.read_bytes(path), target)
    return state, meta, path


class CheckpointManager(CheckpointReader):
  """Writer: rolling temp checkpoints + forever-kept persistent ones."""

  def __init__(self, cpt_dir: str, keep_temp: int = 5):
    super().__init__(cpt_dir)
    self.keep_temp = keep_temp
    fs.makedirs(self.temp_dir)
    fs.makedirs(self.persistent_dir)

  def save_state(self, state: TrainState,
                 extra_metadata: Optional[Mapping[str, Any]] = None,
                 persistent: bool = False) -> str:
    data = encode_state(state, extra_metadata)
    out_dir = self.persistent_dir if persistent else self.temp_dir
    final = fs.join(out_dir, f"state_{int(state.global_step):09d}.cpt")
    tmp = final + ".tmp"
    fs.write_bytes(tmp, data)
    fs.rename(tmp, final)
    if not persistent:
      self._prune_temp()
    return final

  def _prune_temp(self):
    paths = sorted(fs.glob_pattern(fs.join(self.temp_dir, "state_*.cpt")),
                   key=_step_of)
    for p in paths[:-self.keep_temp]:
      fs.unlink(p)
