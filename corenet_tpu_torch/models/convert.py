"""The weight bridge: the JAX package's variables → the port's state_dict.

`state_dict_from_jax` takes `{"params": …, "batch_stats": …}` as nested
dicts of numpy arrays (for instance `jax.tree_util.tree_map(np.asarray,
variables)`), so it needs neither JAX nor flax. The port's modules are
named after the flax scopes, so each leaf maps mechanically:

  params/<scope>/kernel → <scope>.weight, re-laid out:
      Linear          [in, out]               → [out, in]
      ConvTranspose   spatial... + (in, out)  → (in, out, spatial...), no flip
      Conv            spatial... + (in, out)  → (out, in, spatial...)
    (a transposed convolution is a scope whose name ends in `_t`; this is
    the inverse of cli/import_corenet_checkpoint.py's mapping)
  params/<scope>/{scale,bias}              → <scope>.{scale,bias}
  batch_stats/<scope>/{mean,var,steps}     → <scope>.{mean,var,steps}
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
  for key, value in tree.items():
    if isinstance(value, Mapping):
      yield from _leaves(value, prefix + (key,))
    else:
      yield prefix + (key,), np.asarray(value)


def _weight_from_kernel(scope: Tuple[str, ...],
                        kernel: np.ndarray) -> np.ndarray:
  if kernel.ndim == 2:
    return kernel.T
  if scope[-1].endswith("_t"):
    return np.moveaxis(kernel, (-2, -1), (0, 1))
  return np.moveaxis(kernel, (-1, -2), (0, 1))


def _tensor(value: np.ndarray) -> torch.Tensor:
  # A C-ordered copy that keeps 0-d arrays (the `steps` counters) 0-d.
  return torch.from_numpy(np.array(value, order="C"))


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
  """Maps a JAX CoreNet's variables onto `corenet_tpu_torch` CoreNet's
  `state_dict()` keys and layouts."""
  out = {}
  for path, value in _leaves(variables["params"]):
    *scope, leaf = path
    if leaf == "kernel":
      value = _weight_from_kernel(tuple(scope), value)
      leaf = "weight"
    out[".".join(scope + [leaf])] = _tensor(value)
  for path, value in _leaves(variables.get("batch_stats", {})):
    out[".".join(path)] = _tensor(value)
  return out
