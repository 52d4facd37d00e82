"""The weight bridge between the JAX package's variables and the port's
state_dict, both ways, and between optax's Adam state and torch's.

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

`jax_variables_from_state_dict` is its inverse. The optimizer maps by
parameter name (through `model.named_parameters()`, since torch keys its
state by parameter): optax.adam's state, as flax serializes it, is
`{'0': {count, mu, nu}, '1': {}}`, where `count` (int32) is torch Adam's
per-parameter `step` and `mu`/`nu` (trees shaped like the params) are
`exp_avg`/`exp_avg_sq`, re-laid out as the weights are.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Mapping, Tuple

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


def _kernel_from_weight(scope: Tuple[str, ...],
                        weight: np.ndarray) -> np.ndarray:
  if weight.ndim == 2:
    return weight.T
  if scope[-1].endswith("_t"):
    return np.moveaxis(weight, (0, 1), (-2, -1))
  return np.moveaxis(weight, (0, 1), (-1, -2))


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


# Buffers of the port's modules that are flax's batch_stats collection.
_BATCH_STATS = ("mean", "var", "steps")


def _set(tree: Dict, path, value) -> None:
  for key in path[:-1]:
    tree = tree.setdefault(key, {})
  tree[path[-1]] = value


def _params_tree(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict:
  """Parameters (or tensors laid out like them) → a flax params tree."""
  tree = {}
  for key, tensor in named:
    *scope, leaf = key.split(".")
    value = tensor.detach().cpu().numpy()
    if leaf == "weight":
      value, leaf = _kernel_from_weight(tuple(scope), value), "kernel"
    _set(tree, scope + [leaf], value)
  return tree


def jax_variables_from_state_dict(state_dict: Mapping[str, torch.Tensor]
                                  ) -> Dict[str, Dict]:
  """The inverse of `state_dict_from_jax`: a port CoreNet's `state_dict()`
  → `{"params": …, "batch_stats": …}` as nested dicts of numpy arrays in
  the JAX package's layouts and dtypes."""
  stats = {}
  for key, tensor in state_dict.items():
    if key.rsplit(".", 1)[-1] in _BATCH_STATS:
      _set(stats, key.split("."), tensor.detach().cpu().numpy())
  params = _params_tree((k, v) for k, v in state_dict.items()
                        if k.rsplit(".", 1)[-1] not in _BATCH_STATS)
  return {"params": params, "batch_stats": stats}


def adam_state_to_jax(model: torch.nn.Module,
                      optimizer: torch.optim.Optimizer) -> Dict:
  """torch Adam's state for `model`'s parameters → optax.adam's state as
  flax serializes it. A fresh optimizer (no step taken) gives count 0 and
  zero moments, as `optax.adam(...).init` does."""
  count, mu, nu = None, [], []
  for name, param in model.named_parameters():
    state = optimizer.state.get(param, {})
    step = int(state["step"]) if state else 0
    if count is not None and step != count:
      raise ValueError(f"parameter {name} has taken {step} Adam steps, "
                       f"others {count}: optax keeps one count")
    count = step
    zeros = torch.zeros_like(param)
    mu.append((name, state.get("exp_avg", zeros)))
    nu.append((name, state.get("exp_avg_sq", zeros)))
  return {"0": {"count": np.asarray(count or 0, np.int32),
                "mu": _params_tree(mu), "nu": _params_tree(nu)},
          "1": {}}


def load_adam_state_from_jax(model: torch.nn.Module,
                             optimizer: torch.optim.Optimizer,
                             opt_state: Mapping) -> None:
  """Loads optax.adam's state (as flax serializes it) into `optimizer`,
  whose parameters are `model`'s; the moments move to each parameter's
  device and dtype."""
  adam = opt_state["0"]
  step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
  exp_avg = state_dict_from_jax({"params": adam["mu"]})
  exp_avg_sq = state_dict_from_jax({"params": adam["nu"]})
  name_of = {id(p): n for n, p in model.named_parameters()}
  order = [p for group in optimizer.param_groups for p in group["params"]]
  if sorted(name_of[id(p)] for p in order) != sorted(exp_avg):
    raise ValueError("the optimizer's parameters are not the checkpoint's")
  state = {i: {"step": step.clone(), "exp_avg": exp_avg[name_of[id(p)]],
               "exp_avg_sq": exp_avg_sq[name_of[id(p)]]}
           for i, p in enumerate(order)}
  optimizer.load_state_dict({
      "state": state, "param_groups": optimizer.state_dict()["param_groups"]})
