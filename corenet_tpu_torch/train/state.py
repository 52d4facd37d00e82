"""Training state: the model (parameters and batch statistics), its Adam
optimizer, and the global step.

Counterpart of corenet_tpu/train/state.py. The JAX package's state is an
immutable tree; here the model's parameters, its BatchRenorm statistics
and the optimizer's moments are updated in place by each step, and the
state object only carries them beside `global_step`, which counts
examples (the reference's convention: += batch per step).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from corenet_tpu_torch.models.corenet import CoreNet
from corenet_tpu_torch.utils.device import checked_device


@dataclasses.dataclass(frozen=True)
class TrainState:
  model: CoreNet
  optimizer: torch.optim.Optimizer
  global_step: int  # counts examples


def create_optimizer(params: Iterable[torch.nn.Parameter],
                     learning_rate: float = 4e-4,
                     adam_epsilon: float = 1e-4) -> torch.optim.Adam:
  """Adam with the reference's hyper-parameters (lr 4e-4, eps 1e-4, betas
  0.9 and 0.999). torch's update, lr·m/(1 − β1ᵗ) / (√v/√(1 − β2ᵗ) + eps),
  is optax.adam's lr·m̂/(√v̂ + eps) in other algebra."""
  return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                          eps=adam_epsilon)


def create_train_state(model: CoreNet, learning_rate: float = 4e-4,
                       adam_epsilon: float = 1e-4, global_step: int = 0,
                       device="cuda") -> TrainState:
  """Moves `model` (its weights already loaded or initialized) to `device`
  in train mode and gives it a fresh Adam optimizer."""
  device = checked_device(device)
  model.to(device).train()
  optimizer = create_optimizer(model.parameters(), learning_rate,
                               adam_epsilon)
  return TrainState(model=model, optimizer=optimizer,
                    global_step=int(global_step))
