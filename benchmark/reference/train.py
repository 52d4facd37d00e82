"""Plain reference of the first training steps: the loss of the fine
model's logits against the batch's labels, its gradients by autograd and
Adam's update, from the benchmark's own initial weights, in the
configuration's precision."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from benchmark.reference import model as ref


def steps(p0: Dict[str, torch.Tensor], batches: Sequence[dict], resolution,
          lr: float, eps: float, prec: ref.Precision,
          trail: bool = False) -> dict:
  """Runs one train-mode step per batch (dict of image uint8 [B, H, W,
  3], camera [B, 4, 4], labels [B, D, H, W]) and returns the losses, each
  leaf's gradient norm in the first step, each leaf's change after the
  last step and, with `trail`, the leaves after each step, on the
  host."""
  p = {k: v.clone() for k, v in p0.items()}
  leaves = ref.trainable(p)
  adam = ref.Adam(lr, eps)
  losses: List[float] = []
  first_grad = {}
  after = []
  m = resolution[0]
  for i, batch in enumerate(batches):
    b = batch["image"].shape[0]
    dev = batch["image"].device
    v2x = torch.diag(torch.tensor([float(m)] * 3 + [1.0],
                                  device=dev)).expand(b, 4, 4)
    v2s = ref.compute_v2s(batch["camera"], v2x)
    offset = torch.full((b, 3), 0.5, device=dev)
    for k in leaves:
      p[k] = p[k].detach().requires_grad_(True)
    logits = ref.forward(p, batch["image"], v2s, offset, resolution, True,
                         prec)
    loss = ref.fgbg_loss(batch["labels"], logits)
    grads = torch.autograd.grad(loss, [p[k] for k in leaves])
    del logits
    losses.append(loss.item())
    if i == 0:
      first_grad = dict(zip(leaves, torch.stack(
          [g.norm() for g in grads]).tolist()))
    for k in leaves:
      p[k] = p[k].detach()
    adam.step(p, dict(zip(leaves, grads)))
    del grads
    if trail:
      after.append({k: p[k].to("cpu", torch.float32, copy=True)
                    for k in leaves})
  change = dict(zip(leaves, torch.stack(
      [(p[k] - p0[k]).norm() for k in leaves]).tolist()))
  return {"losses": losses, "grad": first_grad, "change": change,
          "trail": after}
