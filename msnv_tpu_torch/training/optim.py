"""Optimizer: element-wise-clipped Adam with optional multi-step LR decay.

Port of the JAX package's training/optim.py (an optax chain there) as plain
tensor code, with the same numbers:
- every gradient element is clipped to [-grad_clip, grad_clip] BEFORE the
  Adam update (the reference hardtanh's every grad, ref optim.py:4-21);
- Adam with b1 0.9, b2 0.999, eps 1e-8 added outside the square root after
  bias correction;
- optional MultiStepLR(milestones, gamma) stepped per EPOCH, expressed per
  step: a milestone's scale applies from the update whose count of updates
  already made EQUALS milestone * steps_per_epoch.

The state is {"count": int, "mu": tree, "nu": tree}: `count` is the number
of updates made, `mu` / `nu` are float32 trees in the parameter tree's
layout. `update` changes params and state IN PLACE and returns them.
"""

from __future__ import annotations

import numpy as np
import torch

from msnv_tpu_torch.config import TrainConfig
from msnv_tpu_torch.tree import tree_leaves, tree_map

B1, B2, EPS = 0.9, 0.999, 1e-8


def lr_schedule(cfg: TrainConfig, steps_per_epoch: int):
    """count -> learning rate: equal to epoch-stepped MultiStepLR."""
    if not cfg.scheduler:
        return lambda count: cfg.learning_rate
    boundaries = {int(m) * steps_per_epoch: cfg.scheduler_gamma
                  for m in cfg.scheduler_milestones}

    def schedule(count: int) -> float:
        lr = cfg.learning_rate
        for boundary, scale in boundaries.items():
            if count >= boundary:
                lr *= scale
        return lr

    return schedule


class ClippedAdam:
    """clip-by-value, then Adam; see the module docstring."""

    def __init__(self, schedule, grad_clip: float):
        self.schedule = schedule
        self.grad_clip = grad_clip

    def init(self, params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(self, grads, opt_state, params):
        """One update, in place -> (params, opt_state)."""
        count = opt_state["count"]
        lr = self.schedule(count)
        step = count + 1
        # bias corrections in float32, as optax computes them
        bc1 = float(1 - np.float32(B1) ** np.float32(step))
        bc2 = float(1 - np.float32(B2) ** np.float32(step))
        for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(opt_state["mu"]),
                                tree_leaves(opt_state["nu"])):
            g = g.to(torch.float32).clamp(-self.grad_clip, self.grad_clip)
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            denom = (nu / bc2).sqrt_().add_(EPS)
            p.addcdiv_(mu, denom, value=-lr / bc1)
        opt_state["count"] = step
        return params, opt_state


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int = 1):
    """The clipped Adam of a TrainConfig."""
    return ClippedAdam(lr_schedule(cfg, steps_per_epoch), cfg.grad_clip)
