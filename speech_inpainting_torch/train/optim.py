"""optax's AdamW and its exponential-decay schedule, for the trainers.

Counterpart of the `optax.adamw` the JAX package's trainers build
(train/ea.py, train/gan.py): `AdamW` applies optax's update in optax's order
of operations, and `exponential_decay` is optax's staircase schedule of
that name, evaluated in float32 as XLA evaluates it.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..parallel.distributed import local_shard


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float) -> Callable[[int], float]:
    """optax.exponential_decay(staircase=True): count →
    init·decay^⌊count/transition_steps⌋, in float32; init_value itself at
    count 0, as optax's `where(count <= 0, init, …)` gives it."""
    init = np.float32(init_value)
    rate = np.float32(decay_rate)

    def schedule(count: int) -> float:
        if count <= 0:
            return float(init)
        p = np.floor(np.float32(count) / np.float32(transition_steps))
        return float(init * np.power(rate, np.float32(p)))

    return schedule


class AdamW(torch.optim.Optimizer):
    """optax.adamw's update, in optax's order of operations, so that a
    parameter rounds as the JAX package's does (torch.optim.AdamW computes
    the same terms but combines them in another order, which moves a
    parameter near 1 by an ulp or two):
        mu ← (1 − b1)·g + b1·mu,  nu ← (1 − b2)·g² + b2·nu,
        u  ← (mu / (1 − b1^t)) / (√(nu / (1 − b2^t)) + eps) + wd·p,
        p  ← p + (−lr)·u.
    One count t per group, advanced only by `step`; multi-tensor (foreach)
    operations over each group. A parameter whose `.grad` is None is
    stepped with a zero gradient, as optax steps every leaf of its tree:
    its moments decay and the weight decay still moves it. A parameter
    that must not move (optax.set_to_zero in the JAX package) stays out of
    the optimizer. A DTensor parameter (parallel/tp.py) steps the shard
    this rank holds, its moments of that shard's shape. With a `schedule`, each group's lr is
    schedule(t − 1), the count before this update, as optax's
    scale_by_schedule reads its own count (advanced with Adam's)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 schedule: Optional[Callable[[int], float]] = None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.schedule = schedule

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    shard = local_shard(p)
                    self.state[p].update(step=0,
                                         exp_avg=torch.zeros_like(shard),
                                         exp_avg_sq=torch.zeros_like(shard))
            states = [self.state[p] for p in params]
            grads = [torch.zeros_like(local_shard(p)) if p.grad is None
                     else local_shard(p.grad) for p in params]
            params = [local_shard(p) for p in params]
            mu = [s["exp_avg"] for s in states]
            nu = [s["exp_avg_sq"] for s in states]
            b1, b2 = group["betas"]
            t = states[0]["step"] + 1
            for s in states:
                s["step"] = t
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1 - b2)
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, sq)
            u = torch._foreach_div(mu, 1 - b1 ** t)
            den = torch._foreach_div(nu, 1 - b2 ** t)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            torch._foreach_div_(u, den)
            del den
            torch._foreach_add_(u, torch._foreach_mul(
                params, group["weight_decay"]))
            lr = group["lr"] if self.schedule is None else self.schedule(t - 1)
            torch._foreach_mul_(u, -lr)
            torch._foreach_add_(params, u)
