"""Optimizer shared by the port's trainers, matched to optax.

Port of :mod:`tpu_dist_nn.train.optimizers`: :func:`build_optimizer`
returns Adam (optax's defaults: b1 0.9, b2 0.999, eps 1e-8) with the
same controls, in the same order and with the same arithmetic as the
optax chain the JAX package builds:

* ``clip_norm`` — ``optax.clip_by_global_norm``: gradients scaled by
  ``clip_norm / norm`` when the global norm is not below ``clip_norm``
  (not ``torch.nn.utils.clip_grad_norm_``'s ``norm + 1e-6``);
* ``warmup_steps`` — linear 0 -> lr; ``schedule="cosine"`` then decays
  to 0 at ``total_steps`` (``optax.warmup_cosine_decay_schedule``);
  each schedule is read at the count *before* the update, so the first
  warmup update has lr 0;
* ``weight_decay`` — decoupled, ``optax.adamw``: ``u + wd * p`` before
  the learning rate;
* ``grad_accum`` — ``optax.MultiSteps``: a running mean of the
  micro-step gradients, one real update every ``grad_accum`` calls.

The optimizer works on a list of tensors; the trainer applies the
updates in place (:func:`apply_updates`) where the JAX package returns
new arrays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class OptState:
    """Adam's moments and count, and ``MultiSteps``' accumulator."""

    count: int  # real updates applied (the schedules' step)
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    mini_step: int = 0
    acc: list[torch.Tensor] | None = None


class Optimizer:
    """Adam with the controls above; build it with :func:`build_optimizer`."""

    def __init__(self, learning_rate: float, *, schedule: str, warmup_steps: int,
                 total_steps: int | None, clip_norm: float | None, weight_decay: float,
                 grad_accum: int):
        self.learning_rate = float(learning_rate)
        self.schedule = schedule
        self.warmup_steps = warmup_steps
        self.total_steps = total_steps
        self.clip_norm = clip_norm
        self.weight_decay = weight_decay
        self.grad_accum = grad_accum

    def lr(self, count: int) -> float:
        """The learning rate of the update made at ``count`` real updates."""
        lr, w = self.learning_rate, self.warmup_steps
        if self.schedule == "cosine":
            if count < w:
                return lr * count / w
            decay = self.total_steps - w
            c = min(count - w, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))
        if w and count < w:
            return lr * count / w
        return lr

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return OptState(
            count=0, mu=zeros, nu=[torch.zeros_like(z) for z in zeros],
            acc=[torch.zeros_like(z) for z in zeros] if self.grad_accum > 1 else None)

    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]) -> list[torch.Tensor] | None:
        """The updates to add to ``params`` (``state`` advances in
        place), or ``None`` on a micro-step that only accumulates."""
        grads = [g.detach() for g in grads]
        if self.grad_accum > 1:
            n = state.mini_step
            state.acc = [a + (g - a) / (n + 1) for a, g in zip(state.acc, grads)]
            if n < self.grad_accum - 1:
                state.mini_step = n + 1
                return None
            grads, state.acc = state.acc, [torch.zeros_like(a) for a in state.acc]
            state.mini_step = 0
        if self.clip_norm is not None:
            # Leaves may sit on several cards (a pipeline's stages).
            norm = torch.sqrt(sum(torch.sum(g * g).to(grads[0].device) for g in grads))
            norms = [norm.to(g.device) for g in grads]
            grads = [torch.where(n < self.clip_norm, g, (g / n) * self.clip_norm)
                     for g, n in zip(grads, norms)]
        t = state.count + 1
        state.mu = [(1 - B1) * g + B1 * m for g, m in zip(grads, state.mu)]
        state.nu = [(1 - B2) * (g * g) + B2 * v for g, v in zip(grads, state.nu)]
        # optax's bias correction, 1 - b**t, is float32 arithmetic on the
        # float32-rounded b (f32(0.999) is 1.3e-8 above 0.999: 1e-5 of 1 - b)
        c1, c2 = (float(1 - np.float32(b) ** np.float32(t)) for b in (B1, B2))
        updates = [(m / c1) / (torch.sqrt(v / c2) + EPS) for m, v in zip(state.mu, state.nu)]
        if self.weight_decay:
            updates = [u + self.weight_decay * p.detach() for u, p in zip(updates, params)]
        step = -self.lr(state.count)
        state.count = t
        return [step * u for u in updates]


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor]) -> None:
    """``p += u`` in place (``optax.apply_updates``)."""
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))


def build_optimizer(learning_rate: float, *, schedule: str = "constant",
                    warmup_steps: int = 0, total_steps: int | None = None,
                    clip_norm: float | None = None, weight_decay: float = 0.0,
                    grad_accum: int = 1) -> Optimizer:
    """-> the trainers' optimizer (see the module docstring), with the
    JAX package's validation. ``warmup_steps`` and ``total_steps`` are in
    micro-steps; under ``grad_accum`` they convert to real updates here
    (warmup rounded up)."""
    if schedule not in ("constant", "cosine"):
        raise InvalidArgumentError(f"unknown lr schedule: {schedule!r}")
    if warmup_steps < 0:
        raise InvalidArgumentError(f"warmup_steps must be >= 0, got {warmup_steps}")
    if clip_norm is not None and clip_norm <= 0:
        raise InvalidArgumentError(f"clip_norm must be > 0, got {clip_norm}")
    if weight_decay < 0:
        raise InvalidArgumentError(f"weight_decay must be >= 0, got {weight_decay}")
    if grad_accum < 1:
        raise InvalidArgumentError(f"grad_accum must be >= 1, got {grad_accum}")
    if grad_accum > 1:
        if total_steps is not None:
            if total_steps < grad_accum:
                raise InvalidArgumentError(
                    f"total_steps={total_steps} < grad_accum={grad_accum}: "
                    "no optimizer update would ever run")
            if total_steps % grad_accum:
                import warnings

                warnings.warn(
                    f"total_steps={total_steps} is not a multiple of "
                    f"grad_accum={grad_accum}: the final "
                    f"{total_steps % grad_accum} micro-steps accumulate "
                    "gradients that never apply", stacklevel=2)
            total_steps = total_steps // grad_accum
        warmup_steps = -(-warmup_steps // grad_accum)
    if schedule == "cosine" and (not total_steps or total_steps <= warmup_steps):
        detail = f"({total_steps} vs {warmup_steps}"
        if grad_accum > 1:
            detail += (f" real updates, converted from the given micro-step "
                       f"counts by grad_accum={grad_accum}")
        raise InvalidArgumentError(
            f"cosine schedule needs total_steps > warmup_steps {detail})")
    return Optimizer(learning_rate, schedule=schedule, warmup_steps=warmup_steps,
                     total_steps=total_steps, clip_norm=clip_norm,
                     weight_decay=weight_decay, grad_accum=grad_accum)
