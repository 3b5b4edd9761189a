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
new arrays. :meth:`Optimizer.update` is :meth:`~Optimizer.accumulate`
then :meth:`~Optimizer.apply`; a caller whose leaves are split into
parts (the sharded steps of :mod:`~tpu_dist_nn_torch.parallel.zero`)
calls the two on each part, with the global norm of every part and the
count advanced once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

B1, B2, EPS = 0.9, 0.999, 1e-8

#: Counts past which every table entry is constant: f32(0.999)**t rounds
#: to below half an ulp of 1 from t ~ 17,400 on, so ``1 - b**t`` is 1.0
#: there; a schedule is constant past ``total_steps``. Reads clamp to
#: the table's end.
_MIN_TABLE = 20_000


@dataclasses.dataclass
class OptState:
    """Adam's moments and count, and ``MultiSteps``' accumulator. Every
    tensor is updated in place (a captured step replays on the same
    addresses); ``mini_step`` is the host's micro-step index."""

    count: torch.Tensor | int  # real updates applied (the schedules' step), int64 on the card
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    mini_step: int = 0
    acc: list[torch.Tensor] | None = None


def _device_groups(tensors: Sequence[torch.Tensor]) -> dict:
    """``{device: [indices]}`` of ``tensors``: a pipeline's leaves may
    sit on several cards, and one ``_foreach_*`` call takes one."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.device, []).append(i)
    return groups


class Optimizer:
    """Adam with the controls above; build it with :func:`build_optimizer`.

    The step is device work only: the count is a device tensor, and the
    learning rate and the bias corrections are read from device tables
    indexed by it (computed on the host with the arithmetic of
    :meth:`lr` and optax's float32 ``1 - b**t``), so a CUDA graph of the
    step replays every later step correctly."""

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
        self._tables: dict = {}

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

    def tables(self, device) -> torch.Tensor:
        """``(3, n)`` float32 on ``device``: row 0 the negated learning
        rate at count ``i``, rows 1-2 optax's ``1 - b1**(i + 1)`` and
        ``1 - b2**(i + 1)`` (float32 powers of the float32-rounded b:
        f32(0.999) is 1.3e-8 above 0.999, 1e-5 of ``1 - b``)."""
        device = torch.device(device)
        if device not in self._tables:
            n = max(_MIN_TABLE, (self.total_steps or 0) + 1, self.warmup_steps + 1)
            b1, b2 = np.float32(B1), np.float32(B2)
            rows = np.empty((3, n), np.float32)
            for i in range(n):
                t = np.float32(i + 1)
                rows[0, i] = -self.lr(i)
                rows[1, i] = 1 - b1 ** t
                rows[2, i] = 1 - b2 ** t
            self._tables[device] = torch.from_numpy(rows).to(device)
        return self._tables[device]

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return OptState(
            count=torch.zeros((), dtype=torch.int64, device=params[0].device),
            mu=zeros, nu=[torch.zeros_like(z) for z in zeros],
            acc=[torch.zeros_like(z) for z in zeros] if self.grad_accum > 1 else None)

    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor], *,
               micro_step: int | None = None) -> list[torch.Tensor] | None:
        """The updates to add to ``params`` (``state``'s tensors advance
        in place), or ``None`` on a micro-step that only accumulates.

        ``micro_step`` None reads ``state.mini_step`` and advances it;
        a given ``micro_step`` (a captured step's role) is used as it is
        and ``state.mini_step`` is left to the caller
        (:meth:`next_micro_step`)."""
        n = state.mini_step if micro_step is None else micro_step
        if micro_step is None:
            state.mini_step = self.next_micro_step(n)
        grads = self.accumulate(grads, state, n)
        return None if grads is None else self.apply(grads, state, params)

    def accumulate(self, grads: Sequence[torch.Tensor], state: OptState,
                   micro_step: int) -> list[torch.Tensor] | None:
        """``grads`` folded into ``state.acc`` at ``micro_step``: the
        gradients to apply (the mean, ``acc`` zeroed) on the last
        micro-step, else None; ``grads`` themselves without accumulation."""
        grads = [g.detach() for g in grads]
        if self.grad_accum == 1:
            return grads
        # acc + (g - acc) / (n + 1), in place
        delta = torch._foreach_sub(grads, state.acc)
        torch._foreach_div_(delta, micro_step + 1)
        torch._foreach_add_(state.acc, delta)
        if micro_step < self.grad_accum - 1:
            return None
        grads = [a.clone() for a in state.acc]
        torch._foreach_zero_(state.acc)
        return grads

    def apply(self, grads: Sequence[torch.Tensor], state: OptState,
              params: Sequence[torch.Tensor], *, norm: torch.Tensor | None = None,
              advance: bool = True) -> list[torch.Tensor]:
        """Clip, then Adam: the updates to add to ``params`` (``state``'s
        moments advance in place). ``norm``: ``clip_norm``'s global norm
        when ``grads`` are one part of the leaves (default: their own).
        ``advance=False`` leaves ``state.count`` to the caller, who
        advances it once for all the parts."""
        if self.clip_norm is not None:
            if norm is None:
                # Leaves may sit on several cards (a pipeline's stages).
                norm = torch.sqrt(sum(torch.sum(g * g).to(grads[0].device) for g in grads))
            norms = [norm.to(g.device) for g in grads]
            grads = [torch.where(n < self.clip_norm, g, (g / n) * self.clip_norm)
                     for g, n in zip(grads, norms)]
        count = state.count
        table = self.tables(count.device)
        # index_select, not table[:, count]: a 0-d index tensor would be
        # read on the host (a sync, refused inside a capture)
        rows = table.index_select(1, count.clamp(max=table.shape[1] - 1).reshape(1))[:, 0]
        updates = [None] * len(grads)
        for dev, idx in _device_groups(params).items():
            g, mu, nu = ([t[i] for i in idx] for t in (grads, state.mu, state.nu))
            step, c1, c2 = rows.to(dev).unbind(0)
            # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
            g1 = torch._foreach_mul(g, 1 - B1)
            torch._foreach_mul_(mu, B1)
            torch._foreach_add_(mu, g1)
            g2 = torch._foreach_mul(g, g)
            torch._foreach_mul_(g2, 1 - B2)
            torch._foreach_mul_(nu, B2)
            torch._foreach_add_(nu, g2)
            # (mu / c1) / (sqrt(nu / c2) + eps)
            u = torch._foreach_div(mu, c1)
            den = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, EPS)
            torch._foreach_div_(u, den)
            if self.weight_decay:
                torch._foreach_add_(u, torch._foreach_mul([params[i].detach() for i in idx],
                                                          self.weight_decay))
            torch._foreach_mul_(u, step)
            for i, ui in zip(idx, u):
                updates[i] = ui
        if advance:
            count.add_(1)
        return updates

    def next_micro_step(self, micro_step: int) -> int:
        """The host's micro-step index after a step made at ``micro_step``."""
        return (micro_step + 1) % self.grad_accum


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor]) -> None:
    """``p += u`` in place (``optax.apply_updates``), one multi-tensor
    add a device."""
    for idx in _device_groups(params).values():
        torch._foreach_add_([params[i] for i in idx],
                            [updates[i].to(params[i].dtype) for i in idx])


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
