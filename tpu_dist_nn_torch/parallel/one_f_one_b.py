"""Pipelined training schedules (dense chains): GPipe, 1F1B, interleaved.

Port of the dense half of :mod:`tpu_dist_nn.parallel.one_f_one_b`:
``validate_schedule``, the 1F1B loss-and-grad (``compiled_1f1b_grad``),
the interleaved one (``compiled_interleaved_dense_grad``) and the
masked softmax-CE tail. The JAX package plays each schedule as one
``lax.scan`` with ``jax.vjp`` ticks; the port is eager autograd played
in the schedule's op order by :func:`run_schedule`:

* a FWD op runs a chunk on a detached copy of its input that requires
  grad, and stashes ``(input, output)``;
* a BWD op calls ``torch.autograd.backward(output, grad_from_next)`` (or
  backward of the tail's loss at the last chunk), which sums the
  chunk's weight gradients into their ``.grad`` and leaves the input's
  gradient for the chunk before.

Each op is issued on its slot's stream (:func:`gpipe.launch`); autograd
runs a backward op on its forward op's stream, and the hand-offs carry
events both ways. The orders:

* ``gpipe``: every forward in GPipe order, then every backward
  (activation memory grows with M);
* ``1f1b``: forward of microbatch ``f`` on stage ``s`` at tick
  ``s + 2f``, its backward at ``2S - 1 - s + 2f`` — at most ``S - s``
  microbatches in flight on stage ``s``, so activation memory is O(S);
* ``interleaved``: the table of
  :func:`~tpu_dist_nn_torch.parallel.schedule_table.build_interleaved_1f1b`.

The loss is the masked mean CE over real rows: the tail's mask arrives
pre-scaled by the global row count, so each microbatch's contribution
needs no cross-microbatch state (``one_f_one_b.py:424-427``).
"""

from __future__ import annotations

import torch

from tpu_dist_nn_torch.parallel.gpipe import launch
from tpu_dist_nn_torch.parallel.interleaved import interleaved_1f1b_order
from tpu_dist_nn_torch.parallel.mesh import Mesh
from tpu_dist_nn_torch.parallel.schedule_table import BWD, FWD

#: The pipeline training schedules the JAX package names; the port's
#: dense pipeline trains the first three.
SCHEDULES = ("gpipe", "1f1b", "interleaved", "zb", "zb-v", "zb-stash")
ZERO_BUBBLE = ("zb", "zb-v", "zb-stash")


def validate_schedule(schedule: str, *, lm: bool = False) -> str:
    """The single validation point for schedule names. ``lm=True``: the
    LM pipeline's, which refuses the zero-bubble schedules by what they
    need."""
    if schedule not in SCHEDULES:
        raise ValueError(
            f"unknown pipeline schedule {schedule!r}: use "
            + " or ".join(repr(s) for s in SCHEDULES)
        )
    if lm and schedule in ZERO_BUBBLE:
        raise ValueError(
            f"schedule={schedule!r} is not ported for the LM pipeline: the zero-bubble "
            "schedules need the split backward (split_backward.py) and its tables "
            "(schedule_table.build_zero_bubble / build_zb_v); use 'gpipe', '1f1b' or "
            "'interleaved'"
        )
    return schedule


def masked_ce_tail(logits: torch.Tensor, labels: torch.Tensor,
                   mask_scaled: torch.Tensor) -> torch.Tensor:
    """A microbatch's share of the masked mean CE: ``mask_scaled`` is
    the row mask already divided by the global row count."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(1, labels[:, None].long())[:, 0]
    return -(ll * mask_scaled).sum()


def gpipe_order(num_stages: int, num_microbatches: int):
    """Every forward in GPipe order (stage ``s`` on microbatch ``t - s``
    at step ``t``), then every backward mirrored from the last stage."""
    S, M = num_stages, num_microbatches
    fwd = [(s, FWD, s, t - s) for t in range(M + S - 1) for s in range(S) if 0 <= t - s < M]
    bwd = [(s, BWD, s, t - (S - 1 - s)) for t in range(M + S - 1)
           for s in reversed(range(S)) if 0 <= t - (S - 1 - s) < M]
    return fwd + bwd


def one_f_one_b_order(num_stages: int, num_microbatches: int):
    """The 1F1B ticks: forward of ``f`` on stage ``s`` at ``s + 2f``,
    backward at ``2S - 1 - s + 2f``; ``T = 2(M + S - 1)``."""
    S, M = num_stages, num_microbatches
    order = []
    for t in range(2 * (M + S - 1)):
        for s in range(S):
            tf, tb = t - s, t - (2 * S - 1 - s)
            if 0 <= tf < 2 * M and tf % 2 == 0:
                order.append((s, FWD, s, tf // 2))
            elif 0 <= tb < 2 * M and tb % 2 == 0:
                order.append((s, BWD, s, tb // 2))
    return order


def training_order(schedule: str, num_stages: int, num_virtual: int, num_microbatches: int):
    """``(slot, op, chunk, microbatch)`` in issue order for a schedule."""
    if schedule == "interleaved":
        return interleaved_1f1b_order(num_stages, num_virtual, num_microbatches)
    if num_virtual != 1:
        raise ValueError(f"num_virtual={num_virtual} only applies to schedule='interleaved'")
    if schedule == "1f1b":
        return one_f_one_b_order(num_stages, num_microbatches)
    return gpipe_order(num_stages, num_microbatches)


def _use_here(t: torch.Tensor) -> torch.Tensor:
    if t.is_cuda:
        t.record_stream(torch.cuda.current_stream(t.device))
    return t


def run_schedule(mesh: Mesh, chunk_fns, order, xs, labels, masks, tail=masked_ce_tail) -> list:
    """Play a training ``order`` over every data replica.

    ``chunk_fns[d][c](x) -> logits-or-activation`` with autograd on
    (chunk ``c`` on slot ``(c % S, d)``; a chunk may also enqueue work on
    that cell's other model slots); ``xs[m][d]`` the input rows on the
    replica's first slot; ``labels[m][d]`` and ``masks[m][d]``
    (pre-scaled) on its last chunk's slot, where ``tail(y, labels,
    masks)`` gives a microbatch's share of the loss (default: the masked
    CE). Weight gradients are summed into the chunks' leaves' ``.grad``.
    Returns ``[(loss, event)]``, one per (microbatch, replica): each a
    detached scalar with the event after it. Before the first op every
    slot stream waits for its card's current stream (the inputs' copies
    and the last optimizer update); after the last, every card's current
    stream waits for its slots, so the caller may read ``.grad`` there.
    """
    S, D = mesh.spec.stage, mesh.spec.data
    V = len(chunk_fns[0])
    slots = [slot for s in range(S) for d in range(D) for slot in mesh.model_slots[s][d]]
    for slot in slots:
        if slot.stream is not None:
            slot.stream.wait_stream(torch.cuda.current_stream(slot.device))
    acts = {(-1, m, d): (x, None) for m, row in enumerate(xs) for d, x in enumerate(row)}
    stash, grads, losses = {}, {}, []
    for s, op, c, m in order:
        for d in range(D):
            slot = mesh.slots[s][d]
            if op == FWD:
                def fwd(x, fn=chunk_fns[d][c], c=c):
                    x_in = x.detach().requires_grad_(c > 0)
                    return x_in, fn(x_in)

                (x_in, y), ev = launch(slot, fwd, *acts.pop((c - 1, m, d)))
                stash[(c, m, d)] = (x_in, y)
                if c < V - 1:
                    acts[(c, m, d)] = (y.detach(), ev)
                continue
            x_in, y = stash.pop((c, m, d))
            if c == V - 1:
                def last(_, y=y, x_in=x_in, lab=labels[m][d], msk=masks[m][d]):
                    loss = tail(y, _use_here(lab), None if msk is None else _use_here(msk))
                    torch.autograd.backward(loss)
                    return x_in.grad, loss.detach()

                (dx, loss), ev = launch(slot, last, None)
                losses.append((loss, ev))
            else:
                def bwd(dy, y=y, x_in=x_in):
                    if y.requires_grad:
                        torch.autograd.backward(y, dy)
                    return x_in.grad, None

                (dx, _), ev = launch(slot, bwd, *grads.pop((c + 1, m, d)))
            if c > 0:
                grads[(c, m, d)] = (dx, ev)
    for slot in slots:
        if slot.stream is not None:
            torch.cuda.current_stream(slot.device).wait_stream(slot.stream)
    return losses
