"""Pipelined training schedules: GPipe, 1F1B, interleaved and zero bubble.

Port of :mod:`tpu_dist_nn.parallel.one_f_one_b` (``validate_schedule``,
the 1F1B loss-and-grad, the masked softmax-CE tail) and of the table
executor of :mod:`tpu_dist_nn.parallel.interleaved`, split backward
included. The JAX package plays each schedule as one ``lax.scan`` with
``jax.vjp`` ticks; the port is eager autograd played in the schedule's
op order by :func:`run_schedule`:

* a FWD op runs a chunk on a detached copy of its input that requires
  grad, and stashes ``(input, output)``;
* a BWD op calls ``torch.autograd.backward(output, grad_from_next)`` (or
  backward of the tail's loss at the last chunk), which sums the
  chunk's weight gradients into their ``.grad`` and leaves the input's
  gradient for the chunk before;
* the zero-bubble schedules split BWD into BWD_B (the input gradient,
  sent upstream at once) and BWD_W (the weight gradient, parked in a
  bubble tick). The recompute split (``zb``, ``zb-v``): B runs the
  backward to the chunk's input only and keeps the autograd graph; W
  runs it again to the chunk's weights, from the parked ``(output,
  dy)``, and frees it. Under ``cfg.remat`` each backward recomputes the
  checkpointed blocks, so a block costs 3 attention forwards and 2
  backwards a microbatch (chunk 0, which has no input cotangent, skips
  B's: 2 and 1). The cotangent-stash split (``zb-stash``) hands B and W
  to a split object (:class:`~tpu_dist_nn_torch.parallel.
  transformer_pipeline.StashSplit`): the FWD op runs without a graph,
  B runs the chunk forward once more keeping each sub-op's vjp, then the
  backward with the dW GEMMs left out, and W runs those GEMMs only: 2
  forwards and 1 backward a block, whatever ``cfg.remat``.

Each op is issued on its slot's stream (:func:`gpipe.launch`); autograd
runs a backward op on its forward op's stream, and the hand-offs carry
events both ways. The orders:

* ``gpipe``: every forward in GPipe order, then every backward
  (activation memory grows with M);
* ``1f1b``: forward of microbatch ``f`` on stage ``s`` at tick
  ``s + 2f``, its backward at ``2S - 1 - s + 2f`` — at most ``S - s``
  microbatches in flight on stage ``s``, so activation memory is O(S);
* ``interleaved``, ``zb``, ``zb-v``, ``zb-stash``: the tables of
  :mod:`~tpu_dist_nn_torch.parallel.schedule_table`
  (:func:`schedule_tables`).

The loss is the masked mean CE over real rows: the tail's mask arrives
pre-scaled by the global row count, so each microbatch's contribution
needs no cross-microbatch state (``one_f_one_b.py:424-427``).

The aux channel (``with_aux``, the JAX executors' ``with_aux``): a chunk
gives ``(y, aux)``, ``aux`` a scalar that arrives pre-scaled (the router
loss of a mixture-of-experts chunk, its weight and ``1 / (chunks *
microbatches * shards)`` folded in). Its backward adds it to the loss
and sends cotangent 1 into the chunk's backward beside ``y``'s; on the
split schedules its input gradient rides BWD_B and its weight gradient
BWD_W, as ``interleaved.make_interleaved_1f1b`` routes them.
"""

from __future__ import annotations

import torch

from tpu_dist_nn_torch.parallel.gpipe import launch
from tpu_dist_nn_torch.parallel.interleaved import table_order
from tpu_dist_nn_torch.parallel.mesh import Mesh
from tpu_dist_nn_torch.parallel.schedule_table import (
    BWD,
    BWD_W,
    FWD,
    build_interleaved_1f1b,
    build_zb_v,
    build_zero_bubble,
)

#: The pipeline training schedules the JAX package names; the dense
#: pipeline trains the first three, the LM pipeline all six.
SCHEDULES = ("gpipe", "1f1b", "interleaved", "zb", "zb-v", "zb-stash")


def validate_schedule(schedule: str) -> str:
    """The single validation point for schedule names."""
    if schedule not in SCHEDULES:
        raise ValueError(
            f"unknown pipeline schedule {schedule!r}: use "
            + " or ".join(repr(s) for s in SCHEDULES)
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


def schedule_tables(schedule: str, num_stages: int, num_virtual: int, num_microbatches: int):
    """The tables of a table-driven schedule: interleaved, zb and
    zb-stash (ZB-H1 on ``num_virtual`` chunks a slot), zb-v (the V
    shape: two chunks a slot). None for gpipe and 1f1b, whose orders
    are closed-form, chunk ``c`` on slot ``c``."""
    S, v, M = num_stages, num_virtual, num_microbatches
    if schedule == "interleaved":
        return build_interleaved_1f1b(S, v, M)
    if schedule in ("zb", "zb-stash"):
        return build_zero_bubble(S, v, M)
    if schedule == "zb-v":
        return build_zb_v(S, M)
    return None


def training_order(schedule: str, num_stages: int, num_virtual: int, num_microbatches: int):
    """``(slot, op, chunk, microbatch)`` in issue order for a schedule."""
    tables = schedule_tables(schedule, num_stages, num_virtual, num_microbatches)
    if tables is not None:
        return table_order(tables)
    if num_virtual != 1:
        raise ValueError(f"num_virtual={num_virtual} only applies to schedule='interleaved'")
    if schedule == "1f1b":
        return one_f_one_b_order(num_stages, num_microbatches)
    return gpipe_order(num_stages, num_microbatches)


def _use_here(t):
    """``t`` (a tensor, a tuple of seq shards or None) read on the
    current stream: recorded there for the caching allocator."""
    if isinstance(t, tuple):
        return tuple(_use_here(x) for x in t)
    if t is not None and t.is_cuda:
        t.record_stream(torch.cuda.current_stream(t.device))
    return t


def _detached(x, requires_grad: bool | None = None):
    """``x.detach()`` (requiring grad when asked), shard by shard for a
    tuple of seq shards."""
    if isinstance(x, tuple):
        return tuple(_detached(t, requires_grad) for t in x)
    return x.detach() if requires_grad is None else x.detach().requires_grad_(requires_grad)


def _grad_of(x):
    return tuple(t.grad for t in x) if isinstance(x, tuple) else x.grad


def _backward_pair(out, dy, aux):
    """The ``(tensors, cotangents)`` of a chunk's backward: ``out`` (a
    tensor or a tuple of shards) with ``dy``, and a pre-scaled ``aux``
    with cotangent 1."""
    outs = list(out) if isinstance(out, tuple) else [out]
    dys = list(dy) if isinstance(dy, tuple) else [dy]
    if aux is not None:
        outs.append(aux)
        dys.append(torch.ones_like(aux))
    return outs, dys


def run_schedule(mesh: Mesh, chunk_fns, order, xs, labels, masks, tail=masked_ce_tail, *,
                 weights=None, split=None, with_aux: bool = False) -> list:
    """Play a training ``order`` over every data replica.

    ``chunk_fns[d][c](x) -> logits-or-activation`` with autograd on
    (chunk ``c`` on the slot ``order`` issues it on, data replica ``d``;
    a chunk may also enqueue work on that cell's other model slots);
    ``xs[m][d]`` the input rows on the replica's first slot;
    ``labels[m][d]`` and ``masks[m][d]`` (pre-scaled) on its last
    chunk's slot, where ``tail(y, labels, masks)`` gives a microbatch's
    share of the loss (default: the masked CE). Weight gradients are
    summed into the chunks' leaves' ``.grad``.

    Split ops (BWD_B, BWD_W) take ``weights[d][c]``, the leaves chunk
    ``c``'s W differentiates (the recompute split), or ``split``, the
    cotangent-stash split (then every FWD runs without a graph and
    ``split.backward_b(d, c, x, dy, labels, masks) -> (dx, loss,
    parked)`` and ``split.backward_w(d, c, parked)`` do the backward;
    see the module docstring).

    On a mesh with seq slots every activation, cotangent, label and mask
    is the tuple of its seq shards (the chunks and the tail take and
    give tuples; :func:`~tpu_dist_nn_torch.parallel.gpipe.launch`), and
    so on a mesh with expert slots the tuple of its expert shards.

    ``with_aux``: every chunk gives ``(y, aux)`` (the module docstring's
    aux channel; not with ``split``).

    Returns ``[(loss, event)]``, one per (microbatch, replica) (with
    ``with_aux`` one per backward op: the chunk's aux, plus the tail's
    loss at the last chunk): each a detached scalar with the event
    after it. Before the first op every
    slot stream waits for its card's current stream (the inputs' copies
    and the last optimizer update); after the last, every card's current
    stream waits for its slots, so the caller may read ``.grad`` there.
    """
    S, D = mesh.spec.stage, mesh.spec.data
    V = len(chunk_fns[0])
    slots = mesh.all_slots
    for slot in slots:
        if slot.stream is not None:
            slot.stream.wait_stream(torch.cuda.current_stream(slot.device))
    acts = {(-1, m, d): (x, None) for m, row in enumerate(xs) for d, x in enumerate(row)}
    stash, parked, grads, losses = {}, {}, {}, []
    for s, op, c, m in order:
        for d in range(D):
            slot, key = mesh.cell(s, d), (c, m, d)
            if op == FWD:
                def fwd(x, fn=chunk_fns[d][c], c=c):
                    if split is not None:
                        with torch.no_grad():
                            return x, fn(x)
                    x_in = _detached(x, c > 0)
                    return x_in, fn(x_in)

                (x_in, y), ev = launch(slot, fwd, *acts.pop((c - 1, m, d)))
                aux = None
                if with_aux:
                    y, aux = y
                stash[key] = (x_in, y, aux)
                if c < V - 1:
                    acts[key] = (_detached(y), ev)
                continue
            if op == BWD_W:
                def bwd_w(_, d=d, c=c, held=parked.pop(key)):
                    if split is not None:
                        split.backward_w(d, c, held)
                    else:
                        torch.autograd.backward(*held, inputs=weights[d][c])

                launch(slot, bwd_w, None)
                continue
            x_in, y, aux = stash.pop(key)
            last = c == V - 1
            dy, ready = (None, None) if last else grads.pop((c + 1, m, d))

            def bwd(dy, c=c, d=d, m=m, x_in=x_in, y=y, aux=aux, last=last, combined=op == BWD):
                """-> (dx, loss, what W needs)."""
                lab = msk = None
                if last:
                    lab, msk = _use_here(labels[m][d]), _use_here(masks[m][d])
                if split is not None:
                    return split.backward_b(d, c, x_in, dy, lab, msk)
                loss = tail(y, lab, msk) if last else None
                outs, dys = _backward_pair(y if loss is None else loss, dy, aux)
                if combined:
                    if any(t.requires_grad for t in outs):
                        torch.autograd.backward(outs, dys)
                elif c > 0:
                    torch.autograd.backward(outs, dys, inputs=list(x_in) if isinstance(
                        x_in, tuple) else [x_in], retain_graph=True)
                value = None if loss is None else loss.detach()
                if aux is not None:
                    value = aux.detach() if value is None else value + aux.detach()
                return _grad_of(x_in), value, (outs, dys)

            (dx, loss, held), ev = launch(slot, bwd, dy, ready)
            if op != BWD:
                parked[key] = held
            if loss is not None:
                losses.append((loss, ev))
            if c > 0:
                grads[key] = (dx, ev)
    for slot in slots:
        if slot.stream is not None:
            torch.cuda.current_stream(slot.device).wait_stream(slot.stream)
    return losses
