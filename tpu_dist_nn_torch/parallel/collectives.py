"""Collectives over the model slots and the seq slots of one ``(stage, data)`` cell,
and over the data slots.

The port's counterpart of ``shard_map``'s ``psum`` and ``all_gather``
over the JAX mesh's ``model`` axis, of the ring hop (``ppermute``)
and ``all_to_all`` over its ``seq`` axis, and of the reduce-scatter and
all-gather that XLA's partitioner inserts over its ``data`` axis for a
sharded optimizer state (:mod:`~tpu_dist_nn_torch.parallel.zero`). One process drives every slot
(:mod:`~tpu_dist_nn_torch.parallel.mesh`): a cell's model slots each
run their shard's work on their own stream, and the cell's lead slot
(model shard 0) holds the replicated values.

* :func:`fan_out` hands a value from the lead's stream to every model
  slot (the stream waits for the lead; another card gets a peer copy).
* :func:`psum` sums the shards' partials on the lead's stream in a fixed
  order (shard 0 + shard 1 + ...) after waiting for each shard's stream.
  Every model slot then reads the same bits, as a JAX ``psum`` output is
  replicated by construction, and a repeat gives the same bits. The sum
  and the hand-offs are plain autograd ops, so the backward is the
  Megatron conjugate for free: the gradient of a sum is the same
  cotangent to each partial, and the gradients of a fanned-out value add
  up on the lead.
* :func:`all_gather` concatenates the shards' columns on the lead in
  shard order (the FCNN column split).
* :func:`rotate` is one ring hop over seq slots: slot ``q`` receives seq
  slot ``q - 1``'s block after waiting for that slot's stream (the same
  tensor on one card, a peer copy on another).
* :func:`all_to_all` splits each seq shard's tensor along one dim and
  hands piece ``j`` to seq slot ``j``, which concatenates the pieces it
  receives along another dim in shard order.

* :func:`reduce_scatter` sums ``N`` data slots' full partials slice by
  slice: slot ``j`` receives slice ``j`` (along one dim) of every partial
  and adds them in shard order 0, 1, ..., N-1 on its own stream, so a
  repeat gives the same bits.
* :func:`gather_slices` concatenates a leaf's ``N`` slices along its
  sharded dim on one data slot (a peer copy from another card).

Both data collectives are autograd ops too: the gradient of a
reduce-scatter is the gather of its slices' cotangents, and the gradient
of a gather, summed over the slots that gathered, is the reduce-scatter
(autograd adds those cotangents in its own order; the ZeRO steps take
each slot's gradients and call :func:`reduce_scatter` themselves, for
the fixed order).

Both seq collectives are autograd ops built from views, hand-offs and
``torch.cat``: their backward is the reverse hop and the inverse
exchange, run by autograd on the streams the forward used. A block over
several slots starts with :func:`fork` (every slot waits for the
caller's stream) and ends with :func:`join` (the caller waits for every
slot), so a remat recompute, issued from a backward stream, finds its
inputs ready and hands its outputs back.

Streams: autograd runs each backward op on its forward op's stream and
synchronises a gradient that crosses streams; a tensor that one stream
made and another reads is ``record_stream``-ed on the reader
(:func:`~tpu_dist_nn_torch.parallel.gpipe._receive`), or the caching
allocator could reuse its block early. On CPU slots (no streams) every
op runs in program order.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch

from tpu_dist_nn_torch.parallel.gpipe import _receive
from tpu_dist_nn_torch.parallel.mesh import StageSlot


def on_slot(slot: StageSlot):
    """A context that runs work on ``slot``'s stream (a no-op on the CPU)."""
    return contextlib.nullcontext() if slot.stream is None else torch.cuda.stream(slot.stream)


def fan_out(x: torch.Tensor, slots: Sequence[StageSlot]) -> list[torch.Tensor]:
    """``x``, valid on the lead's stream (``slots[0]``, the current
    stream), made usable on every model slot: ``[x_0, x_1, ...]``."""
    lead = slots[0]
    out = [x]
    for slot in slots[1:]:
        if slot.stream is None:
            out.append(x.to(slot.device))
            continue
        slot.stream.wait_stream(lead.stream)
        with torch.cuda.stream(slot.stream):
            out.append(_receive(slot, x))
    return out


def hand_off(dst: StageSlot, src: StageSlot, x: torch.Tensor) -> torch.Tensor:
    """``x`` (made on ``src``'s stream) usable on ``dst``'s stream, which
    is current."""
    if dst.stream is None:
        return x.to(dst.device)
    if src is not dst:
        dst.stream.wait_stream(src.stream)
    return _receive(dst, x)


def psum(parts: Sequence[torch.Tensor], slots: Sequence[StageSlot]) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` in that order on the lead's stream
    (``slots[0]``, current); ``parts[m]`` was made on ``slots[m]``'s."""
    lead = slots[0]
    total = parts[0]
    for slot, part in zip(slots[1:], parts[1:]):
        total = total + hand_off(lead, slot, part)
    return total


def all_gather(parts: Sequence[torch.Tensor], slots: Sequence[StageSlot],
               dim: int = -1) -> torch.Tensor:
    """The shards' ``parts`` concatenated along ``dim`` in shard order on
    the lead's stream (``slots[0]``, current)."""
    lead = slots[0]
    return torch.cat([parts[0]] + [hand_off(lead, slot, part)
                                   for slot, part in zip(slots[1:], parts[1:])], dim=dim)


def fork(slots: Sequence[StageSlot]):
    """Every CUDA slot waits for the current stream of its card; returns
    that stream (None on the CPU), for :func:`join`."""
    if slots[0].stream is None:
        return None
    caller = torch.cuda.current_stream(slots[0].device)
    for slot in slots:
        slot.stream.wait_stream(caller)
    return caller


def join(caller, slots: Sequence[StageSlot]) -> None:
    """The stream :func:`fork` returned waits for every slot."""
    if caller is not None:
        for slot in slots:
            caller.wait_stream(slot.stream)


def rotate(xs: Sequence[torch.Tensor], slots: Sequence[StageSlot]) -> list[torch.Tensor]:
    """One ring hop: ``xs[q]`` lives on seq slot ``q``; returns ``ys``
    with ``ys[q] = xs[q - 1]`` usable on slot ``q``'s stream."""
    n = len(slots)
    out = []
    for q, slot in enumerate(slots):
        with on_slot(slot):
            out.append(hand_off(slot, slots[(q - 1) % n], xs[(q - 1) % n]))
    return out


def all_to_all(xs: Sequence[torch.Tensor], slots: Sequence[StageSlot], split_dim: int,
               concat_dim: int) -> list[torch.Tensor]:
    """``shard_map``'s tiled ``all_to_all`` over seq slots: ``xs[i]`` (on
    slot ``i``) splits into ``len(slots)`` equal pieces along
    ``split_dim``; slot ``j`` receives piece ``j`` of every shard and
    concatenates them along ``concat_dim`` in shard order."""
    n = len(slots)
    pieces = [x.chunk(n, dim=split_dim) for x in xs]
    out = []
    for j, slot in enumerate(slots):
        with on_slot(slot):
            out.append(torch.cat([hand_off(slot, src, pieces[i][j])
                                  for i, src in enumerate(slots)], dim=concat_dim))
    return out


def _current_waits(slot: StageSlot) -> None:
    """``slot``'s stream waits for the current stream of its card (a
    value made there, e.g. a gradient autograd handed back, is then
    valid on the slot)."""
    if slot.stream is not None:
        slot.stream.wait_stream(torch.cuda.current_stream(slot.device))


def take(slot: StageSlot, x: torch.Tensor) -> torch.Tensor:
    """``x``, already valid on ``slot``'s stream (current), usable there."""
    return x.to(slot.device) if slot.stream is None else _receive(slot, x)


def reduce_scatter(parts: Sequence[torch.Tensor], slots: Sequence[StageSlot],
                   dim: int) -> list[torch.Tensor]:
    """``parts[d]``: data slot ``d``'s full partial, valid on its card's
    current stream. Returns ``out[j] = sum_d parts[d].narrow(dim, j *
    s, s)`` (``s = size / N``), summed in shard order on slot ``j``'s
    stream, where it is valid."""
    n = len(slots)
    size = parts[0].shape[dim] // n
    out = []
    for j, slot in enumerate(slots):
        _current_waits(slot)
        with on_slot(slot):
            total = None
            for part in parts:
                piece = take(slot, part.narrow(dim, j * size, size))
                total = piece if total is None else total + piece
            out.append(total)
    return out


def gather_slices(parts: Sequence[torch.Tensor], slot: StageSlot, dim: int) -> torch.Tensor:
    """A leaf's slices ``parts`` (shard order, each valid on ``slot``'s
    stream: after a :func:`fork` that followed their update) concatenated
    along ``dim`` on ``slot``, whose stream is current."""
    return torch.cat([take(slot, p) for p in parts], dim=dim)
