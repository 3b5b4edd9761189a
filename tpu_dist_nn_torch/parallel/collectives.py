"""Collectives over the model slots of one ``(stage, data)`` cell.

The port's counterpart of ``shard_map``'s ``psum`` and ``all_gather``
over the JAX mesh's ``model`` axis. One process drives every slot
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


def _to_lead(lead: StageSlot, slot: StageSlot, part: torch.Tensor) -> torch.Tensor:
    """A shard's ``part`` (made on ``slot``'s stream) usable on the
    lead's stream, which is current."""
    if lead.stream is None:
        return part.to(lead.device)
    if slot is not lead:
        lead.stream.wait_stream(slot.stream)
    return _receive(lead, part)


def psum(parts: Sequence[torch.Tensor], slots: Sequence[StageSlot]) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` in that order on the lead's stream
    (``slots[0]``, current); ``parts[m]`` was made on ``slots[m]``'s."""
    lead = slots[0]
    total = parts[0]
    for slot, part in zip(slots[1:], parts[1:]):
        total = total + _to_lead(lead, slot, part)
    return total


def all_gather(parts: Sequence[torch.Tensor], slots: Sequence[StageSlot],
               dim: int = -1) -> torch.Tensor:
    """The shards' ``parts`` concatenated along ``dim`` in shard order on
    the lead's stream (``slots[0]``, current)."""
    lead = slots[0]
    return torch.cat([parts[0]] + [_to_lead(lead, slot, part)
                                   for slot, part in zip(slots[1:], parts[1:])], dim=dim)
