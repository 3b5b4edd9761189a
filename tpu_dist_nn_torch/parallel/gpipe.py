"""GPipe forward schedule over stage slots, and the stream hand-off.

Port of :mod:`tpu_dist_nn.parallel.gpipe`. The JAX schedule is one
``shard_map`` program: microbatch ``m`` enters stage 0 at step ``m`` and
leaves stage ``S-1`` at step ``m + S - 1`` (``T = M + S - 1`` steps),
with a ``lax.ppermute`` hop a step. Here one process issues the same
steps over the slots of a :class:`~tpu_dist_nn_torch.parallel.mesh.Mesh`:
each (stage, microbatch) op runs on its slot's CUDA stream after a
``wait_event`` on its producer's event, so the host never waits inside
the schedule; the caller's one sync comes after :func:`gather`.

:func:`launch` is the hand-off every schedule shares (GPipe, 1F1B and
the interleaved tables). A tensor that one stream allocated and another
stream reads is ``record_stream``-ed on the reader, or the caching
allocator could hand its block to the producer's next microbatch before
the reader is done. A tensor on another card is copied peer to peer:
the copy runs on the source card's current stream after that stream has
waited for the producer (see ``_receive``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from tpu_dist_nn_torch.parallel.mesh import Mesh, StageSlot


def _receive(slot: StageSlot, x: torch.Tensor) -> torch.Tensor:
    """``x`` made usable on ``slot.stream`` (the current stream), which
    has already waited for ``x``'s producer."""
    if x.device == slot.device:
        x.record_stream(slot.stream)
        return x
    # A peer copy runs on the source card's current stream, which first
    # waits (inside the copy) on the destination's current stream: this
    # slot's, already past the producer's event. The source block is
    # read there, so it is recorded on that stream.
    x.record_stream(torch.cuda.current_stream(x.device))
    return x.to(slot.device, non_blocking=True)


def launch(slot: StageSlot, fn: Callable, x: torch.Tensor | None, ready=None):
    """Run ``fn(x)`` on ``slot`` after ``ready`` (the event that makes
    ``x`` valid; None when it already is). Returns ``(out, done)``:
    ``done`` is the event recorded after the op on the slot's stream
    (None on a CPU slot, where ops run in issue order)."""
    if slot.stream is None:
        return fn(x), None
    with torch.cuda.stream(slot.stream):
        if ready is not None:
            slot.stream.wait_event(ready)
        out = fn(None if x is None else _receive(slot, x))
        done = torch.cuda.Event()
        done.record(slot.stream)
    return out, done


def caller_event(x: torch.Tensor):
    """An event on the caller's current stream of ``x``'s card, after
    the work that produced ``x`` (None for a CPU tensor)."""
    if x.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(x.device))
    return ev


def gather(outs: Sequence, device: torch.device) -> list[torch.Tensor]:
    """Bring ``(tensor, event)`` results back onto the caller's current
    stream of ``device`` (copying from another card where needed). The
    caller's stream waits on each event; nothing waits on the host."""
    got = []
    for y, ev in outs:
        if ev is not None:
            src = torch.cuda.current_stream(y.device)
            src.wait_event(ev)
            y.record_stream(src)
        got.append(y.to(device, non_blocking=True))
    return got


def gpipe_forward(mesh: Mesh, stage_fns, xs, ready=None) -> list[list]:
    """The GPipe forward over every data replica of ``mesh``.

    ``stage_fns[d][s]``: stage ``s``'s function on replica ``d``;
    ``xs[m][d]``: microbatch ``m``'s rows for replica ``d`` (None = no
    rows: skipped); ``ready``: the event after which every ``xs`` is
    valid. Step ``t`` issues stage ``s`` on microbatch ``t - s``.
    Returns ``outs[m][d] = (tensor, event)`` from the last stage (None
    where skipped)."""
    S, D, M = mesh.spec.stage, mesh.spec.data, len(xs)
    cur = [[None if x is None else (x, ready) for x in row] for row in xs]
    for t in range(M + S - 1):
        for d in range(D):
            for s in range(S):
                m = t - s
                if 0 <= m < M and cur[m][d] is not None:
                    cur[m][d] = launch(mesh.slots[s][d], stage_fns[d][s], *cur[m][d])
    return cur
