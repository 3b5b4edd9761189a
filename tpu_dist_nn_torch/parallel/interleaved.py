"""Interleaved (virtual-stage) schedules over stage slots, dense chains.

Port of the dense half of :mod:`tpu_dist_nn.parallel.interleaved`
(``make_interleaved_forward``, ``make_interleaved_1f1b``). Slot ``s``
holds ``v`` chunks of a ``V = S*v``-chunk pipeline, chunk ``c`` on slot
``c % S`` (:func:`~tpu_dist_nn_torch.parallel.pipeline.regroup_chunks`'
placement). The tables of
:mod:`~tpu_dist_nn_torch.parallel.schedule_table` fix each slot's op
order; this module plays that order back, issuing every op on its
slot's stream. The JAX executor moves activations through ring buffers
whose slots the tables allocate; here an activation is a tensor keyed by
(chunk, microbatch) and handed over with an event (:func:`gpipe.launch`),
so the buffer columns of the tables are not read.
"""

from __future__ import annotations

from tpu_dist_nn_torch.parallel.gpipe import launch
from tpu_dist_nn_torch.parallel.mesh import Mesh
from tpu_dist_nn_torch.parallel.schedule_table import (
    BWD,
    FWD,
    build_interleaved_1f1b,
    build_interleaved_forward,
)


def interleaved_forward(mesh: Mesh, chunk_fns, num_virtual: int, xs, ready=None) -> list[list]:
    """Forward-only playback of :func:`build_interleaved_forward`.

    ``chunk_fns[d][c]``: chunk ``c``'s function on replica ``d`` (on
    slot ``(c % S, d)``); ``xs[m][d]``: microbatch rows (None =
    skipped). Returns ``outs[m][d] = (tensor, event)`` of the last
    chunk."""
    S, D, M = mesh.spec.stage, mesh.spec.data, len(xs)
    V = S * num_virtual
    tables = build_interleaved_forward(S, num_virtual, M)
    act = {(-1, m, d): (x, ready) for m, row in enumerate(xs) for d, x in enumerate(row)
           if x is not None}
    for _t, s, _op, c, m in tables.op_order():
        for d in range(D):
            src = act.pop((c - 1, m, d), None)
            if src is not None:
                act[(c, m, d)] = launch(mesh.slots[s][d], chunk_fns[d][c], *src)
    return [[act.get((V - 1, m, d)) for d in range(D)] for m in range(M)]


def interleaved_1f1b_order(num_stages: int, num_virtual: int, num_microbatches: int):
    """The training op order of :func:`build_interleaved_1f1b`: a list
    of ``(slot, op, chunk, microbatch)`` with ``op`` FWD or BWD."""
    tables = build_interleaved_1f1b(num_stages, num_virtual, num_microbatches)
    return [(s, op, c, m) for _t, s, op, c, m in tables.op_order() if op in (FWD, BWD)]
