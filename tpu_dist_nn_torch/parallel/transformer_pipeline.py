"""Per-block transformer pipeline over stage slots, with Megatron and sequence parallelism.

Port of :mod:`tpu_dist_nn.parallel.transformer_pipeline`. BASELINE configs[4]: "Tiny-Transformer
encoder ... per-block pipeline stage". The block stack's leading layer
axis is regrouped per stage (:func:`shard_blocks`), per virtual-stage
chunk (:func:`shard_blocks_interleaved`, also the zb and zb-stash
layout), per V-shape chunk (:func:`shard_blocks_vshape`, zb-v) or per
stage and model shard (:func:`shard_blocks_pp_tp`,
:func:`shard_blocks_interleaved_tp`, :func:`shard_blocks_vshape_tp`),
the JAX package's layouts.

A chunk (a stage's block group, or a virtual-stage chunk) runs on the
slot its schedule's tables place it on (``dev_of_chunk``: ``c % S`` on
the Megatron placement, the V on zb-v's), ``(slot, d)``; with tensor
parallelism it also enqueues its shards' work on the cell's other model
slots (:func:`~tpu_dist_nn_torch.parallel.tensor_parallel.tp_block_apply`).
The embedding rides the first chunk and the tied unembedding +
next-token CE the last one's tail. Forwards play the GPipe order
(:func:`~tpu_dist_nn_torch.parallel.gpipe.gpipe_forward`); the
loss-and-grad executors play a training order through
:func:`~tpu_dist_nn_torch.parallel.one_f_one_b.run_schedule` (eager
autograd, op by op on each slot's stream; the zero-bubble schedules'
split backward as its module docstring says), where the JAX package
differentiates a ``shard_map``-ed scan.

Gradients: each chunk reads its leaves as separate autograd leaves (views
of the staged tensors, so nothing is copied and no other chunk's slice
receives a zero gradient); data replicas share them, so their
contributions add up, and the loss is the per-microbatch mean CE over
``M * data``, which makes the sum the global mean. Grads come back in the
params' layout.

Sequence parallelism (the ``*_sp_*`` and ``*_tp_sp_*`` functions) keeps
the dense and Megatron layouts: each microbatch's sequence is split over
the cell's seq slots, a chunk takes and gives the tuple of its seq shards
(:func:`_sp_chunk_fn`: the embedding at global positions, then ring or
Ulysses blocks), and a stage hand-off moves each shard to the same seq
slot of the next stage. The tokens are full (input + target) rows: the
tail of each (microbatch, seq shard) scores pre-shifted targets under a
mask normalised by ``B * (T - 1)`` (:func:`_sp_prep`), so the shards'
partial sums add up to
:func:`~tpu_dist_nn_torch.models.transformer.masked_next_token_ce`, and a
seq shard's gradients add into the shared leaves as a data replica's do
(in another order than the JAX package's ``psum``: equal within
rounding, not bit for bit).
"""

from __future__ import annotations

import torch

from tpu_dist_nn_torch.kernels.flash_attention import default_attn_fn
from tpu_dist_nn_torch.models.transformer import (
    embed,
    masked_next_token_ce,
    maybe_remat,
    next_token_ce,
    tree_map,
    unembed,
    unstack_blocks,
)
from tpu_dist_nn_torch.parallel import split_backward
from tpu_dist_nn_torch.parallel.collectives import on_slot
from tpu_dist_nn_torch.parallel.gpipe import caller_event, gather, gpipe_forward
from tpu_dist_nn_torch.parallel.interleaved import table_order
from tpu_dist_nn_torch.parallel.mesh import AXIS_DATA, AXIS_MODEL, AXIS_SEQ, AXIS_STAGE, Mesh
from tpu_dist_nn_torch.parallel.one_f_one_b import (
    _use_here,
    run_schedule,
    schedule_tables,
    training_order,
)
from tpu_dist_nn_torch.parallel.ring_attention import (
    _sp_attn_fn,
    check_sp_rows,
    embed_at,
    sp_scan,
)
from tpu_dist_nn_torch.parallel.schedule_table import build_zb_v, build_zero_bubble
from tpu_dist_nn_torch.parallel.tensor_parallel import (
    TP_REPLICATED,
    tp_scan,
    tp_shard_blocks,
    tp_sp_scan,
    tp_unshard_blocks,
)

_TOP = ("tok_embed", "pos_embed", "lnf_g", "lnf_b")


def shard_blocks(blocks: dict, num_stages: int) -> dict:
    """Regroup stacked block leaves ``(L, ...) -> (S, L/S, ...)``."""
    L = blocks["w_qkv"].shape[0]
    if L % num_stages:
        raise ValueError(f"n_layers={L} not divisible by num_stages={num_stages}")
    return tree_map(lambda a: a.reshape(num_stages, L // num_stages, *a.shape[1:]), blocks)


def unshard_blocks(staged: dict) -> dict:
    """Inverse of :func:`shard_blocks`: ``(S, L/S, ...) -> (L, ...)``."""
    return tree_map(lambda a: a.reshape(-1, *a.shape[2:]), staged)


def _chunk_regroup(a, num_stages: int, num_virtual: int):
    """``(L, ...) -> (S, v, L/V, ...)``: global chunk ``c`` (blocks
    ``[c*L/V, (c+1)*L/V)``) to stage ``c % S``, local slot ``c // S``."""
    S, v = num_stages, num_virtual
    L = a.shape[0]
    chunks = a.reshape(S * v, L // (S * v), *a.shape[1:])
    return chunks.reshape(v, S, L // (S * v), *a.shape[1:]).transpose(0, 1)


def _chunk_ungroup(a):
    """Inverse of :func:`_chunk_regroup`: ``(S, v, Lc, ...) -> (L, ...)``."""
    return a.transpose(0, 1).reshape(-1, *a.shape[3:])


def shard_blocks_interleaved(blocks: dict, num_stages: int, num_virtual: int) -> dict:
    """Stacked blocks ``(L, ...)`` -> the interleaved chunk layout
    ``(S, v, L/V, ...)``."""
    V = num_stages * num_virtual
    L = blocks["w_qkv"].shape[0]
    if L % V:
        raise ValueError(f"n_layers={L} not divisible by S*v={V}")
    return tree_map(lambda a: _chunk_regroup(a, num_stages, num_virtual), blocks)


def unshard_blocks_interleaved(staged: dict) -> dict:
    """Inverse of :func:`shard_blocks_interleaved`."""
    return tree_map(_chunk_ungroup, staged)


def shard_blocks_pp_tp(blocks: dict, cfg, num_stages: int, n_tp: int) -> dict:
    """Stacked blocks ``(L, ...)`` -> the pipeline + Megatron layout:
    sharded leaves ``(S, N, L/S, ...)``, replicated leaves ``(S, L/S, ...)``."""
    L = blocks["w_qkv"].shape[0]
    if L % num_stages:
        raise ValueError(f"n_layers={L} not divisible by num_stages={num_stages}")
    out = {}
    for k, v in tp_shard_blocks(blocks, cfg, n_tp).items():
        if k in TP_REPLICATED:
            out[k] = v.reshape(num_stages, L // num_stages, *v.shape[1:])
        else:
            out[k] = v.reshape(n_tp, num_stages, L // num_stages, *v.shape[2:]).transpose(0, 1)
    return out


def unshard_blocks_pp_tp(staged: dict, cfg) -> dict:
    """Inverse of :func:`shard_blocks_pp_tp`."""
    tp = {}
    for k, v in staged.items():
        if k in TP_REPLICATED:
            tp[k] = v.reshape(-1, *v.shape[2:])
        else:
            r = v.transpose(0, 1)
            tp[k] = r.reshape(r.shape[0], -1, *r.shape[3:])
    return tp_unshard_blocks(tp, cfg)


def shard_blocks_interleaved_tp(blocks: dict, cfg, num_stages: int, num_virtual: int,
                                n_tp: int) -> dict:
    """Stacked blocks ``(L, ...)`` -> the interleaved chunk layout with the
    Megatron split: sharded leaves ``(S, v, N, L/V, ...)``, replicated
    leaves ``(S, v, L/V, ...)``."""
    S, v = num_stages, num_virtual
    L = blocks["w_qkv"].shape[0]
    if L % (S * v):
        raise ValueError(f"n_layers={L} not divisible by S*v={S * v}")
    out = {}
    for k, val in tp_shard_blocks(blocks, cfg, n_tp).items():
        if k in TP_REPLICATED:
            out[k] = _chunk_regroup(val, S, v)
        else:  # (N, L, ...) -> (N, S, v, L/V, ...) -> (S, v, N, L/V, ...)
            out[k] = torch.movedim(torch.stack([_chunk_regroup(a, S, v) for a in val]), 0, 2)
    return out


def unshard_blocks_interleaved_tp(staged: dict, cfg) -> dict:
    """Inverse of :func:`shard_blocks_interleaved_tp`."""
    tp = {}
    for k, val in staged.items():
        if k in TP_REPLICATED:
            tp[k] = _chunk_ungroup(val)
        else:  # (S, v, N, Lc, ...) -> (N, L, ...)
            tp[k] = torch.stack([_chunk_ungroup(a) for a in torch.movedim(val, 2, 0)])
    return tp_unshard_blocks(tp, cfg)


def _vshape_regroup(a, num_stages: int):
    """``(L, ...) -> (S, 2, L/(2S), ...)``: the V-shape placement, slot
    ``s`` holding chunk ``s`` (local chunk 0, the descending leg) and
    chunk ``2S-1-s`` (local chunk 1, the ascending leg)."""
    S = num_stages
    L = a.shape[0]
    if L % (2 * S):
        raise ValueError(f"n_layers={L} not divisible by 2*stages={2 * S}")
    ch = a.reshape(2 * S, L // (2 * S), *a.shape[1:])
    return torch.stack([ch[:S], ch[S:].flip(0)], dim=1)


def _vshape_ungroup(a):
    """Inverse of :func:`_vshape_regroup`."""
    return torch.cat([a[:, 0], a[:, 1].flip(0)]).reshape(-1, *a.shape[3:])


def shard_blocks_vshape(blocks: dict, num_stages: int) -> dict:
    """Stacked blocks ``(L, ...)`` -> the zb-v layout ``(S, 2, L/(2S),
    ...)``: the forward runs down the slots and back up, so the input
    feed (chunk 0) and the loss tail (chunk ``2S-1``) share slot 0
    (:func:`~tpu_dist_nn_torch.parallel.schedule_table.build_zb_v`)."""
    return tree_map(lambda a: _vshape_regroup(a, num_stages), blocks)


def unshard_blocks_vshape(staged: dict) -> dict:
    """Inverse of :func:`shard_blocks_vshape`."""
    return tree_map(_vshape_ungroup, staged)


def shard_blocks_vshape_tp(blocks: dict, cfg, num_stages: int, n_tp: int) -> dict:
    """The V-shape chunk layout with the Megatron split: sharded leaves
    ``(S, 2, N, L/(2S), ...)``, replicated leaves ``(S, 2, L/(2S),
    ...)``."""
    out = {}
    for k, val in tp_shard_blocks(blocks, cfg, n_tp).items():
        if k in TP_REPLICATED:
            out[k] = _vshape_regroup(val, num_stages)
        else:  # (N, L, ...) -> (N, S, 2, Lc, ...) -> (S, 2, N, Lc, ...)
            out[k] = torch.movedim(torch.stack([_vshape_regroup(a, num_stages) for a in val]),
                                   0, 2)
    return out


def unshard_blocks_vshape_tp(staged: dict, cfg) -> dict:
    """Inverse of :func:`shard_blocks_vshape_tp`."""
    tp = {}
    for k, val in staged.items():
        if k in TP_REPLICATED:
            tp[k] = _vshape_ungroup(val)
        else:  # (S, 2, N, Lc, ...) -> (N, L, ...)
            tp[k] = torch.stack([_vshape_ungroup(a) for a in torch.movedim(val, 2, 0)])
    return tp_unshard_blocks(tp, cfg)


# ---------------------------------------------------------------------------
# Chunks over slots
# ---------------------------------------------------------------------------


class _Layout:
    """Where chunk ``c``'s model shard ``m`` sits in a staged block dict:
    chunked layouts (interleaved, zb, zb-v) lead with ``(S, v)``, at
    ``(dev(c), c // S)``, the others with ``S``; ``tp`` layouts put a
    model axis after those on the sharded leaves."""

    def __init__(self, num_stages: int, num_virtual: int, interleaved: bool, n_tp: int,
                 dev=None):
        self.S, self.v, self.interleaved, self.n = num_stages, num_virtual, interleaved, n_tp
        self.tp = n_tp > 0
        self.dev = dev or (lambda c: c % num_stages)

    @property
    def num_chunks(self) -> int:
        return self.S * self.v

    def index(self, key: str, c: int, m: int) -> tuple:
        idx = (self.dev(c), c // self.S) if self.interleaved else (c,)
        if self.tp and key not in TP_REPLICATED:
            idx += (m,)
        return idx

    def shards(self) -> int:
        return max(self.n, 1)


def _chunk_views(blocks: dict, layout: _Layout, leaf):
    """``views[c][m]``: chunk ``c``'s stacked leaves for shard ``m``,
    each through ``leaf(key, index)`` (a view, or a detached leaf)."""
    return [[{k: leaf(k, layout.index(k, c, m)) for k in blocks}
             for m in range(layout.shards())] for c in range(layout.num_chunks)]


def _chunk_fn(cfg, shards, cell, attn_fn, tp: bool, top=None):
    """Chunk body over a cell's model slots: the embedding when ``top``
    (the first chunk; its input is token ids), then the block group,
    dense (:func:`models.transformer.block_apply`, bit for bit the single
    program's) or Megatron-sharded."""

    def fn(x):
        # Each shard's leaves cast on its own slot's stream (after the
        # lead's: the caller's last update), where they are read: a
        # tensor one stream allocates and another reads could be reused
        # early by the caching allocator.
        here = []
        for slot, sh in zip(cell, shards):
            if slot is not cell[0] and slot.stream is not None:
                slot.stream.wait_stream(cell[0].stream)
            with on_slot(slot):
                here.append(cfg.cast_params({k: a.to(slot.device) for k, a in sh.items()}))
        if top is not None:
            x = embed(cfg.cast_params({k: top[k].to(cell[0].device)
                                       for k in ("tok_embed", "pos_embed")}), x)
        if tp:
            return tp_scan(here, x, cfg, cell, attn_fn)
        apply = maybe_remat(cfg)
        for block in unstack_blocks(here[0]):
            x = apply(block, x, cfg, attn_fn)
        return x

    return fn


def _sp_chunk_fn(cfg, shards, seq_cells, sp_attn, tp: bool, top=None):
    """Chunk body over a cell's seq shards: ``seq_cells[q]`` the model
    slots of seq shard ``q``, the input the tuple of its shards (token
    ids when ``top``, embedded at their global positions). Each slot
    casts its own leaves on its stream; the blocks run dense
    (:func:`~tpu_dist_nn_torch.parallel.ring_attention.sp_scan`) or
    Megatron-sharded (:func:`~tpu_dist_nn_torch.parallel.tensor_parallel.
    tp_sp_scan`). Returns the tuple of the output shards."""

    def fn(xs):
        lead = seq_cells[0][0]
        here = []
        for cell in seq_cells:
            row = []
            for slot, sh in zip(cell, shards):
                if slot is not lead and slot.stream is not None:
                    slot.stream.wait_stream(lead.stream)
                with on_slot(slot):
                    row.append(cfg.cast_params({k: a.to(slot.device) for k, a in sh.items()}))
            here.append(row)
        if top is not None:
            Tl, emb = xs[0].shape[-1], []
            for q, (cell, x) in enumerate(zip(seq_cells, xs)):
                with on_slot(cell[0]):
                    emb.append(embed_at(cfg.cast_params(
                        {k: top[k].to(cell[0].device) for k in ("tok_embed", "pos_embed")}),
                        x, q * Tl))
            xs = tuple(emb)
        if tp:
            return tp_sp_scan(here, xs, cfg, seq_cells, sp_attn)
        return sp_scan([row[0] for row in here], xs, cfg, [cell[0] for cell in seq_cells],
                       sp_attn)

    return fn


def _resolve_attn(attn_fn):
    return attn_fn or default_attn_fn()


def _seq_shards(rows, Q: int) -> tuple:
    return tuple(rows.chunk(Q, dim=1))


def _check_sp(cfg, mesh: Mesh, tp: bool, mode: str) -> None:
    """The ulysses head split under tensor parallelism (JAX raises it
    inside ``ulysses_attention`` at trace time)."""
    Q = mesh.shape[AXIS_SEQ]
    if tp and mode == "ulysses":
        N = mesh.shape[AXIS_MODEL]
        if (cfg.n_heads // N) % Q:
            raise ValueError(
                f"ulysses needs n_heads / model ({cfg.n_heads} / {N} = {cfg.n_heads // N} "
                f"local heads) divisible by the seq axis ({Q})")


def _microbatches(rows, M: int, D: int):
    """``rows (B, ...)`` -> ``[m][d]``: microbatch ``m``, data shard ``d``
    (the JAX layout: ``(M, B/M)`` then the rows of a microbatch over
    ``data``)."""
    B = rows.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    if (B // M) % D:
        raise ValueError(f"microbatch {B // M} not divisible by data axis {D}")
    return [list(mb.chunk(D, dim=0)) for mb in rows.chunk(M, dim=0)]


def _tp_size(mesh: Mesh, tp: bool) -> int:
    return mesh.shape[AXIS_MODEL] if tp else 0


def _pipeline_logits(mesh: Mesh, cfg, num_stages: int, num_microbatches: int, attn_fn, tp: bool):
    _check_stages(mesh, num_stages)
    layout = _Layout(num_stages, 1, False, _tp_size(mesh, tp))
    D, M = mesh.shape[AXIS_DATA], num_microbatches

    def fn(params, tokens):
        attn = _resolve_attn(attn_fn)
        home = params["tok_embed"].device
        views = _chunk_views(params["blocks"], layout, lambda k, i: params["blocks"][k][i])
        fns = [[_chunk_fn(cfg, views[s], mesh.model_slots[s][d], attn, tp,
                          top=params if s == 0 else None)
                for s in range(num_stages)] for d in range(D)]
        xs = _microbatches(tokens, M, D)
        outs = gpipe_forward(mesh, fns, xs, caller_event(tokens))
        ys = torch.cat(gather([o for row in outs for o in row], home), dim=0)
        return unembed(cfg.cast_params({k: params[k] for k in _TOP}), ys)

    return fn


def _pipeline_sp_logits(mesh: Mesh, cfg, num_stages: int, num_microbatches: int, mode: str,
                        attn_fn, tp: bool):
    _check_stages(mesh, num_stages)
    _check_sp(cfg, mesh, tp, mode)
    layout = _Layout(num_stages, 1, False, _tp_size(mesh, tp))
    D, Q, M = mesh.shape[AXIS_DATA], mesh.shape[AXIS_SEQ], num_microbatches

    def fn(params, tokens):
        check_sp_rows(cfg, tokens.shape[1], Q, " (sp feeds full input+target rows: pick "
                      "seq_len so seq_len+1 divides)")
        sp_attn = _sp_attn_fn(mode, attn_fn=attn_fn)
        home = params["tok_embed"].device
        views = _chunk_views(params["blocks"], layout, lambda k, i: params["blocks"][k][i])
        fns = [[_sp_chunk_fn(cfg, views[s], mesh.seq_slots[s][d], sp_attn, tp,
                             top=params if s == 0 else None)
                for s in range(num_stages)] for d in range(D)]
        xs = [[_seq_shards(x, Q) for x in row] for row in _microbatches(tokens, M, D)]
        outs = gpipe_forward(mesh, fns, xs, caller_event(tokens))
        ys = torch.cat([torch.cat(gather([(y, ev) for y in shards], home), dim=1)
                        for row in outs for shards, ev in row], dim=0)
        return unembed(cfg.cast_params({k: params[k] for k in _TOP}), ys)

    return fn


def make_pipeline_lm_forward(mesh: Mesh, cfg, num_stages: int, num_microbatches: int,
                             attn_fn=None):
    """-> ``fn(params, tokens) -> logits`` with the blocks pipelined (GPipe).

    ``params["blocks"]`` regrouped by :func:`shard_blocks`; ``tokens (B,
    T)`` with ``B`` divisible by ``num_microbatches * data``. The logits
    come back on the params' device; autograd flows through it."""
    return _pipeline_logits(mesh, cfg, num_stages, num_microbatches, attn_fn, tp=False)


def make_pipeline_lm_loss(mesh: Mesh, cfg, num_stages: int, num_microbatches: int,
                          attn_fn=None):
    """-> ``loss_fn(params, tokens) -> scalar`` next-token CE through the
    pipeline (``tokens (B, T + 1)``)."""
    fwd = make_pipeline_lm_forward(mesh, cfg, num_stages, num_microbatches, attn_fn)
    return lambda params, tokens: next_token_ce(fwd(params, tokens[:, :-1]), tokens[:, 1:])


def make_pipeline_tp_lm_forward(mesh: Mesh, cfg, num_stages: int, num_microbatches: int,
                                attn_fn=None):
    """-> ``fn(params, tokens) -> logits``: blocks pipelined over ``stage``
    and Megatron-sharded over ``model`` (the batch over ``data``).
    ``params["blocks"]`` from :func:`shard_blocks_pp_tp`."""
    return _pipeline_logits(mesh, cfg, num_stages, num_microbatches, attn_fn, tp=True)


def make_pipeline_tp_lm_loss(mesh: Mesh, cfg, num_stages: int, num_microbatches: int,
                             attn_fn=None):
    """-> ``loss_fn(params, tokens) -> scalar`` CE through the PP x TP pipeline."""
    fwd = make_pipeline_tp_lm_forward(mesh, cfg, num_stages, num_microbatches, attn_fn)
    return lambda params, tokens: next_token_ce(fwd(params, tokens[:, :-1]), tokens[:, 1:])


class StashSplit:
    """The cotangent-stash split backward of the dense LM chunks
    (``zb-stash``), the ``split`` of
    :func:`~tpu_dist_nn_torch.parallel.one_f_one_b.run_schedule`: the JAX
    executor's ``split_fns`` (``interleaved.py:81-99``).

    ``backward_b`` runs the chunk forward once from the stashed input,
    keeping each sub-op's vjp (:func:`~tpu_dist_nn_torch.parallel.
    split_backward.chunk_forward_collect`; at chunk 0 the embedding
    first, with its graph), takes the tail's loss and its cotangent at
    the last chunk (the tail leaves' gradients and the loss are counted
    here, once), then the backward with the dW GEMMs left out: the bias
    and LayerNorm gradients go to the leaves, the (activation,
    cotangent) pairs are parked, and at chunk 0 the input cotangent
    flows on into the embedding. ``backward_w`` is the dW GEMMs of the
    parked pairs (:func:`~tpu_dist_nn_torch.parallel.split_backward.
    chunk_weight_grads`), nothing else. Gradients reach the float32
    leaves as autograd's backward through ``cfg.cast_params`` brings
    them: the compute-dtype result, cast, then summed into ``.grad``."""

    def __init__(self, cfg, views, top: dict, cells, attn_fn, tail):
        self.cfg, self.views, self.top, self.cells = cfg, views, top, cells
        self.attn_fn, self.tail = attn_fn, tail

    def _blocks(self, c: int, d: int) -> dict:
        dev = self.cells[c][d][0].device
        return self.cfg.cast_params({k: a.detach().to(dev) for k, a in self.views[c][0].items()})

    def backward_b(self, d: int, c: int, x, dy, labels, _mask):
        blocks = self._blocks(c, d)
        x0 = None
        if c == 0:
            with torch.enable_grad():
                x0 = embed(self.cfg.cast_params({k: self.top[k].to(x.device)
                                                  for k in ("tok_embed", "pos_embed")}), x)
            x = x0.detach()
        y, inners = split_backward.chunk_forward_collect(blocks, x, self.cfg, self.attn_fn)
        loss = None
        if dy is None:  # the last chunk: the tail's loss and its cotangent
            y = y.requires_grad_()
            with torch.enable_grad():
                loss = self.tail(y, labels, None)
            torch.autograd.backward(loss, inputs=[y, *(self.top[k] for k in _TAIL)])
            dy = y.grad
        dx, d_small, wstash = split_backward.chunk_backward_from(blocks, inners, dy)
        _accumulate(self.views[c][0], d_small)
        if x0 is not None:
            torch.autograd.backward(x0, dx)
        return dx, None if loss is None else loss.detach(), wstash

    def backward_w(self, d: int, c: int, wstash) -> None:
        _accumulate(self.views[c][0], split_backward.chunk_weight_grads(wstash))


def _accumulate(leaves: dict, grads: dict) -> None:
    """Sum compute-dtype ``grads`` into the leaves' float32 ``.grad``."""
    with torch.no_grad():
        for k, g in grads.items():
            leaf = leaves[k]
            g = g.to(leaf.dtype)
            if leaf.grad is None:
                leaf.grad = g
            else:
                leaf.grad += g


_TAIL = ("tok_embed", "lnf_g", "lnf_b")


def _scheduled_grad(mesh: Mesh, cfg, schedule: str, num_virtual: int, num_microbatches: int,
                    attn_fn, *, interleaved: bool, tp: bool, tables=None, sp_mode=None):
    """``f(params, tokens) -> (loss, grads)`` through ``run_schedule`` in
    ``schedule``'s op order (``tables`` in place of its default ones);
    ``tokens (B, T + 1)``, or with ``sp_mode`` (ring or ulysses over the
    mesh's seq slots) full rows ``(B, T)`` under the masked CE."""
    S, D, M = mesh.shape[AXIS_STAGE], mesh.shape[AXIS_DATA], num_microbatches
    Q = mesh.shape[AXIS_SEQ]
    if sp_mode is not None:
        _check_sp(cfg, mesh, tp, sp_mode)
    if tables is None:
        tables = schedule_tables(schedule, S, num_virtual, M)
    if tables is None:  # gpipe, 1f1b: chunk c on slot c
        order, layout = training_order(schedule, S, num_virtual, M), _Layout(
            S, num_virtual, interleaved, _tp_size(mesh, tp))
    else:
        order, layout = table_order(tables), _Layout(S, num_virtual, interleaved,
                                                     _tp_size(mesh, tp), tables.dev_of_chunk)
    V, dev = layout.num_chunks, layout.dev
    stash_split = schedule == "zb-stash"

    def value_and_grad(params, tokens):
        attn = _resolve_attn(attn_fn) if sp_mode is None else _sp_attn_fn(
            sp_mode, in_schedule=True, attn_fn=attn_fn)
        blocks = params["blocks"]
        leaves: dict = {}

        def leaf(k, idx):
            if (k, idx) not in leaves:
                leaves[(k, idx)] = blocks[k][idx].detach().requires_grad_()
            return leaves[(k, idx)]

        views = _chunk_views(blocks, layout, leaf)
        top = {k: params[k].detach().requires_grad_() for k in _TOP}
        cells = [[mesh.model_slots[dev(c)][d] for d in range(D)] for c in range(V)]
        if sp_mode is None:
            fns = [[_chunk_fn(cfg, views[c], cells[c][d], attn, tp, top=top if c == 0 else None)
                    for c in range(V)] for d in range(D)]
        else:
            fns = [[_sp_chunk_fn(cfg, views[c], mesh.seq_slots[dev(c)][d], attn, tp,
                                 top=top if c == 0 else None)
                    for c in range(V)] for d in range(D)]
        last = mesh.slots[dev(V - 1)]

        def tail(y, targets, _mask):
            head = cfg.cast_params({k: top[k].to(y.device) for k in _TAIL})
            return next_token_ce(unembed(head, y), targets) / (M * D)

        def sp_tail(ys, targets, masks):
            """The shards' masked sums, in shard order, on seq slot 0."""
            dev0 = targets[0].device
            head = cfg.cast_params({k: top[k].to(dev0) for k in _TAIL})
            total = None
            for y, tgt, mask in zip(ys, targets, masks):
                part = _sp_masked_tail(head, _on_device(y, dev0), tgt, mask)
                total = part if total is None else total + part
            return total

        def weights_of(c):
            """The leaves chunk ``c``'s W differentiates (the recompute
            split), each once: a replicated TP leaf is in every shard's view."""
            own = [t for shard in views[c] for t in shard.values()]
            own += [top[k] for k in ("tok_embed", "pos_embed")] if c == 0 else []
            own += [top[k] for k in _TAIL] if c == V - 1 else []
            return list({id(t): t for t in own}.values())

        weights = [weights_of(c) for c in range(V)]
        split = StashSplit(cfg, views, top, cells, attn, tail) if stash_split else None
        if sp_mode is None:
            xs = _microbatches(tokens[:, :-1], M, D)
            targets = [[t.to(last[d].device) for d, t in enumerate(row)]
                       for row in _microbatches(tokens[:, 1:], M, D)]
            masks = [[None] * D] * M
        else:
            tgt, mask = _sp_prep(cfg, tokens, Q)

            def sharded(rows):
                return [[tuple(t.to(last[d].device) for t in _seq_shards(r, Q))
                         for d, r in enumerate(row)] for row in _microbatches(rows, M, D)]

            xs = [[_seq_shards(r, Q) for r in row] for row in _microbatches(tokens, M, D)]
            targets, masks, tail = sharded(tgt), sharded(mask), sp_tail
        losses = run_schedule(mesh, fns, order, xs, targets, masks, tail=tail,
                              weights=[weights] * D, split=split)
        home = params["tok_embed"].device
        loss = torch.stack(gather(losses, home)).sum()
        g_blocks = {k: torch.zeros_like(v) for k, v in blocks.items()}
        with torch.no_grad():
            for (k, idx), t in leaves.items():
                if t.grad is not None:
                    g_blocks[k][idx].copy_(t.grad)
        grads = {k: (top[k].grad if top[k].grad is not None else torch.zeros_like(params[k]))
                 for k in _TOP}
        grads["blocks"] = g_blocks
        return loss, grads

    return value_and_grad


def _on_device(y, device):
    """A seq shard read by the tail on the current stream of ``device``
    (a peer copy from another card)."""
    if y.device == device:
        return _use_here(y)
    if y.is_cuda:
        y.record_stream(torch.cuda.current_stream(y.device))
    return y.to(device, non_blocking=True)


def _sp_masked_tail(head: dict, y, tgt, mask):
    """A (microbatch, seq shard)'s masked CE sum: ``mask`` carries the
    global ``1 / (B * (T - 1))``, so the shards' sums add up to
    :func:`~tpu_dist_nn_torch.models.transformer.masked_next_token_ce`."""
    logp = torch.log_softmax(unembed(head, y).float(), dim=-1)
    ll = logp.gather(-1, tgt.long()[..., None])[..., 0]
    return -(ll * mask).sum()


def _sp_prep(cfg, tokens, seq: int):
    """Full rows -> pre-shifted targets and the normalised mask: position
    ``p`` scores ``tokens[p + 1]``, the last position of a row none."""
    B, T = tokens.shape
    check_sp_rows(cfg, T, seq, " (sp feeds full input+target rows)", "")
    tgt = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    mask = torch.cat([torch.ones((B, T - 1), device=tokens.device),
                      torch.zeros((B, 1), device=tokens.device)], dim=1) / (B * (T - 1))
    return tgt, mask


def make_pipeline_lm_1f1b_grad(mesh: Mesh, cfg, num_stages: int, num_microbatches: int,
                               attn_fn=None):
    """-> ``f(params, tokens) -> (loss, grads)`` via the 1F1B schedule;
    ``params["blocks"]`` in :func:`shard_blocks` layout, grads in it too."""
    _check_stages(mesh, num_stages)
    return _scheduled_grad(mesh, cfg, "1f1b", 1, num_microbatches, attn_fn,
                           interleaved=False, tp=False)


def make_pipeline_lm_gpipe_grad(mesh: Mesh, cfg, num_stages: int, num_microbatches: int,
                                attn_fn=None):
    """-> ``f(params, tokens) -> (loss, grads)`` in the GPipe order (every
    forward, then every backward): the gradient of
    :func:`make_pipeline_lm_loss`, played op by op."""
    _check_stages(mesh, num_stages)
    return _scheduled_grad(mesh, cfg, "gpipe", 1, num_microbatches, attn_fn,
                           interleaved=False, tp=False)


def make_pipeline_lm_interleaved_grad(mesh: Mesh, cfg, num_virtual: int, num_microbatches: int,
                                      attn_fn=None, tables=None):
    """-> ``f(params, tokens) -> (loss, grads)`` via the interleaved
    (virtual-stage) 1F1B table, or ``tables`` in its place (the
    zero-bubble ones); ``params["blocks"]`` in
    :func:`shard_blocks_interleaved` layout (:func:`shard_blocks_vshape`
    for the V-shape tables), grads in it too."""
    return _scheduled_grad(mesh, cfg, "interleaved", num_virtual, num_microbatches, attn_fn,
                           interleaved=True, tp=False, tables=tables)


def make_pipeline_tp_lm_1f1b_grad(mesh: Mesh, cfg, num_stages: int, num_microbatches: int,
                                  attn_fn=None):
    """-> ``f(params, tokens) -> (loss, grads)``: 1F1B x Megatron TP;
    ``params["blocks"]`` in :func:`shard_blocks_pp_tp` layout (sharded
    leaves carry their shard's gradient, replicated leaves the full one)."""
    _check_stages(mesh, num_stages)
    return _scheduled_grad(mesh, cfg, "1f1b", 1, num_microbatches, attn_fn,
                           interleaved=False, tp=True)


def make_pipeline_tp_lm_gpipe_grad(mesh: Mesh, cfg, num_stages: int, num_microbatches: int,
                                   attn_fn=None):
    """-> ``f(params, tokens) -> (loss, grads)``: GPipe order x Megatron
    TP, the gradient of :func:`make_pipeline_tp_lm_loss`;
    ``params["blocks"]`` in :func:`shard_blocks_pp_tp` layout."""
    _check_stages(mesh, num_stages)
    return _scheduled_grad(mesh, cfg, "gpipe", 1, num_microbatches, attn_fn,
                           interleaved=False, tp=True)


def make_pipeline_tp_lm_interleaved_grad(mesh: Mesh, cfg, num_virtual: int,
                                         num_microbatches: int, attn_fn=None, tables=None):
    """-> ``f(params, tokens) -> (loss, grads)``: interleaved 1F1B (or
    ``tables``) x Megatron TP; ``params["blocks"]`` in
    :func:`shard_blocks_interleaved_tp` layout
    (:func:`shard_blocks_vshape_tp` for the V-shape tables)."""
    return _scheduled_grad(mesh, cfg, "interleaved", num_virtual, num_microbatches, attn_fn,
                           interleaved=True, tp=True, tables=tables)


def make_pipeline_lm_zb_grad(mesh: Mesh, cfg, num_virtual: int, num_microbatches: int,
                             attn_fn=None):
    """-> ``f(params, tokens) -> (loss, grads)`` via the ZB-H1 zero-bubble
    tables (:func:`~tpu_dist_nn_torch.parallel.schedule_table.build_zero_bubble`)
    with the recompute split backward: half 1F1B's bubble at ``v = 1``
    for one more backward a block (and, under remat, one more forward).
    ``params["blocks"]`` in :func:`shard_blocks_interleaved` layout
    (``num_virtual = 1``: the contiguous placement)."""
    tables = build_zero_bubble(mesh.shape[AXIS_STAGE], num_virtual, num_microbatches)
    return make_pipeline_lm_interleaved_grad(mesh, cfg, num_virtual, num_microbatches, attn_fn,
                                             tables=tables)


def make_pipeline_tp_lm_zb_grad(mesh: Mesh, cfg, num_virtual: int, num_microbatches: int,
                                attn_fn=None):
    """ZB-H1 x Megatron TP: the zero-bubble tables over chunks whose
    blocks are sharded on the cell's model slots (W adds no hand-off).
    ``params["blocks"]`` in :func:`shard_blocks_interleaved_tp` layout."""
    tables = build_zero_bubble(mesh.shape[AXIS_STAGE], num_virtual, num_microbatches)
    return make_pipeline_tp_lm_interleaved_grad(mesh, cfg, num_virtual, num_microbatches,
                                                attn_fn, tables=tables)


def make_pipeline_lm_zb_v_grad(mesh: Mesh, cfg, num_microbatches: int, attn_fn=None):
    """-> ``f(params, tokens) -> (loss, grads)`` via the ZB-V tables
    (:func:`~tpu_dist_nn_torch.parallel.schedule_table.build_zb_v`): the
    recompute split on the V-shape placement, two chunks a slot, chunk 0
    and the loss tail on slot 0, the apex hand-off local.
    ``params["blocks"]`` in :func:`shard_blocks_vshape` layout."""
    tables = build_zb_v(mesh.shape[AXIS_STAGE], num_microbatches)
    return make_pipeline_lm_interleaved_grad(mesh, cfg, 2, num_microbatches, attn_fn,
                                             tables=tables)


def make_pipeline_tp_lm_zb_v_grad(mesh: Mesh, cfg, num_microbatches: int, attn_fn=None):
    """ZB-V x Megatron TP; ``params["blocks"]`` in
    :func:`shard_blocks_vshape_tp` layout."""
    tables = build_zb_v(mesh.shape[AXIS_STAGE], num_microbatches)
    return make_pipeline_tp_lm_interleaved_grad(mesh, cfg, 2, num_microbatches, attn_fn,
                                                tables=tables)


def make_pipeline_lm_zb_stash_grad(mesh: Mesh, cfg, num_virtual: int, num_microbatches: int,
                                   attn_fn=None):
    """-> ``f(params, tokens) -> (loss, grads)`` via the ZB-H1 tables with
    the cotangent-stash split (:class:`StashSplit`): W is the dW GEMMs
    alone. Dense LM only; ``params["blocks"]`` in
    :func:`shard_blocks_interleaved` layout, as zb."""
    return _scheduled_grad(mesh, cfg, "zb-stash", num_virtual, num_microbatches, attn_fn,
                           interleaved=True, tp=False)


# ---------------------------------------------------------------------------
# Pipeline x sequence parallelism (x Megatron TP)
# ---------------------------------------------------------------------------


def make_pipeline_sp_lm_forward(mesh: Mesh, cfg, num_stages: int, num_microbatches: int,
                                mode: str = "ring", attn_fn=None):
    """-> ``fn(params, tokens) -> logits``: blocks pipelined over the
    stage slots (GPipe) with every microbatch's sequence split over the
    seq slots (ring or Ulysses attention in the stages), the batch over
    the data slots. ``params["blocks"]`` in :func:`shard_blocks` layout;
    ``tokens`` full (input + target) rows. ``attn_fn``: Ulysses' local
    attention."""
    return _pipeline_sp_logits(mesh, cfg, num_stages, num_microbatches, mode, attn_fn, tp=False)


def make_pipeline_sp_lm_loss(mesh: Mesh, cfg, num_stages: int, num_microbatches: int,
                             mode: str = "ring", attn_fn=None):
    """Masked next-token CE through :func:`make_pipeline_sp_lm_forward`
    (the sp-only loss's convention)."""
    fwd = make_pipeline_sp_lm_forward(mesh, cfg, num_stages, num_microbatches, mode, attn_fn)
    return lambda params, tokens: masked_next_token_ce(fwd(params, tokens), tokens)


def make_pipeline_tp_sp_lm_forward(mesh: Mesh, cfg, num_stages: int, num_microbatches: int,
                                   mode: str = "ring", attn_fn=None):
    """-> ``fn(params, tokens) -> logits``: GPipe x Megatron TP x sequence
    parallelism; ``params["blocks"]`` in :func:`shard_blocks_pp_tp`
    layout, ``tokens`` full rows."""
    return _pipeline_sp_logits(mesh, cfg, num_stages, num_microbatches, mode, attn_fn, tp=True)


def make_pipeline_tp_sp_lm_loss(mesh: Mesh, cfg, num_stages: int, num_microbatches: int,
                                mode: str = "ring", attn_fn=None):
    """Masked next-token CE through :func:`make_pipeline_tp_sp_lm_forward`."""
    fwd = make_pipeline_tp_sp_lm_forward(mesh, cfg, num_stages, num_microbatches, mode, attn_fn)
    return lambda params, tokens: masked_next_token_ce(fwd(params, tokens), tokens)


def make_pipeline_sp_lm_gpipe_grad(mesh: Mesh, cfg, num_stages: int, num_microbatches: int,
                                   mode: str = "ring", attn_fn=None):
    """-> ``f(params, tokens) -> (loss, grads)``: the gradient of
    :func:`make_pipeline_sp_lm_loss` played op by op in the GPipe order;
    ``params["blocks"]`` in :func:`shard_blocks` layout, full rows."""
    _check_stages(mesh, num_stages)
    return _scheduled_grad(mesh, cfg, "gpipe", 1, num_microbatches, attn_fn,
                           interleaved=False, tp=False, sp_mode=mode)


def make_pipeline_sp_lm_1f1b_grad(mesh: Mesh, cfg, num_stages: int, num_microbatches: int,
                                  mode: str = "ulysses", attn_fn=None):
    """1F1B x sequence parallelism (ring or Ulysses in the stage bodies,
    the masked-CE tail a (microbatch, seq shard)); ``params["blocks"]``
    in :func:`shard_blocks` layout, full rows."""
    _check_stages(mesh, num_stages)
    return _scheduled_grad(mesh, cfg, "1f1b", 1, num_microbatches, attn_fn,
                           interleaved=False, tp=False, sp_mode=mode)


def make_pipeline_sp_lm_interleaved_grad(mesh: Mesh, cfg, num_virtual: int,
                                         num_microbatches: int, mode: str = "ulysses",
                                         tables=None, attn_fn=None):
    """Interleaved 1F1B (or ``tables``: the zero-bubble ones) x sequence
    parallelism; ``params["blocks"]`` in :func:`shard_blocks_interleaved`
    layout (:func:`shard_blocks_vshape` for the V-shape tables)."""
    return _scheduled_grad(mesh, cfg, "interleaved", num_virtual, num_microbatches, attn_fn,
                           interleaved=True, tp=False, tables=tables, sp_mode=mode)


def make_pipeline_sp_lm_zb_grad(mesh: Mesh, cfg, num_virtual: int, num_microbatches: int,
                                mode: str = "ulysses", attn_fn=None):
    """ZB-H1 x sequence parallelism (the recompute split);
    :func:`shard_blocks_interleaved` layout."""
    tables = build_zero_bubble(mesh.shape[AXIS_STAGE], num_virtual, num_microbatches)
    return make_pipeline_sp_lm_interleaved_grad(mesh, cfg, num_virtual, num_microbatches, mode,
                                                tables=tables, attn_fn=attn_fn)


def make_pipeline_sp_lm_zb_v_grad(mesh: Mesh, cfg, num_microbatches: int, mode: str = "ring",
                                  attn_fn=None):
    """ZB-V x sequence parallelism; :func:`shard_blocks_vshape` layout."""
    tables = build_zb_v(mesh.shape[AXIS_STAGE], num_microbatches)
    return make_pipeline_sp_lm_interleaved_grad(mesh, cfg, 2, num_microbatches, mode,
                                                tables=tables, attn_fn=attn_fn)


def make_pipeline_tp_sp_lm_gpipe_grad(mesh: Mesh, cfg, num_stages: int, num_microbatches: int,
                                      mode: str = "ring", attn_fn=None):
    """GPipe order x Megatron TP x sequence parallelism, the gradient of
    :func:`make_pipeline_tp_sp_lm_loss`; :func:`shard_blocks_pp_tp` layout."""
    _check_stages(mesh, num_stages)
    return _scheduled_grad(mesh, cfg, "gpipe", 1, num_microbatches, attn_fn,
                           interleaved=False, tp=True, sp_mode=mode)


def make_pipeline_tp_sp_lm_1f1b_grad(mesh: Mesh, cfg, num_stages: int, num_microbatches: int,
                                     mode: str = "ring", attn_fn=None):
    """1F1B x Megatron TP x sequence parallelism (PP for depth, TP for
    width, SP for length, DP for batch): each seq shard's block runs on
    its model slots, attention over the seq slots of each model shard on
    its local heads (Ulysses needs ``(n_heads / model) % seq == 0``).
    :func:`shard_blocks_pp_tp` layout, full rows."""
    _check_stages(mesh, num_stages)
    return _scheduled_grad(mesh, cfg, "1f1b", 1, num_microbatches, attn_fn,
                           interleaved=False, tp=True, sp_mode=mode)


def make_pipeline_tp_sp_lm_interleaved_grad(mesh: Mesh, cfg, num_virtual: int,
                                            num_microbatches: int, mode: str = "ring",
                                            tables=None, attn_fn=None):
    """Interleaved 1F1B (or ``tables``) x Megatron TP x sequence
    parallelism; :func:`shard_blocks_interleaved_tp` layout
    (:func:`shard_blocks_vshape_tp` for the V-shape tables)."""
    return _scheduled_grad(mesh, cfg, "interleaved", num_virtual, num_microbatches, attn_fn,
                           interleaved=True, tp=True, tables=tables, sp_mode=mode)


def make_pipeline_tp_sp_lm_zb_grad(mesh: Mesh, cfg, num_virtual: int, num_microbatches: int,
                                   mode: str = "ring", attn_fn=None):
    """ZB-H1 x Megatron TP x sequence parallelism;
    :func:`shard_blocks_interleaved_tp` layout."""
    tables = build_zero_bubble(mesh.shape[AXIS_STAGE], num_virtual, num_microbatches)
    return make_pipeline_tp_sp_lm_interleaved_grad(mesh, cfg, num_virtual, num_microbatches,
                                                   mode, tables=tables, attn_fn=attn_fn)


def make_pipeline_tp_sp_lm_zb_v_grad(mesh: Mesh, cfg, num_microbatches: int,
                                     mode: str = "ring", attn_fn=None):
    """ZB-V x Megatron TP x sequence parallelism;
    :func:`shard_blocks_vshape_tp` layout."""
    tables = build_zb_v(mesh.shape[AXIS_STAGE], num_microbatches)
    return make_pipeline_tp_sp_lm_interleaved_grad(mesh, cfg, 2, num_microbatches, mode,
                                                   tables=tables, attn_fn=attn_fn)


def _check_stages(mesh: Mesh, num_stages: int) -> None:
    if mesh.shape[AXIS_STAGE] != num_stages:
        raise ValueError(f"num_stages={num_stages} but the mesh '{AXIS_STAGE}' axis has size "
                         f"{mesh.shape[AXIS_STAGE]}")
