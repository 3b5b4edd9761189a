"""Sequence parallelism over seq slots: ring and Ulysses attention.

Port of :mod:`tpu_dist_nn.parallel.ring_attention`. The JAX package
shards the sequence over the mesh's ``seq`` axis inside ``shard_map``;
the port's one process drives the seq slots of a cell
(:mod:`~tpu_dist_nn_torch.parallel.mesh`): the attention functions take
every seq shard's ``q, k, v`` at once, ``qs[i]`` on ``slots[i]``, and
return every shard's output, each on its own slot.

* :func:`ring_attention`: ``N`` steps of the online softmax in float32
  (running max ``m``, denominator ``l`` and ``acc``; ``safe_m`` and
  ``corr`` guard a row whose keys are all masked so far), with the K/V
  blocks rotated one hop a step (:func:`~tpu_dist_nn_torch.parallel.
  collectives.rotate`). Causality comes from global positions: block
  ``i`` of the sequence starts at ``i * T_local``. The last rotation
  would only bring each block home, so it is skipped. The per-hop block
  is torch ops in float32, as the JAX scan is ``einsum`` s: no flash
  kernel runs. Both ``ROTATE_MODES`` are the same hand-off here: the
  JAX package's ``"collective"`` rotation exists because ``ppermute``
  cannot run inside a ``lax.switch`` branch, and the port has no
  branches.
* :func:`ulysses_attention`: an all-to-all to the full sequence on a
  slice of ``H / N`` heads a slot, the local causal attention there
  (the port's attention entry: the flash kernels on a card), and an
  all-to-all back.

:func:`sp_block_apply` runs one transformer block over seq-sharded
activations (position-local work on each shard's slot, attention across
them), and :func:`make_seq_parallel_lm_forward` / ``_loss`` the whole LM
on a ``(seq, data)`` grid, positions global (``q * T_local + t``).
The loss is fed full (input + target) rows and scores positions
``0..T-2`` (:func:`~tpu_dist_nn_torch.models.transformer.
masked_next_token_ce`), since the shifted ``[:, :-1]`` slice would break
seq divisibility.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from tpu_dist_nn_torch.kernels.flash_attention import default_attn_fn
from tpu_dist_nn_torch.models.transformer import (
    layer_norm,
    masked_next_token_ce,
    maybe_remat,
    tree_map,
    unembed,
    unstack_blocks,
)
from tpu_dist_nn_torch.parallel.collectives import all_to_all, fork, join, on_slot
from tpu_dist_nn_torch.parallel.collectives import rotate as hop
from tpu_dist_nn_torch.parallel.gpipe import caller_event, gather, launch
from tpu_dist_nn_torch.parallel.mesh import AXIS_DATA, AXIS_SEQ, Mesh, StageSlot

ROTATE_MODES = ("ppermute", "collective")
SP_MODES = ("ring", "ulysses")


def _slots_or_cpu(xs: Sequence[torch.Tensor], slots):
    return [StageSlot(x.device, None) for x in xs] if slots is None else list(slots)


def ring_attention(qs, ks, vs, slots=None, *, causal: bool, rotate: str = "ppermute"):
    """Blockwise ring attention over seq slots.

    ``qs[i], ks[i], vs[i]: (B, T_local, H, Dh)``, seq shard ``i`` on
    ``slots[i]`` (``None``: every shard on its tensor's device, in
    order). Returns ``[(B, T_local, H, Dh)]``, shard ``i`` on slot ``i``:
    ``dot_product_attention`` of the gathered sequence, computed without
    gathering it. ``rotate`` names the JAX package's K/V hand-off; both
    modes are the one hop of :func:`~tpu_dist_nn_torch.parallel.
    collectives.rotate` here."""
    if rotate not in ROTATE_MODES:
        raise ValueError(f"unknown rotate mode {rotate!r}: use {ROTATE_MODES}")
    slots = _slots_or_cpu(qs, slots)
    n = len(slots)
    out_dtype = qs[0].dtype
    B, Tq, H, Dh = qs[0].shape
    scale = 1.0 / math.sqrt(Dh)
    q32, q_pos, m, l, acc = [], [], [], [], []
    for i, (slot, q) in enumerate(zip(slots, qs)):
        with on_slot(slot):
            q32.append(q.float())
            q_pos.append(i * Tq + torch.arange(Tq, device=q.device))
            m.append(torch.full((B, H, Tq), -math.inf, device=q.device))
            l.append(torch.zeros((B, H, Tq), device=q.device))
            acc.append(torch.zeros((B, Tq, H, Dh), device=q.device))
    k_blk, v_blk = list(ks), list(vs)
    for step in range(n):
        for i, slot in enumerate(slots):
            with on_slot(slot):
                kv_idx = (i - step) % n  # after `step` hops slot i holds block i - step
                kb = k_blk[i]
                scores = torch.einsum("bqhd,bkhd->bhqk", q32[i], kb.float()) * scale
                if causal:
                    k_pos = kv_idx * kb.shape[1] + torch.arange(kb.shape[1], device=kb.device)
                    mask = k_pos[None, :] <= q_pos[i][:, None]
                    scores = torch.where(mask[None, None], scores, -math.inf)
                # The output does not depend on the running max, so it
                # takes no gradient (exact: softmax is shift-invariant).
                with torch.no_grad():
                    new_m = torch.maximum(m[i], scores.amax(dim=-1))
                    # A row with every key masked so far keeps new_m =
                    # -inf: a safe stand-in makes its mass exactly 0.
                    safe_m = torch.where(torch.isneginf(new_m), 0.0, new_m)
                    corr = torch.where(torch.isneginf(m[i]), 0.0, torch.exp(m[i] - safe_m))
                p = torch.exp(scores - safe_m[..., None])
                l[i] = l[i] * corr + p.sum(dim=-1)
                acc[i] = acc[i] * corr.transpose(1, 2)[..., None] + torch.einsum(
                    "bhqk,bkhd->bqhd", p, v_blk[i].float())
                m[i] = new_m
        if step < n - 1:
            k_blk, v_blk = hop(k_blk, slots), hop(v_blk, slots)
    out = []
    for i, slot in enumerate(slots):
        with on_slot(slot):
            # Causal self-attention always has the diagonal live: l > 0.
            out.append((acc[i] / l[i].transpose(1, 2)[..., None]).to(out_dtype))
    return out


def ulysses_attention(qs, ks, vs, slots=None, *, causal: bool, attn_fn=None):
    """DeepSpeed-Ulysses sequence parallelism over seq slots: two
    all-to-alls give each slot the full sequence on ``H / N`` heads,
    ``attn_fn`` (default :func:`~tpu_dist_nn_torch.kernels.
    flash_attention.default_attn_fn`) attends there, and two more
    bring each shard its positions back. Same shapes as
    :func:`ring_attention`; needs ``H % N == 0``."""
    slots = _slots_or_cpu(qs, slots)
    n, H = len(slots), qs[0].shape[2]
    if H % n:
        raise ValueError(f"ulysses needs n_heads ({H}) divisible by the seq axis ({n})")
    attn_fn = attn_fn or default_attn_fn()

    def to_heads(xs):  # (B, T/N, H, Dh) -> (B, T, H/N, Dh)
        return all_to_all(xs, slots, split_dim=2, concat_dim=1)

    qh, kh, vh = to_heads(qs), to_heads(ks), to_heads(vs)
    os_ = []
    for slot, q, k, v in zip(slots, qh, kh, vh):
        with on_slot(slot):
            os_.append(attn_fn(q, k, v, causal=causal))
    return all_to_all(os_, slots, split_dim=1, concat_dim=2)


def _sp_attn_fn(mode: str, *, in_schedule: bool = False, attn_fn=None):
    """An SP mode's attention: ``fn(qs, ks, vs, slots, *, causal)``.
    ``in_schedule`` picks the JAX package's branch-safe ring rotation
    (the same hand-off here); ``attn_fn`` is Ulysses' local attention."""
    if mode not in SP_MODES:
        raise ValueError(f"unknown sequence-parallel mode {mode!r}: use {SP_MODES}")
    if mode == "ring":
        return functools.partial(ring_attention,
                                 rotate="collective" if in_schedule else "ppermute")
    return functools.partial(ulysses_attention, attn_fn=attn_fn)


def sp_block_apply(blocks: Sequence[dict], xs, cfg, slots: Sequence[StageSlot], sp_attn):
    """One pre-LN block over seq shards: ``xs[q] (B, T_local, D)`` on
    ``slots[q]`` with its unstacked leaves ``blocks[q]``. Each shard's
    position-local work (LayerNorms, projections, MLP, residuals) runs on
    its slot's stream, the same ops as :func:`~tpu_dist_nn_torch.models.
    transformer.block_apply`; ``sp_attn`` attends across the slots,
    between a :func:`~tpu_dist_nn_torch.parallel.collectives.fork` and a
    ``join``. Returns the shards' outputs, each on its slot."""
    H, Dh = cfg.n_heads, cfg.head_dim
    caller = fork(slots)
    qkv = []
    for slot, block, x in zip(slots, blocks, xs):
        with on_slot(slot):
            B, T, D = x.shape
            h = layer_norm(x, block["ln1_g"], block["ln1_b"])
            qkv.append((h @ block["w_qkv"] + block["b_qkv"]).reshape(B, T, 3 * H, Dh).split(H, 2))
    os_ = sp_attn(*([t[j] for t in qkv] for j in range(3)), slots, causal=cfg.causal)
    ys = []
    for slot, block, x, o in zip(slots, blocks, xs, os_):
        with on_slot(slot):
            y = x + o.reshape(x.shape) @ block["w_o"] + block["b_o"]
            h = layer_norm(y, block["ln2_g"], block["ln2_b"])
            h = F.gelu(h @ block["w_up"] + block["b_up"], approximate="tanh")
            ys.append(y + h @ block["w_down"] + block["b_down"])
    join(caller, slots)
    return tuple(ys)


def sp_scan(blocks: Sequence[dict], xs, cfg, slots: Sequence[StageSlot], sp_attn):
    """A stacked block group through :func:`sp_block_apply` (under remat
    when ``cfg.remat``: one checkpoint a block across every seq slot, its
    recompute replaying the hand-offs): ``blocks[q]`` holds seq shard
    ``q``'s stacked ``(Lg, ...)`` leaves."""
    apply = maybe_remat(cfg, sp_block_apply)
    for layer in zip(*(unstack_blocks(b) for b in blocks)):
        xs = apply(list(layer), xs, cfg, slots, sp_attn)
    return xs


def embed_at(params: dict, tokens, offset: int):
    """The embedding of a seq shard whose first position is ``offset``."""
    T = tokens.shape[-1]
    return params["tok_embed"][tokens.long()] + params["pos_embed"][offset:offset + T]


TABLE_NOTE = " (sp feeds full input+target rows: size the table seq_len+1)"


def check_sp_rows(cfg, T: int, seq: int, split_note: str = "",
                  table_note: str = TABLE_NOTE) -> None:
    """Rows the seq axis or the position table cannot take, in the JAX
    package's texts (each entry point adds its own note)."""
    if T % seq:
        raise ValueError(f"sequence length {T} not divisible by seq axis {seq}{split_note}")
    if T > cfg.max_seq_len:
        # Without this, the positions past the table would be wrong
        # (JAX's gather clamps at its edge).
        raise ValueError(f"sequence length {T} exceeds max_seq_len {cfg.max_seq_len}{table_note}")


def make_seq_parallel_lm_forward(mesh: Mesh, cfg, mode: str = "ring", attn_fn=None):
    """-> ``fn(params, tokens) -> logits`` with the sequence sharded over
    the mesh's seq slots and the batch over its data slots (stage and
    model 1). Each seq shard embeds its tokens at their global
    positions, runs every block (:func:`sp_block_apply`; the leaves cast
    on its own slot's stream) and the tied head; the logits come back on
    the params' device. ``params`` may be a list of one tree a data
    replica (the ZeRO steps' per-slot leaves, :mod:`~tpu_dist_nn_torch.
    parallel.zero`): replica ``d`` then reads only ``params[d]``. ``attn_fn`` is Ulysses' local attention (the
    port's attention entry by default)."""
    Q, D = mesh.shape[AXIS_SEQ], mesh.shape[AXIS_DATA]
    sp_attn = _sp_attn_fn(mode, attn_fn=attn_fn)
    if mode == "ulysses" and cfg.n_heads % Q:
        raise ValueError(
            f"--sp-mode ulysses needs n_heads ({cfg.n_heads}) divisible by the seq axis ({Q}); "
            "use ring or adjust heads")

    def forward(params, tokens):
        check_sp_rows(cfg, tokens.shape[1], Q)
        if tokens.shape[0] % D:
            raise ValueError(f"batch {tokens.shape[0]} not divisible by data axis {D}")
        replicas = list(params) if isinstance(params, (list, tuple)) else [params] * D
        home = replicas[0]["tok_embed"].device
        ready = caller_event(tokens)
        outs = []
        for d, rows in enumerate(tokens.chunk(D, dim=0)):
            slots = mesh.seq_leads(0, d)

            def run(xs, slots=slots, params=replicas[d]):
                lead = slots[0]
                here = []
                for slot in slots:
                    if slot is not lead and slot.stream is not None:
                        slot.stream.wait_stream(lead.stream)
                    with on_slot(slot):
                        here.append(cfg.cast_params(tree_map(lambda a: a.to(slot.device),
                                                             params)))
                Tl = xs[0].shape[-1]
                hs = []
                for q, (slot, p, x) in enumerate(zip(slots, here, xs)):
                    with on_slot(slot):
                        hs.append(embed_at(p, x, q * Tl))
                hs = sp_scan([p["blocks"] for p in here], tuple(hs), cfg, slots, sp_attn)
                logits = []
                for slot, p, h in zip(slots, here, hs):
                    with on_slot(slot):
                        logits.append(unembed(p, h))
                return tuple(logits)

            outs.append(launch(slots, run, tuple(rows.chunk(Q, dim=1)), ready))
        shards = gather([(y, ev) for ys, ev in outs for y in ys], home)
        return torch.cat([torch.cat(shards[d * Q:(d + 1) * Q], dim=1) for d in range(D)], dim=0)

    return forward


def make_seq_parallel_lm_loss(mesh: Mesh, cfg, mode: str = "ring", attn_fn=None):
    """Next-token CE through the sequence-parallel forward, fed full
    rows: positions ``0..T-2`` against targets ``1..T-1``."""
    fwd = make_seq_parallel_lm_forward(mesh, cfg, mode, attn_fn)
    return lambda params, tokens: masked_next_token_ce(fwd(params, tokens), tokens)
