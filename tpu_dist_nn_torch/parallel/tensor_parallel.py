"""Tensor parallelism over the model slots: the Megatron split.

Port of :mod:`tpu_dist_nn.parallel.tensor_parallel`:

* **Transformer blocks**: attention heads shard over the model slots
  (column-parallel fused QKV, row-parallel output projection + ``psum``),
  the MLP is column-parallel up / row-parallel down + ``psum``. GELU runs
  on the column shard (exact: elementwise); LayerNorm and the residuals
  stay replicated. Inside a shard attention is the port's attention
  entry (``attn_fn``, default
  :func:`~tpu_dist_nn_torch.kernels.flash_attention.default_attn_fn`:
  the flash kernels on the card, at ``H / N`` heads).
* **Dense (FCNN) chains**: column-parallel every layer, the output widths
  zero-padded to a multiple of ``N``; the shards' columns are gathered,
  the padding sliced off and the activation applied to the full row.

Under sequence parallelism :func:`tp_sp_block_apply` runs the same
block on each seq shard's model slots, with ring or Ulysses attention
across the seq slots of each model shard (on its local heads).

Layouts are the JAX package's: :func:`tp_shard_blocks` gives sharded
leaves a leading ``(N, ...)`` model axis and keeps :data:`TP_REPLICATED`
leaves ``(L, ...)``. Each shard's work is enqueued on its model slot's
stream and the partial sums meet in
:func:`~tpu_dist_nn_torch.parallel.collectives.psum` (fixed order, on
the cell's lead slot).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from tpu_dist_nn_torch.core.activations import apply_activation_by_id
from tpu_dist_nn_torch.kernels.flash_attention import default_attn_fn
from tpu_dist_nn_torch.models.transformer import (
    embed,
    layer_norm,
    maybe_remat,
    unembed,
    unstack_blocks,
)
from tpu_dist_nn_torch.parallel.collectives import all_gather, fan_out, fork, join, on_slot, psum
from tpu_dist_nn_torch.parallel.gpipe import caller_event, gather, launch
from tpu_dist_nn_torch.parallel.mesh import AXIS_DATA, AXIS_MODEL, Mesh, StageSlot

#: Leaves that stay replicated (no leading model axis): LayerNorm params
#: and the biases added after each psum.
TP_REPLICATED = frozenset({"ln1_g", "ln1_b", "ln2_g", "ln2_b", "b_o", "b_down"})

#: Every leaf of a dense transformer block.
BLOCK_KEYS = (
    "ln1_g", "ln1_b", "w_qkv", "b_qkv", "w_o", "b_o",
    "ln2_g", "ln2_b", "w_up", "b_up", "w_down", "b_down",
)


def tp_shard_blocks(blocks: dict, cfg, n: int) -> dict:
    """Stacked block leaves ``(L, ...) -> (N, L, ...)``, the Megatron
    layout: QKV columns and output-projection rows regrouped by head, MLP
    up columns / down rows split contiguously, :data:`TP_REPLICATED`
    leaves kept ``(L, ...)``."""
    L, D, Fd, H, Dh = blocks["w_qkv"].shape[0], cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim
    if H % n:
        raise ValueError(f"n_heads={H} not divisible by model axis {n}")
    if Fd % n:
        raise ValueError(f"d_ff={Fd} not divisible by model axis {n}")
    Hl = H // n

    def shard_qkv(a):  # (L, D, 3D) or (L, 3D)
        a = a.reshape(*a.shape[:-1], 3, n, Hl * Dh)
        return torch.movedim(a, -2, 0).reshape(n, *a.shape[:-3], 3 * Hl * Dh)

    return {
        "ln1_g": blocks["ln1_g"], "ln1_b": blocks["ln1_b"],
        "w_qkv": shard_qkv(blocks["w_qkv"]), "b_qkv": shard_qkv(blocks["b_qkv"]),
        "w_o": torch.movedim(blocks["w_o"].reshape(L, n, Hl * Dh, D), 1, 0),
        "b_o": blocks["b_o"],
        "ln2_g": blocks["ln2_g"], "ln2_b": blocks["ln2_b"],
        "w_up": torch.movedim(blocks["w_up"].reshape(L, D, n, Fd // n), 2, 0),
        "b_up": torch.movedim(blocks["b_up"].reshape(L, n, Fd // n), 1, 0),
        "w_down": torch.movedim(blocks["w_down"].reshape(L, n, Fd // n, D), 1, 0),
        "b_down": blocks["b_down"],
    }


def tp_unshard_blocks(staged: dict, cfg) -> dict:
    """Inverse of :func:`tp_shard_blocks`."""
    n, L = staged["w_qkv"].shape[0], staged["w_qkv"].shape[1]
    D, Fd, Dh = cfg.d_model, cfg.d_ff, cfg.head_dim
    Hl = cfg.n_heads // n

    def unshard_qkv(a):  # (N, L, D?, 3*Hl*Dh)
        a = a.reshape(n, *a.shape[1:-1], 3, Hl * Dh)
        return torch.movedim(a, 0, -2).reshape(*a.shape[1:-2], 3 * cfg.n_heads * Dh)

    return {
        "ln1_g": staged["ln1_g"], "ln1_b": staged["ln1_b"],
        "w_qkv": unshard_qkv(staged["w_qkv"]), "b_qkv": unshard_qkv(staged["b_qkv"]),
        "w_o": torch.movedim(staged["w_o"], 0, 1).reshape(L, D, D),
        "b_o": staged["b_o"],
        "ln2_g": staged["ln2_g"], "ln2_b": staged["ln2_b"],
        "w_up": torch.movedim(staged["w_up"], 0, 2).reshape(L, D, Fd),
        "b_up": torch.movedim(staged["b_up"], 0, 1).reshape(L, Fd),
        "w_down": torch.movedim(staged["w_down"], 0, 1).reshape(L, Fd, D),
        "b_down": staged["b_down"],
    }


def shard_views(blocks_tp: dict, n: int) -> list[dict]:
    """The ``N`` shards of a :func:`tp_shard_blocks`-layout dict (or any
    dict whose sharded leaves lead with the model axis): shard ``m``'s
    leaves, replicated leaves shared."""
    return [{k: (v if k in TP_REPLICATED else v[m]) for k, v in blocks_tp.items()}
            for m in range(n)]


def tp_block_apply(blocks: Sequence[dict], x, cfg, slots: Sequence[StageSlot] | None = None,
                   attn_fn=None, *, shard_attn=None):
    """One Megatron-sharded block on replicated ``x (B, T, D)``.

    ``blocks[m]``: shard ``m``'s unstacked leaves (replicated leaves in
    each); ``slots``: the cell's model slots (``None``: every shard on
    ``x``'s device, run in order). Shard ``m``'s work runs on
    ``slots[m]``; the two psums (after the attention output projection
    and after the MLP down projection) and the residuals run on
    ``slots[0]``, the lead. ``shard_attn(m, q, k, v)``, when given,
    replaces the causal ``attn_fn`` (the decoders attend over shard
    ``m``'s KV cache). Returns the block's output on the lead, on the
    caller's stream."""
    attn_fn = attn_fn or default_attn_fn()
    if shard_attn is None:
        def shard_attn(m, q, k, v):
            return attn_fn(q, k, v, causal=cfg.causal)
    n = len(blocks)
    if slots is None:
        slots = [StageSlot(x.device, None)] * n
    lead = slots[0]
    B, T, D = x.shape
    Hl, Dh = cfg.n_heads // n, cfg.head_dim
    caller = torch.cuda.current_stream(lead.device) if lead.stream is not None else None
    if caller is not None:
        lead.stream.wait_stream(caller)

    def shards(fn, xs):
        parts = []
        for m, (slot, block, xm) in enumerate(zip(slots, blocks, xs)):
            with on_slot(slot):
                parts.append(fn(m, block, xm))
        return parts

    def attn_part(m, block, xm):
        q, k, v = _shard_qkv(block, xm, Hl, Dh)
        return shard_attn(m, q, k, v).reshape(B, T, Hl * Dh) @ block["w_o"]

    with on_slot(lead):
        parts = shards(attn_part, fan_out(x, slots))
        x = x + (psum(parts, slots) + blocks[0]["b_o"])
        parts = shards(_shard_mlp, fan_out(x, slots))
        y = x + (psum(parts, slots) + blocks[0]["b_down"])
    if caller is not None:
        caller.wait_stream(lead.stream)
        y.record_stream(caller)
    return y


def _shard_qkv(block: dict, xm, Hl: int, Dh: int):
    """A model shard's q, k, v ``(B, T, Hl, Dh)`` from its QKV columns."""
    B, T, _ = xm.shape
    h = layer_norm(xm, block["ln1_g"], block["ln1_b"])
    qkv = h @ block["w_qkv"] + block["b_qkv"]
    return qkv.reshape(B, T, 3 * Hl, Dh).split(Hl, dim=2)


def _shard_mlp(m, block: dict, xm):
    """A model shard's partial MLP output (before the psum)."""
    h = layer_norm(xm, block["ln2_g"], block["ln2_b"])
    up = F.gelu(h @ block["w_up"] + block["b_up"], approximate="tanh")
    return up @ block["w_down"]


def tp_sp_block_apply(blocks: Sequence[Sequence[dict]], xs, cfg,
                      seq_slots: Sequence[Sequence[StageSlot]], sp_attn):
    """One Megatron-sharded block over seq shards: :func:`tp_block_apply`
    on each seq shard's model slots, in phases, with attention across the
    seq slots of each model shard.

    ``xs[q] (B, T_local, D)``, replicated over seq shard ``q``'s model
    slots ``seq_slots[q]`` (its lead ``seq_slots[q][0]`` holds it);
    ``blocks[q][m]``: model shard ``m``'s unstacked leaves on slot
    ``(q, m)``. The QKV projections run on every ``(q, m)`` slot;
    ``sp_attn`` (ring or Ulysses) then attends over ``[(q, m) for q]`` on
    model shard ``m``'s ``H / N`` local heads; the output projection, the
    MLP and the two psums run per seq shard exactly as
    :func:`tp_block_apply` runs them. Every slot first waits for the
    caller's stream, which waits for every slot at the end. Returns the
    shards' outputs, each on its seq shard's lead."""
    n = len(seq_slots[0])
    Hl, Dh = cfg.n_heads // n, cfg.head_dim
    flat = [slot for row in seq_slots for slot in row]
    caller = fork(flat)

    def shards(fn, q, xms):
        parts = []
        for m, (slot, block, xm) in enumerate(zip(seq_slots[q], blocks[q], xms)):
            with on_slot(slot):
                parts.append(fn(m, block, xm))
        return parts

    fanned, qkv = [], []
    for q, (row, x) in enumerate(zip(seq_slots, xs)):
        with on_slot(row[0]):
            fanned.append(fan_out(x, row))
        qkv.append(shards(lambda m, block, xm: _shard_qkv(block, xm, Hl, Dh), q, fanned[q]))
    outs = [[None] * n for _ in xs]
    for m in range(n):
        got = sp_attn(*([qkv[q][m][j] for q in range(len(xs))] for j in range(3)),
                      [row[m] for row in seq_slots], causal=cfg.causal)
        for q, o in enumerate(got):
            outs[q][m] = o
    ys = []
    for q, (row, x) in enumerate(zip(seq_slots, xs)):
        B, T, _ = x.shape
        with on_slot(row[0]):
            parts = shards(lambda m, block, o: o.reshape(B, T, Hl * Dh) @ block["w_o"], q,
                           outs[q])
            x = x + (psum(parts, row) + blocks[q][0]["b_o"])
            parts = shards(_shard_mlp, q, fan_out(x, row))
            ys.append(x + (psum(parts, row) + blocks[q][0]["b_down"]))
    join(caller, flat)
    return tuple(ys)


def tp_sp_scan(shards: Sequence[Sequence[dict]], xs, cfg, seq_slots, sp_attn):
    """A stacked block group through :func:`tp_sp_block_apply` (under
    remat when ``cfg.remat``, one checkpoint a block across every seq and
    model slot): ``shards[q][m]`` holds slot ``(q, m)``'s stacked
    ``(Lg, ...)`` leaves."""
    apply = maybe_remat(cfg, tp_sp_block_apply)
    per = [[unstack_blocks(sh) for sh in row] for row in shards]
    for l in range(len(per[0][0])):
        layer = [[blocks[l] for blocks in row] for row in per]
        xs = apply(layer, xs, cfg, seq_slots, sp_attn)
    return xs


def tp_scan(shards: Sequence[dict], x, cfg, slots=None, attn_fn=None):
    """A stacked block group through :func:`tp_block_apply` (under remat
    when ``cfg.remat``): ``shards[m]`` holds shard ``m``'s stacked
    ``(Lg, ...)`` leaves."""
    apply = maybe_remat(cfg, tp_block_apply)
    per_shard = [unstack_blocks(s) for s in shards]
    for layer in zip(*per_shard):
        x = apply(list(layer), x, cfg, slots, attn_fn)
    return x


def _split_rows(tokens, parts: int):
    if tokens.shape[0] % parts:
        raise ValueError(f"batch {tokens.shape[0]} not divisible by data axis {parts}")
    return tokens.chunk(parts, dim=0)


def make_tp_lm_forward(mesh: Mesh, cfg, attn_fn=None):
    """-> ``fn(params_tp, tokens) -> logits`` with the blocks Megatron-
    sharded over the mesh's model slots (stage 1).

    ``params_tp["blocks"]`` from :func:`tp_shard_blocks`; the embedding
    and the tied head stay replicated (on each data replica's lead), the
    batch shards over ``data``. Logits come back on the params' device.
    """
    n, D = mesh.shape[AXIS_MODEL], mesh.shape[AXIS_DATA]

    def forward(params_tp, tokens):
        params_c = cfg.cast_params(params_tp)
        shards = shard_views(params_c["blocks"], n)
        home = params_c["tok_embed"].device
        ready = caller_event(params_c["tok_embed"])
        outs = []
        for d, rows in enumerate(_split_rows(tokens, D)):
            cell = mesh.model_slots[0][d]

            def run(rows, cell=cell):
                here = [{k: v.to(slot.device) for k, v in sh.items()}
                        for slot, sh in zip(cell, shards)]
                top = {k: params_c[k].to(cell[0].device)
                       for k in ("tok_embed", "pos_embed", "lnf_g", "lnf_b")}
                x = embed(top, rows.to(cell[0].device))
                return unembed(top, tp_scan(here, x, cfg, cell, attn_fn))

            outs.append(launch(cell[0], run, rows, ready))
        return torch.cat(gather(outs, home), dim=0)

    return forward


# ---------------------------------------------------------------------------
# FCNN chains: padded column parallelism
# ---------------------------------------------------------------------------


def tp_shard_fcnn(params: Sequence[dict], n: int) -> tuple[list[dict], tuple[int, ...]]:
    """Column-shard each dense layer: ``w (Din, Dout) -> (N, Din,
    ceil(Dout/N))``, output widths zero-padded to a multiple of ``n``.
    Returns the sharded params and the true output widths."""
    out, true_dims = [], []
    for p in params:
        din, dout = p["w"].shape
        pad = (-dout) % n
        out.append({
            "w": F.pad(p["w"], (0, pad)).reshape(din, n, -1).transpose(0, 1).contiguous(),
            "b": F.pad(p["b"], (0, pad)).reshape(n, -1),
            "act": int(p["act"]),
        })
        true_dims.append(dout)
    return out, tuple(true_dims)


def make_tp_fcnn_forward(mesh: Mesh, true_dims: tuple[int, ...]):
    """-> ``fn(params_tp, x) -> y``: the column-parallel dense chain.

    Each model slot computes its slice of every layer's neurons; the
    slices are gathered in shard order on the lead, the padding is sliced
    off and the activation applied to the replicated row: numerically the
    single-program chain. The batch shards over ``data``."""
    n, D = mesh.shape[AXIS_MODEL], mesh.shape[AXIS_DATA]

    def forward(params_tp, x):
        home = x.device
        ready = caller_event(x)
        outs = []
        for d, rows in enumerate(_split_rows(x, D)):
            cell = mesh.model_slots[0][d]

            def run(h, cell=cell):
                h = h.to(cell[0].device)
                for p, dout in zip(params_tp, true_dims):
                    hs = fan_out(h, cell)
                    parts = []
                    for m, (slot, hm) in enumerate(zip(cell, hs)):
                        with on_slot(slot):
                            parts.append(hm @ p["w"][m].to(slot.device) + p["b"][m].to(slot.device))
                    z = all_gather(parts, cell)
                    h = apply_activation_by_id(z[..., :dout], p["act"])
                return h

            outs.append(launch(cell[0], run, rows, ready))
        return torch.cat(gather(outs, home), dim=0)

    return forward
