"""Mixture-of-experts LM, and expert parallelism over expert slots.

Port of :mod:`tpu_dist_nn.parallel.expert_parallel`: the Switch /
GShard recipe with the JAX package's numerics.

* **Top-k routing with static capacity.** Each token picks its
  ``router_top_k`` highest-probability experts (ties to the lower index,
  as ``lax.top_k``); each expert takes at most ``C = ceil(k *
  capacity_factor * tokens_per_group / n_experts)`` tokens, filled rank
  by rank, and a token past an expert's capacity is dropped at that
  rank (the residual carries it). ``k = 1`` gates with the raw top
  probability, ``k >= 2`` with the top-k probabilities renormalised.
* **By index, not one-hot.** The JAX package builds ``(S, E, C)``
  one-hot dispatch and combine tensors and contracts them; at the 85M
  width with 8 experts and top-2 that is 2.7 GB and a TFLOP a layer.
  The port computes the same function by index (:func:`route_topk`):
  rank-ordered slot positions from an integer ``cumsum``, the kept
  tokens written into the ``(E, C, D)`` buffer (:func:`dispatch`: bit
  for bit the one-hot product, each slot holding one token times 1.0)
  and a gate-weighted gather back (:func:`combine`: a token's k terms
  added in rank order). A dropped token goes to a spare dump row that is
  cut off. Shapes are static and nothing reads the device from the host,
  so a step that routes is captured as a CUDA graph.
* **Grouped routing.** Tokens route within fixed groups, so a sharded
  program and the single program run the same math: the single program
  with ``n_groups`` (and ``n_seq_groups``) equal to the shards' routing
  groups is the oracle of every sharded path (:func:`moe_ffn_apply`).
* **Expert slots.** The JAX package shards the experts over the mesh's
  ``expert`` axis inside ``shard_map``; the port's one process drives a
  cell's shards (:meth:`~tpu_dist_nn_torch.parallel.mesh.Mesh.shards`,
  the ``(expert, seq)`` pairs of a ``(stage, data)`` cell), each on its
  own slot: attention runs on each shard's rows (across the seq shards
  under sequence parallelism), and each MoE layer hands the dispatch
  buffers over :func:`~tpu_dist_nn_torch.parallel.collectives.
  all_to_all` (split 0, concat 1), runs each slot's ``E / n_ep``
  experts as one ``torch.bmm`` bank, and hands them back (split 1,
  concat 0). The batch splits over ``(data, expert)`` jointly,
  data-major (shard ``g = d * n_ep + x``).

Gradients of shared leaves: a shard reads its leaves as views (the
single-program and flat paths) or as detached leaves per chunk (the
schedules), so an expert leaf's gradient sums over the data (and seq)
shards that hold its expert slot only, and a replicated leaf's over
every shard, by autograd's accumulation (one order per graph, the same
on every run). Under tensor parallelism inside the experts, the bank's
F columns split over the shard's model slots (column-parallel ``w_up``
/ ``b_up``, row-parallel ``w_down``, one fixed-order
:func:`~tpu_dist_nn_torch.parallel.collectives.psum`, ``b_down`` added
once after it); everything else runs once on the shard's lead.

The router loss is the Switch loss ``E * sum_e f_e p_e`` over rank-0
choices, a group's, averaged over groups and blocks; the pipelined
paths carry it on the executors' aux channel
(:func:`~tpu_dist_nn_torch.parallel.gpipe.gpipe_forward`,
:func:`~tpu_dist_nn_torch.parallel.one_f_one_b.run_schedule`).

:func:`recording_routes` records every forward's routes in a
:class:`RouteLog` by (layer, routing group), for checks on the card.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_dist_nn_torch.kernels.flash_attention import default_attn_fn
from tpu_dist_nn_torch.models.transformer import (
    TransformerConfig,
    attn_sublayer,
    dot_product_attention,
    init_transformer,
    layer_norm,
    masked_next_token_ce,
    maybe_remat,
    next_token_ce,
    transformer_params_from_jax,
    tree_map,
    unembed,
    unstack_blocks,
)
from tpu_dist_nn_torch.parallel.collectives import all_to_all, fan_out, fork, join, on_slot, psum
from tpu_dist_nn_torch.parallel.gpipe import _receive, caller_event, gather, gpipe_forward, launch
from tpu_dist_nn_torch.parallel.interleaved import table_order
from tpu_dist_nn_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_MODEL,
    AXIS_SEQ,
    AXIS_STAGE,
    Mesh,
    StageSlot,
)
from tpu_dist_nn_torch.parallel.one_f_one_b import (
    run_schedule,
    schedule_tables,
    training_order,
)
from tpu_dist_nn_torch.parallel.ring_attention import _sp_attn_fn, check_sp_rows, embed_at
from tpu_dist_nn_torch.parallel.schedule_table import build_zb_v, build_zero_bubble
from tpu_dist_nn_torch.utils.device import resolve_device

#: Block leaves sharded over the expert slots (an expert axis after the
#: layer axis in the stacked layout). Every other leaf is replicated.
EP_SHARDED = frozenset({"w_up", "b_up", "w_down", "b_down"})

#: Every MoE block leaf.
MOE_BLOCK_KEYS = (
    "ln1_g", "ln1_b", "w_qkv", "b_qkv", "w_o", "b_o",
    "ln2_g", "ln2_b", "w_router", "w_up", "b_up", "w_down", "b_down",
)

_TOP = ("tok_embed", "pos_embed", "lnf_g", "lnf_b")
_TAIL = ("tok_embed", "lnf_g", "lnf_b")


@dataclasses.dataclass(frozen=True)
class MoEConfig(TransformerConfig):
    """Transformer config plus the routing knobs (hashable, static)."""

    n_experts: int = 4
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2
    router_top_k: int = 1

    def __post_init__(self):
        super().__post_init__()
        if not 1 <= self.router_top_k <= self.n_experts:
            raise ValueError(
                f"router_top_k={self.router_top_k} must be in "
                f"[1, n_experts={self.n_experts}]"
            )

    def capacity(self, tokens_per_group: int) -> int:
        """Slots an expert has in a group of ``tokens_per_group`` tokens:
        scales with ``router_top_k`` (k choices a token), at least 1."""
        return max(1, int(np.ceil(
            self.router_top_k * self.capacity_factor * tokens_per_group / self.n_experts)))


def init_moe_transformer(gen: torch.Generator, cfg: MoEConfig, *, device=None) -> dict:
    """Params like :func:`~tpu_dist_nn_torch.models.transformer.
    init_transformer`'s with each block's MLP a bank of ``n_experts``
    FFNs and a router, at the JAX package's scales: ``w_router (L, D,
    E)`` and ``w_up (L, E, D, F)`` N(0, 1/D), ``w_down (L, E, F, D)``
    N(0, 1/F) / (2L), zero biases. Drawn on the CPU from ``gen``, then
    moved to ``device`` (default: cuda)."""
    dev = resolve_device(device)
    base = init_transformer(gen, cfg, device="cpu")
    L, D, Fd, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    s = 1.0 / math.sqrt(D)
    blocks = {k: v for k, v in base["blocks"].items() if k not in EP_SHARDED}
    blocks["w_router"] = torch.randn((L, D, E), generator=gen) * s
    blocks["w_up"] = torch.randn((L, E, D, Fd), generator=gen) * s
    blocks["b_up"] = torch.zeros((L, E, Fd))
    blocks["w_down"] = (torch.randn((L, E, Fd, D), generator=gen)
                        * (1.0 / math.sqrt(Fd)) / math.sqrt(2 * L))
    blocks["b_down"] = torch.zeros((L, E, D))
    return tree_map(lambda a: a.to(dev), dict(base, blocks=blocks))


def moe_params_from_jax(tree: dict, *, device=None) -> dict:
    """The JAX package's ``init_moe_transformer`` params (a nested dict of
    arrays) as float32 tensors on ``device`` (default: cuda): every
    leaf, ``w_router (L, D, E)``, ``w_up (L, E, D, F)``, ``b_up (L, E,
    F)``, ``w_down (L, E, F, D)`` and ``b_down (L, E, D)`` among them,
    carried across in its layout."""
    missing = set(MOE_BLOCK_KEYS) - set(tree["blocks"])
    if missing:
        raise ValueError(f"not MoE params: blocks lack {sorted(missing)}")
    return transformer_params_from_jax(tree, device=device)


# ---------------------------------------------------------------------------
# Routing, dispatch and combine by index
# ---------------------------------------------------------------------------


class Routes(NamedTuple):
    """One routing of a batch of groups (leading dims ``...``, ``S``
    tokens a group, ``k`` choices a token, ``E`` experts, ``C`` slots an
    expert)."""

    #: ``(..., S, k)`` int64: the buffer row ``e * C + p`` each choice
    #: fills, or ``E * C`` (the spare dump row) where it is dropped
    slot: torch.Tensor
    #: ``(..., S, k)`` float32: the gate where kept, 0 where dropped
    gate: torch.Tensor
    #: ``(..., S, k)`` int64: the chosen experts, in rank order
    top: torch.Tensor
    #: ``(..., S, k)`` bool: the choice got a slot
    kept: torch.Tensor
    #: ``(..., S, E)`` float32: the router's probabilities
    probs: torch.Tensor
    #: ``(...)`` float32: the group's Switch loss
    aux: torch.Tensor


def _top_k(probs, k: int):
    """``lax.top_k``'s choice: the k largest, in order, a tie to the
    lower index (``argmax`` takes the first maximum)."""
    picks, p = [], probs.detach()
    experts = torch.arange(p.shape[-1], device=p.device)
    for r in range(k):
        i = p.argmax(dim=-1)
        picks.append(i)
        if r < k - 1:
            p = p.masked_fill(i[..., None] == experts, -math.inf)
    top = torch.stack(picks, dim=-1)
    return top, probs.gather(-1, top)


def route_topk(x_flat, w_router, capacity: int, k: int = 1) -> Routes:
    """Top-k routing of token groups: ``x_flat (..., S, D)`` -> :class:`Routes`.

    Router logits ``x @ w_router`` in the input's type, then float32;
    ``k = 1`` is Switch (gate = the top probability), ``k >= 2`` GShard
    (the top-k renormalised). Slots fill rank by rank (every rank-0
    choice before any rank-1 choice), a rank in token order; a choice
    past its expert's capacity is dropped at that rank only. The
    router's gradient flows through the gates and the loss's mean
    probability, as in the JAX package."""
    E = w_router.shape[-1]
    probs = torch.softmax((x_flat @ w_router).float(), dim=-1)
    top, top_p = _top_k(probs, k)
    gates = top_p if k == 1 else top_p / top_p.sum(dim=-1, keepdim=True)
    experts = torch.arange(E, device=probs.device)[:, None]
    filled = torch.zeros(probs.shape[:-2] + (E, 1), dtype=torch.int64, device=probs.device)
    slots, kept = [], []
    for r in range(k):
        choice = top[..., r]  # (..., S)
        # (..., E, S): the running count is a scan along the last dim; a
        # scan down the token dim of (..., S, E) runs only E columns wide
        # (on an H100 it took most of a 16,384-token step).
        onehot = (choice[..., None, :] == experts).long()
        # Position in the expert's buffer: earlier ranks' fill plus this
        # rank's running count.
        pos = (onehot.cumsum(dim=-1) - 1 + filled).gather(-2, choice[..., None, :])[..., 0, :]
        keep = pos < capacity
        slots.append(torch.where(keep, choice * capacity + pos, E * capacity))
        kept.append(keep)
        filled = filled + (onehot * keep[..., None, :]).sum(dim=-1, keepdim=True)
        if r == 0:
            # Switch load balance over rank-0 choices: E * sum_e f_e * p_e.
            frac = onehot.float().mean(dim=-1)
    kept_ = torch.stack(kept, dim=-1)
    aux = E * (frac * probs.mean(dim=-2)).sum(dim=-1)
    return Routes(torch.stack(slots, dim=-1), gates * kept_, top, kept_, probs, aux)


def route_top1(x_flat, w_router, capacity: int) -> Routes:
    """Switch top-1 routing (see :func:`route_topk`)."""
    return route_topk(x_flat, w_router, capacity, k=1)


def routes_to_onehot(routes: Routes, n_experts: int, capacity: int):
    """The JAX package's ``(dispatch, combine)``, each ``(..., S, E, C)``
    float32, from :class:`Routes`: for tests at small sizes (the main
    path never builds them)."""
    E, C = n_experts, capacity
    rows = F.one_hot(routes.slot, E * C + 1)[..., : E * C].float()  # (..., S, k, E*C)
    shape = routes.slot.shape[:-1] + (E, C)
    return (rows.sum(dim=-2).reshape(shape),
            (rows * routes.gate[..., None]).sum(dim=-2).reshape(shape))


def dispatch(x, routes: Routes, n_experts: int, capacity: int):
    """The expert buffers ``(..., E, C, D)`` of token groups ``x (..., S,
    D)``: each kept choice's token written to its slot, zeros elsewhere
    (bit for bit the JAX one-hot product). The dropped choices all land
    in the dump row ``E * C``, which is cut off. Written, not gathered:
    the backward reads each choice's slot (a gather), where a gather's
    backward would add every empty slot's gradient into one shared zero
    row, bf16 atomics on one address."""
    *lead, S, D = x.shape
    E, C = n_experts, capacity
    k = routes.slot.shape[-1]
    G = math.prod(lead)
    rows = x.reshape(G, S, 1, D).expand(G, S, k, D).reshape(G * S * k, D)
    base = torch.arange(G, device=x.device)[:, None] * (E * C + 1)
    index = (routes.slot.reshape(G, S * k) + base).reshape(-1)
    buf = x.new_zeros((G * (E * C + 1), D)).index_put((index,), rows)
    return buf.reshape(G, E * C + 1, D)[:, : E * C].reshape(*lead, E, C, D)


def combine(out, routes: Routes):
    """``out (..., E, C, D)`` back to the tokens: ``(..., S, D)`` float32,
    a token's gate-weighted expert rows added in rank order (a dropped
    choice reads the zero dump row with gate 0)."""
    *lead, E, C, D = out.shape
    S, k = routes.slot.shape[-2:]
    flat = torch.cat([out.reshape(*lead, E * C, D).float(),
                      out.new_zeros((*lead, 1, D), dtype=torch.float32)], dim=-2)
    y = None
    for r in range(k):
        rows = flat.gather(-2, routes.slot[..., r, None].expand(*lead, S, D))
        term = routes.gate[..., r, None] * rows
        y = term if y is None else y + term
    return y


def expert_bank(w_up, b_up, w_down, b_down, buf):
    """An expert bank on its buffers: ``buf (E, R, D) -> (E, R, D)``,
    tanh GELU between the two ``torch.bmm`` s."""
    h = F.gelu(torch.bmm(buf, w_up) + b_up[:, None, :], approximate="tanh")
    return torch.bmm(h, w_down) + b_down[:, None, :]


# ---------------------------------------------------------------------------
# The route log (off unless a check turns it on)
# ---------------------------------------------------------------------------


class RouteLog:
    """Every forward's routes while on: ``entries[(layer, first_group)] =
    (top, kept, probs)``, each ``(G, S, ...)`` for the ``G`` routing
    groups of one call. ``first_group`` numbers the groups as the single
    program's oracle does (row-block-major, then seq block): the ``n``-th
    call of a layer covers groups ``n * G .. n * G + G - 1``, which holds
    on every path because each issues a layer's calls microbatch by
    microbatch, data replica by data replica. The recompute of a remat
    block (:func:`_maybe_remat`) is not recorded."""

    def __init__(self):
        self.entries: dict = {}
        self.layer = 0
        self._calls: dict = {}

    def record(self, top, kept, probs) -> None:
        n = self._calls.get(self.layer, 0)
        self._calls[self.layer] = n + 1
        G = top.shape[0]
        self.entries[(self.layer, n * G)] = (top.detach(), kept.detach(), probs.detach())

    def layers(self) -> dict:
        """``{layer: (top, kept, probs)}``, each call's groups concatenated
        in group order (on the first entry's device)."""
        out = {}
        for layer in sorted({l for l, _ in self.entries}):
            parts = [self.entries[k] for k in sorted(k for k in self.entries if k[0] == layer)]
            dev = parts[0][0].device
            out[layer] = tuple(torch.cat([p[j].to(dev) for p in parts]) for j in range(3))
        return out


_ROUTE_LOG: contextvars.ContextVar = contextvars.ContextVar("route_log", default=None)
_RECOMPUTING: contextvars.ContextVar = contextvars.ContextVar("recomputing", default=False)


@contextlib.contextmanager
def recording_routes(log: RouteLog):
    """Record the routes of the forwards run inside the block in ``log``
    (this thread's only)."""
    token = _ROUTE_LOG.set(log)
    try:
        yield log
    finally:
        _ROUTE_LOG.reset(token)


def _at_layer(layer: int) -> None:
    log = _ROUTE_LOG.get()
    if log is not None:
        log.layer = layer


def _maybe_remat(cfg, fn):
    """:func:`~tpu_dist_nn_torch.models.transformer.maybe_remat` of ``fn``
    whose reruns (the backward's recomputes, wherever autograd runs them)
    record no routes."""
    if not cfg.remat:
        return fn

    def run(*args):
        ran = []

        def body(*a):
            token = _RECOMPUTING.set(bool(ran))
            ran.append(True)
            try:
                return fn(*a)
            finally:
                _RECOMPUTING.reset(token)

        return maybe_remat(cfg, body)(*args)

    return run


def _log(routes: list[Routes], slots=()) -> None:
    """Record ``routes`` (shard ``i``'s made on ``slots[i]``'s stream) on
    the current stream, after each slot's."""
    log = _ROUTE_LOG.get()
    if log is None or _RECOMPUTING.get():
        return
    dev = routes[0].top.device
    if dev.type == "cuda":
        here = torch.cuda.current_stream(dev)
        for slot in slots:
            if slot.stream is not None:
                here.wait_stream(slot.stream)
        for r in routes:
            for t in (r.top, r.kept, r.probs):
                t.record_stream(here)
    log.record(*(torch.stack([getattr(r, f).reshape(-1, *getattr(r, f).shape[-2:]).to(dev)
                              for r in routes]).flatten(0, 1)
                 for f in ("top", "kept", "probs")))


# ---------------------------------------------------------------------------
# The single program (the grouped oracle)
# ---------------------------------------------------------------------------


def moe_ffn_apply(block: dict, x, cfg: MoEConfig, n_groups: int = 1, n_seq_groups: int = 1):
    """The routed FFN of one program: ``x (B, T, D) -> (y, aux)``.

    Routes within ``n_groups`` token groups: contiguous slices of the
    flattened ``(B, T)`` stream, or with ``n_seq_groups > 1`` the ``(batch
    slice x seq slice)`` blocks (row-major within), the grouping of the
    sequence-parallel paths. Each group fills its own ``(E, C, D)``
    buffer; the bank runs every group's buffers as one ``(E, G * C, D)``
    ``bmm``. ``aux`` is the mean of the groups' losses."""
    B, T, D = x.shape
    S = B * T
    G = n_groups * n_seq_groups
    if n_seq_groups == 1:
        if S % n_groups:
            raise ValueError(f"{S} tokens not divisible into {n_groups} groups")
        xg = x.reshape(n_groups, S // n_groups, D)
    else:
        if B % n_groups:
            raise ValueError(f"batch {B} not divisible into {n_groups} groups")
        if T % n_seq_groups:
            raise ValueError(f"seq {T} not divisible into {n_seq_groups} seq groups")
        xg = (x.reshape(n_groups, B // n_groups, n_seq_groups, T // n_seq_groups, D)
              .transpose(1, 2).reshape(G, S // G, D))
    E, C = cfg.n_experts, cfg.capacity(S // G)
    routes = route_topk(xg, block["w_router"], C, cfg.router_top_k)
    _log([routes])
    buf = dispatch(xg, routes, E, C)  # (G, E, C, D)
    out = expert_bank(block["w_up"], block["b_up"], block["w_down"], block["b_down"],
                      buf.transpose(0, 1).reshape(E, G * C, D))
    y = combine(out.reshape(E, G, C, D).transpose(0, 1), routes).to(x.dtype)
    if n_seq_groups == 1:
        y = y.reshape(B, T, D)
    else:
        y = (y.reshape(n_groups, n_seq_groups, B // n_groups, T // n_seq_groups, D)
             .transpose(1, 2).reshape(B, T, D))
    return y, routes.aux.mean()


def moe_block_apply(block: dict, x, cfg: MoEConfig, n_groups: int = 1,
                    attn_fn=dot_product_attention, ffn_fn=None):
    """One pre-LN residual MoE block (attention, then the routed FFN):
    ``(x, aux)``. ``ffn_fn(block, h) -> (y, aux)`` replaces
    :func:`moe_ffn_apply` (the grouped oracles of the sharded paths)."""
    x = attn_sublayer(block, x, cfg, attn_fn)
    h = layer_norm(x, block["ln2_g"], block["ln2_b"])
    y, aux = moe_ffn_apply(block, h, cfg, n_groups) if ffn_fn is None else ffn_fn(block, h)
    return x + y, aux


def moe_forward(params: dict, tokens, cfg: MoEConfig, n_groups: int = 1,
                attn_fn=dot_product_attention, ffn_fn=None):
    """The MoE LM: ``(B, T)`` tokens -> ``((B, T, V)`` logits, aux)``, the
    aux the mean over blocks; each block under remat when ``cfg.remat``."""
    params = cfg.cast_params(params)
    T = tokens.shape[-1]
    x = params["tok_embed"][tokens.long()] + params["pos_embed"][:T]
    apply = _maybe_remat(cfg, moe_block_apply)
    auxs = []
    for layer, block in enumerate(unstack_blocks(params["blocks"])):
        _at_layer(layer)
        x, aux = apply(block, x, cfg, n_groups, attn_fn, ffn_fn)
        auxs.append(aux)
    return unembed(params, x), torch.stack(auxs).mean()


def moe_lm_loss(params: dict, tokens, cfg: MoEConfig, n_groups: int = 1,
                attn_fn=dot_product_attention, ffn_fn=None):
    """Next-token CE + the weighted router loss (mean nats/token) on
    ``(B, T + 1)`` tokens."""
    logits, aux = moe_forward(params, tokens[:, :-1], cfg, n_groups, attn_fn, ffn_fn)
    return next_token_ce(logits, tokens[:, 1:]) + cfg.router_aux_weight * aux


# ---------------------------------------------------------------------------
# Expert-sharded layouts
# ---------------------------------------------------------------------------


def ep_shard_blocks(blocks: dict, n_ep: int) -> dict:
    """Expert leaves ``(L, E, ...) -> (n_ep, L, E/n_ep, ...)``; the others
    as they are."""
    E = blocks["w_up"].shape[1]
    if E % n_ep:
        raise ValueError(f"n_experts={E} not divisible by expert axis {n_ep}")
    return {k: (torch.movedim(v.reshape(v.shape[0], n_ep, E // n_ep, *v.shape[2:]), 1, 0)
                if k in EP_SHARDED else v) for k, v in blocks.items()}


def ep_unshard_blocks(staged: dict) -> dict:
    """Inverse of :func:`ep_shard_blocks`."""
    out = {}
    for k, v in staged.items():
        if k in EP_SHARDED:
            moved = torch.movedim(v, 0, 1)  # (L, n_ep, E/n_ep, ...)
            out[k] = moved.reshape(moved.shape[0], -1, *moved.shape[3:])
        else:
            out[k] = v
    return out


def shard_blocks_pp_ep(blocks: dict, num_stages: int, n_ep: int) -> dict:
    """Stacked MoE blocks -> the pipeline + expert layout: expert leaves
    ``(S, n_ep, L/S, E/n_ep, ...)``, the others ``(S, L/S, ...)``."""
    L = blocks["w_router"].shape[0]
    if L % num_stages:
        raise ValueError(f"n_layers={L} not divisible by num_stages={num_stages}")
    S = num_stages
    return {k: (v.reshape(n_ep, S, L // S, *v.shape[2:]).transpose(0, 1) if k in EP_SHARDED
                else v.reshape(S, L // S, *v.shape[1:]))
            for k, v in ep_shard_blocks(blocks, n_ep).items()}


def unshard_blocks_pp_ep(staged: dict) -> dict:
    """Inverse of :func:`shard_blocks_pp_ep`."""
    ep = {}
    for k, v in staged.items():
        if k in EP_SHARDED:  # (S, n_ep, L/S, ...) -> (n_ep, L, ...)
            r = v.transpose(0, 1)
            ep[k] = r.reshape(r.shape[0], -1, *r.shape[3:])
        else:
            ep[k] = v.reshape(-1, *v.shape[2:])
    return ep_unshard_blocks(ep)


def shard_blocks_interleaved_ep(blocks: dict, num_stages: int, num_virtual: int,
                                n_ep: int) -> dict:
    """Stacked MoE blocks -> the interleaved chunk layout with expert
    shards: expert leaves ``(S, v, n_ep, L/V, E/n_ep, ...)``, the others
    ``(S, v, L/V, ...)`` (also zb's)."""
    from tpu_dist_nn_torch.parallel.transformer_pipeline import _chunk_regroup

    S, v = num_stages, num_virtual
    L = blocks["w_router"].shape[0]
    if L % (S * v):
        raise ValueError(f"n_layers={L} not divisible by S*v={S * v}")
    return {k: (torch.movedim(torch.stack([_chunk_regroup(a, S, v) for a in val]), 0, 2)
                if k in EP_SHARDED else _chunk_regroup(val, S, v))
            for k, val in ep_shard_blocks(blocks, n_ep).items()}


def unshard_blocks_interleaved_ep(staged: dict) -> dict:
    """Inverse of :func:`shard_blocks_interleaved_ep`."""
    from tpu_dist_nn_torch.parallel.transformer_pipeline import _chunk_ungroup

    return ep_unshard_blocks({k: (torch.stack([_chunk_ungroup(a) for a in torch.movedim(val, 2, 0)])
                                  if k in EP_SHARDED else _chunk_ungroup(val))
                              for k, val in staged.items()})


def shard_blocks_vshape_ep(blocks: dict, num_stages: int, n_ep: int) -> dict:
    """The V-shape chunk layout (zb-v) with expert shards: expert leaves
    ``(S, 2, n_ep, L/(2S), E/n_ep, ...)``, the others ``(S, 2, L/(2S),
    ...)``."""
    from tpu_dist_nn_torch.parallel.transformer_pipeline import _vshape_regroup

    return {k: (torch.movedim(torch.stack([_vshape_regroup(a, num_stages) for a in val]), 0, 2)
                if k in EP_SHARDED else _vshape_regroup(val, num_stages))
            for k, val in ep_shard_blocks(blocks, n_ep).items()}


def unshard_blocks_vshape_ep(staged: dict) -> dict:
    """Inverse of :func:`shard_blocks_vshape_ep`."""
    from tpu_dist_nn_torch.parallel.transformer_pipeline import _vshape_ungroup

    return ep_unshard_blocks({k: (torch.stack([_vshape_ungroup(a) for a in torch.movedim(val, 2, 0)])
                                  if k in EP_SHARDED else _vshape_ungroup(val))
                              for k, val in staged.items()})


# ---------------------------------------------------------------------------
# A cell's shards: attention on each shard's rows, experts over its slots
# ---------------------------------------------------------------------------


def _here(slot: StageSlot, t):
    """``t`` (valid on the stream ``slot``'s stream has waited for) read
    on ``slot``'s stream."""
    return t.to(slot.device) if slot.stream is None else _receive(slot, t)


def _bank_fn(cells, tp: bool):
    """``fn(i, block, buf)``: shard ``i``'s local expert bank on the
    buffer it received (on its lead's stream), Megatron-split over its
    model slots ``cells[i]`` when ``tp``."""
    if not tp:
        def bank(i, block, buf):
            return expert_bank(block["w_up"], block["b_up"], block["w_down"], block["b_down"], buf)
        return bank

    def megatron(i, block, buf):
        slots = cells[i]
        cols = block["w_up"].shape[-1] // len(slots)
        parts = []
        for m, (slot, b) in enumerate(zip(slots, fan_out(buf, slots))):
            f = slice(m * cols, (m + 1) * cols)
            with on_slot(slot):
                h = F.gelu(torch.bmm(b, _here(slot, block["w_up"][..., f]))
                           + _here(slot, block["b_up"][:, f])[:, None, :], approximate="tanh")
                parts.append(torch.bmm(h, _here(slot, block["w_down"][:, f])))
        return psum(parts, slots) + block["b_down"][:, None, :]

    return megatron


def _route_shards(blocks, hs, cfg: MoEConfig, slots) -> list[Routes]:
    """Each shard's routing of its own token group, on its slot."""
    routes = []
    for slot, block, h in zip(slots, blocks, hs):
        with on_slot(slot):
            S = h.shape[0] * h.shape[1]
            routes.append(route_topk(h.reshape(S, -1), block["w_router"], cfg.capacity(S),
                                     cfg.router_top_k))
    return routes


def _ep_ffn(blocks, hs, cfg: MoEConfig, cells, n_seq: int, bank):
    """The sharded routed FFN: ``hs[i] (b, T, D)`` on shard ``i``'s lead
    (shards ``(x, q)``, ``i = x * n_seq + q``). Each shard routes its
    group and fills its ``(E, C, D)`` buffers; for each seq shard ``q``
    the buffers of its expert shards are exchanged (``all_to_all`` split
    0, concat 1: shard ``x`` gets ``(E/n_ep, n_ep * C, D)``, its experts'
    slots of every shard), run through ``bank`` and sent back (split 1,
    concat 0). Returns the outputs and each shard's router loss."""
    slots = [cell[0] for cell in cells]
    X, E = len(hs) // n_seq, cfg.n_experts
    routes = _route_shards(blocks, hs, cfg, slots)
    _log(routes, slots)
    bufs = []
    for slot, h, r in zip(slots, hs, routes):
        with on_slot(slot):
            S = h.shape[0] * h.shape[1]
            bufs.append(dispatch(h.reshape(S, -1), r, E, cfg.capacity(S)))
    outs = [None] * len(hs)
    for q in range(n_seq):
        idx = [x * n_seq + q for x in range(X)]
        group = [slots[i] for i in idx]
        got = all_to_all([bufs[i] for i in idx], group, split_dim=0, concat_dim=1)
        done = []
        for i, buf in zip(idx, got):
            with on_slot(slots[i]):
                done.append(bank(i, blocks[i], buf))
        for i, out in zip(idx, all_to_all(done, group, split_dim=1, concat_dim=0)):
            outs[i] = out
    ys = []
    for slot, h, r, out in zip(slots, hs, routes, outs):
        with on_slot(slot):
            ys.append(combine(out, r).to(h.dtype).reshape(h.shape))
    return ys, [r.aux for r in routes]


def ep_block_apply(blocks, xs, cfg: MoEConfig, cells, attn, n_seq: int = 1, bank=None):
    """One MoE block over a cell's shards: ``xs[i] (b, T, D)`` on shard
    ``i``'s lead ``cells[i][0]`` with its unstacked leaves ``blocks[i]``
    (its expert shard's experts). Attention runs on each shard (``attn``
    the causal attention entry), or with ``n_seq > 1`` across the seq
    shards of each expert shard (``attn`` a ring or Ulysses function);
    then the routed FFN (:func:`_ep_ffn`, ``bank`` the local expert
    bank). Every slot waits for the caller's stream first, and the
    caller for every slot at the end. Returns ``(ys, auxes)``."""
    H, Dh = cfg.n_heads, cfg.head_dim
    flat = [slot for cell in cells for slot in cell]
    slots = [cell[0] for cell in cells]
    caller = fork(flat)
    if n_seq == 1:
        ys = []
        for slot, block, x in zip(slots, blocks, xs):
            with on_slot(slot):
                ys.append(attn_sublayer(block, x, cfg, attn))
    else:
        qkv = []
        for slot, block, x in zip(slots, blocks, xs):
            with on_slot(slot):
                B, T, _ = x.shape
                h = layer_norm(x, block["ln1_g"], block["ln1_b"])
                qkv.append((h @ block["w_qkv"] + block["b_qkv"]).reshape(B, T, 3 * H, Dh)
                           .split(H, 2))
        os_ = [None] * len(xs)
        for x0 in range(0, len(xs), n_seq):
            idx = range(x0, x0 + n_seq)
            got = attn(*([qkv[i][j] for i in idx] for j in range(3)), [slots[i] for i in idx],
                       causal=cfg.causal)
            for i, o in zip(idx, got):
                os_[i] = o
        ys = []
        for slot, block, x, o in zip(slots, blocks, xs, os_):
            with on_slot(slot):
                ys.append(x + o.reshape(x.shape) @ block["w_o"] + block["b_o"])
    hs = []
    for slot, block, y in zip(slots, blocks, ys):
        with on_slot(slot):
            hs.append(layer_norm(y, block["ln2_g"], block["ln2_b"]))
    outs, auxes = _ep_ffn(blocks, hs, cfg, cells, n_seq, bank or _bank_fn(cells, False))
    res = []
    for slot, y, o in zip(slots, ys, outs):
        with on_slot(slot):
            res.append(y + o)
    join(caller, flat)
    return tuple(res), tuple(auxes)


def _shards_fn(cfg: MoEConfig, leaves, cells, attn, *, n_seq: int = 1, tp: bool = False,
               top=None, first_layer: int = 0, aux_scale: float = 1.0):
    """``fn(xs) -> (ys, aux)``: a block group over a cell's shards.

    ``leaves[i]``: shard ``i``'s stacked ``(Lg, ...)`` block leaves;
    ``cells[i]``: its model slots, lead first. ``top``: the embedding,
    when the group is first (``xs`` token ids, each shard embedded at its
    global positions, ``(i % n_seq) * T_local``). Each slot casts its
    leaves on its own stream. ``aux``: the sum over shards of the mean
    over the group's blocks of the shard's router loss, times
    ``aux_scale``, on the cell's lead. A single slot's tensor (no tuple)
    goes in and comes out as it is."""
    slots = [cell[0] for cell in cells]
    lead = slots[0]
    bank = _bank_fn(cells, tp)

    def fn(xs):
        single = not isinstance(xs, tuple)
        xs = (xs,) if single else xs
        here = []
        for slot, lv in zip(slots, leaves):
            if slot is not lead and slot.stream is not None:
                slot.stream.wait_stream(lead.stream)
            with on_slot(slot):
                here.append(cfg.cast_params({k: a.to(slot.device) for k, a in lv.items()}))
        if top is not None:
            Tl, emb = xs[0].shape[-1], []
            for i, (slot, x) in enumerate(zip(slots, xs)):
                with on_slot(slot):
                    emb.append(embed_at(cfg.cast_params(
                        {k: top[k].to(slot.device) for k in ("tok_embed", "pos_embed")}),
                        x, (i % n_seq) * Tl))
            xs = tuple(emb)
        apply = _maybe_remat(cfg, ep_block_apply)
        layers = list(zip(*(unstack_blocks(h) for h in here)))
        sums = None
        for j, layer in enumerate(layers):
            _at_layer(first_layer + j)
            xs, auxes = apply(list(layer), xs, cfg, cells, attn, n_seq, bank)
            if sums is None:
                sums = list(auxes)
            else:
                for i, slot in enumerate(slots):
                    with on_slot(slot):
                        sums[i] = sums[i] + auxes[i]
        parts = []
        for slot, s_ in zip(slots, sums):
            with on_slot(slot):
                parts.append(s_ / len(layers))
        aux = psum(parts, slots) * aux_scale
        return (xs[0] if single else xs), aux

    return fn


def _check_experts(cfg: MoEConfig, n_ep: int) -> None:
    if cfg.n_experts % n_ep:
        raise ValueError(f"n_experts={cfg.n_experts} not divisible by expert axis {n_ep}")


def _shard_rows(rows, X: int, Q: int) -> tuple:
    """A replica's rows -> its shards ``(x, q)``, expert-major: rows
    split over ``X``, each over ``Q`` position blocks."""
    return tuple(c for r in rows.chunk(X, dim=0) for c in r.chunk(Q, dim=1))


def _cat_shards(shards, X: int, Q: int):
    """Inverse of :func:`_shard_rows`."""
    return torch.cat([torch.cat(shards[x * Q:(x + 1) * Q], dim=1) for x in range(X)], dim=0)


def _flat_leaves(blocks: dict, X: int, Q: int) -> list[dict]:
    """Each shard's stacked leaves from the :func:`ep_shard_blocks`
    layout (views)."""
    return [{k: (v[x] if k in EP_SHARDED else v) for k, v in blocks.items()}
            for x in range(X) for _ in range(Q)]


def _flat_run(mesh: Mesh, cfg: MoEConfig, params, inputs, attn, *, n_seq: int, tp: bool):
    """The flat (stage 1) MoE LM over every data replica's shards:
    ``(logits, aux)``, the logits ``(B, T, V)`` on the params' device and
    ``aux`` the mean over shards and blocks of the router loss."""
    D, X, Q = mesh.shape[AXIS_DATA], mesh.shape[AXIS_EXPERT], n_seq
    home = params["tok_embed"].device
    leaves = _flat_leaves(params["blocks"], X, Q)
    ready = caller_event(inputs)
    results = []
    for d, rows in enumerate(inputs.chunk(D, dim=0)):
        cells = mesh.shard_model_slots(0, d)
        body = _shards_fn(cfg, leaves, cells, attn, n_seq=Q, tp=tp, top=params)

        def run(xs, body=body, cells=cells):
            ys, aux = body(xs)
            logits = []
            for cell, y in zip(cells, ys):
                with on_slot(cell[0]):
                    logits.append(unembed(cfg.cast_params(
                        {k: params[k].to(cell[0].device) for k in _TAIL}), y))
            return tuple(logits), aux

        results.append(launch(mesh.shards(0, d), run, _shard_rows(rows, X, Q), ready))
    logits = [_cat_shards(gather([(y, ev) for y in ys], home), X, Q)
              for (ys, _), ev in results]
    aux = torch.stack(gather([(a, ev) for (_, a), ev in results], home)).sum()
    return torch.cat(logits, dim=0), aux / (D * X * Q)


def make_ep_lm_forward(mesh: Mesh, cfg: MoEConfig, attn_fn=None, with_loss: bool = False):
    """-> ``fn(params_ep, tokens)`` with the experts over the mesh's
    expert slots (stage 1): the batch over ``(data, expert)``, each
    shard's attention on its slot, each MoE layer's buffers exchanged
    over the data replica's expert slots. ``params_ep["blocks"]`` from
    :func:`ep_shard_blocks`. Returns the logits, or with ``with_loss``
    the CE (the mean of the shards' means) plus the weighted router
    loss on ``(B, T + 1)`` tokens: the grouped single program with
    ``n_groups = data * expert``. ``attn_fn``: the attention entry
    (default: the flash kernels on a card)."""
    X, D = mesh.shape[AXIS_EXPERT], mesh.shape[AXIS_DATA]
    _check_experts(cfg, X)
    n_shards = D * X

    def forward(params_ep, tokens):
        B = tokens.shape[0]
        if B % n_shards:
            raise ValueError(f"batch {B} not divisible by data*expert shards {n_shards}")
        attn = attn_fn or default_attn_fn()
        inputs = tokens[:, :-1] if with_loss else tokens
        logits, aux = _flat_run(mesh, cfg, params_ep, inputs, attn, n_seq=1, tp=False)
        if not with_loss:
            return logits
        targets = tokens[:, 1:]
        ce = torch.stack([next_token_ce(lg, tg) for lg, tg in
                          zip(logits.chunk(n_shards), targets.chunk(n_shards))]).mean()
        return ce + cfg.router_aux_weight * aux

    return forward


def make_ep_tp_lm_loss(mesh: Mesh, cfg: MoEConfig, attn_fn=None):
    """-> ``loss_fn(params_ep, tokens)``: the experts over the expert
    slots AND each expert's FFN Megatron-split over the model slots of
    its shard (column-parallel ``w_up`` / ``b_up``, row-parallel
    ``w_down``, one psum, ``b_down`` after it); routing, attention and
    the rest once on each shard's lead. :func:`ep_shard_blocks` layout
    (the model split is a view of the F columns). The flat EP loss up
    to the psum's rounding."""
    X, N, D = mesh.shape[AXIS_EXPERT], mesh.shape[AXIS_MODEL], mesh.shape[AXIS_DATA]
    _check_experts(cfg, X)
    if cfg.d_ff % N:
        raise ValueError(f"d_ff={cfg.d_ff} not divisible by model axis {N} "
                         "(TP-inside-experts shards the FF dim)")
    n_shards = D * X

    def loss_fn(params_ep, tokens):
        B = tokens.shape[0]
        if B % n_shards:
            raise ValueError(f"batch {B} not divisible by data*expert shards {n_shards}")
        logits, aux = _flat_run(mesh, cfg, params_ep, tokens[:, :-1], attn_fn or default_attn_fn(),
                                n_seq=1, tp=True)
        ce = torch.stack([next_token_ce(lg, tg) for lg, tg in
                          zip(logits.chunk(n_shards), tokens[:, 1:].chunk(n_shards))]).mean()
        return ce + cfg.router_aux_weight * aux

    return loss_fn


def make_sp_ep_lm_loss(mesh: Mesh, cfg: MoEConfig, mode: str = "ring", attn_fn=None):
    """-> ``loss_fn(params_ep, tokens)``: long-context MoE, sequence x
    expert parallelism on a ``(seq, expert, data)`` grid. Each ``(data,
    expert, seq)`` shard embeds its block of rows and positions at their
    global positions; attention runs the ring or Ulysses decomposition
    over the seq slots of each expert shard (``attn_fn``: Ulysses' local
    attention), and each shard routes its own ``(batch slice x seq
    slice)`` block and exchanges over the expert slots of its seq shard.
    Tokens are full (input + target) rows under the masked CE: the
    grouped single program with ``n_groups = data * expert`` and
    ``n_seq_groups = seq``. :func:`ep_shard_blocks` layout."""
    X, Q, D = mesh.shape[AXIS_EXPERT], mesh.shape[AXIS_SEQ], mesh.shape[AXIS_DATA]
    _check_experts(cfg, X)
    sp_attn = _sp_attn_fn(mode, attn_fn=attn_fn)
    n_shards = D * X

    def loss_fn(params_ep, tokens):
        B, T = tokens.shape
        if B % n_shards:
            raise ValueError(f"batch {B} not divisible by data*expert shards {n_shards}")
        check_sp_rows(cfg, T, Q, " (sp feeds full input+target rows)", "")
        logits, aux = _flat_run(mesh, cfg, params_ep, tokens, sp_attn, n_seq=Q, tp=False)
        return masked_next_token_ce(logits, tokens) + cfg.router_aux_weight * aux

    return loss_fn


# ---------------------------------------------------------------------------
# MoE through the pipeline
# ---------------------------------------------------------------------------


class _EPLayout:
    """Where chunk ``c``'s leaves for expert shard ``x`` sit in a staged
    block dict: ``(dev(c), c // S)`` on the chunked layouts, ``(c,)`` on
    the per-stage one, then ``x`` on the expert leaves."""

    def __init__(self, num_stages: int, num_virtual: int, interleaved: bool, dev=None):
        self.S, self.v, self.interleaved = num_stages, num_virtual, interleaved
        self.dev = dev or (lambda c: c % num_stages)

    @property
    def num_chunks(self) -> int:
        return self.S * self.v

    def index(self, key: str, c: int, x: int) -> tuple:
        idx = (self.dev(c), c // self.S) if self.interleaved else (c,)
        return idx + (x,) if key in EP_SHARDED else idx

    def views(self, blocks: dict, X: int, Q: int, leaf) -> list[list[dict]]:
        """``views[c][i]``: chunk ``c``'s stacked leaves for shard ``i =
        x * Q + q``, each ``leaf(key, index)``."""
        return [[{k: leaf(k, self.index(k, c, x)) for k in blocks}
                 for x in range(X) for _ in range(Q)] for c in range(self.num_chunks)]


def _pp_checks(mesh: Mesh, cfg: MoEConfig, num_stages: int | None) -> None:
    _check_experts(cfg, mesh.shape[AXIS_EXPERT])
    if num_stages is not None and mesh.shape[AXIS_STAGE] != num_stages:
        raise ValueError(f"num_stages={num_stages} but the mesh '{AXIS_STAGE}' axis has size "
                         f"{mesh.shape[AXIS_STAGE]}")


def _check_pp_batch(B: int, M: int, n_shards: int) -> None:
    if B % (M * n_shards):
        raise ValueError(f"batch {B} not divisible by microbatches*data*expert "
                         f"shards = {M * n_shards}")


def _pipeline_ep_loss(mesh: Mesh, cfg: MoEConfig, num_stages: int, num_microbatches: int,
                      attn_fn, sp_mode):
    from tpu_dist_nn_torch.parallel.transformer_pipeline import _microbatches

    _pp_checks(mesh, cfg, num_stages)
    S, M = num_stages, num_microbatches
    D, X = mesh.shape[AXIS_DATA], mesh.shape[AXIS_EXPERT]
    Q = mesh.shape[AXIS_SEQ] if sp_mode is not None else 1
    n_shards = D * X
    layout = _EPLayout(S, 1, False)

    def loss_fn(params, tokens):
        if sp_mode is None:
            inp, attn = tokens[:, :-1], attn_fn or default_attn_fn()
        else:
            inp, attn = tokens, _sp_attn_fn(sp_mode, attn_fn=attn_fn)
            check_sp_rows(cfg, tokens.shape[1], Q, " (sp feeds full input+target rows)", "")
        _check_pp_batch(inp.shape[0], M, n_shards)
        blocks = params["blocks"]
        Lc = blocks["w_router"].shape[1]
        views = layout.views(blocks, X, Q, lambda k, i: blocks[k][i])
        fns = [[_shards_fn(cfg, views[s], mesh.shard_model_slots(s, d), attn, n_seq=Q,
                           top=params if s == 0 else None, first_layer=s * Lc)
                for s in range(S)] for d in range(D)]
        xs = [[_one_or_shards(r, X, Q) for r in row] for row in _microbatches(inp, M, D)]
        home = params["tok_embed"].device
        outs, auxes = gpipe_forward(mesh, fns, xs, caller_event(tokens), with_aux=True)
        ys = []
        for row in outs:
            for y, ev in row:
                ys.append(_cat_shards(gather([(t, ev) for t in _as_tuple(y)], home), X, Q))
        logits = unembed(cfg.cast_params({k: params[k] for k in _TOP}), torch.cat(ys, dim=0))
        ce = (next_token_ce(logits, tokens[:, 1:]) if sp_mode is None
              else masked_next_token_ce(logits, tokens))
        aux = torch.stack(gather(auxes, home)).sum() / (S * M * n_shards * Q)
        return ce + cfg.router_aux_weight * aux

    return loss_fn


def _as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _one_or_shards(rows, X: int, Q: int):
    """A replica's microbatch rows as its shards, or as they are where
    the cell has one slot (no expert or seq shards)."""
    return rows if X * Q == 1 else _shard_rows(rows, X, Q)


def make_pipeline_ep_lm_loss(mesh: Mesh, cfg: MoEConfig, num_stages: int,
                             num_microbatches: int, attn_fn=None):
    """-> ``loss_fn(params, tokens)``: MoE blocks pipelined over the stage
    slots (GPipe), the experts over each stage's expert slots, the batch
    over ``(data, expert)``. The router losses ride the forward's aux
    channel (:func:`~tpu_dist_nn_torch.parallel.gpipe.gpipe_forward`),
    their sum over (stage, microbatch, shard) divided by ``S * M *
    shards``: the grouped single program with ``n_groups = M * data *
    expert``. ``params["blocks"]`` in :func:`shard_blocks_pp_ep` layout;
    ``tokens (B, T + 1)``."""
    return _pipeline_ep_loss(mesh, cfg, num_stages, num_microbatches, attn_fn, None)


def make_pipeline_sp_ep_lm_loss(mesh: Mesh, cfg: MoEConfig, num_stages: int,
                                num_microbatches: int, mode: str = "ring", attn_fn=None):
    """-> ``loss_fn(params, tokens)``: pipeline x sequence x expert
    parallelism (GPipe): each microbatch's shards ``(expert, seq)`` on a
    stage's slots, ring or Ulysses attention across the seq slots, the
    experts exchanged across the expert slots. Full rows under the
    masked CE; the router losses' sum over (stage, microbatch, shard)
    divided by ``S * M * data * expert * seq``: the grouped single
    program with ``n_groups = M * data * expert`` and ``n_seq_groups =
    seq``. :func:`shard_blocks_pp_ep` layout."""
    return _pipeline_ep_loss(mesh, cfg, num_stages, num_microbatches, attn_fn, mode)


def _moe_scheduled_grad(mesh: Mesh, cfg: MoEConfig, schedule: str, num_virtual: int,
                        num_microbatches: int, attn_fn, *, interleaved: bool, tables=None,
                        sp_mode=None):
    """``f(params, tokens) -> (loss, grads)`` through
    :func:`~tpu_dist_nn_torch.parallel.one_f_one_b.run_schedule` in
    ``schedule``'s op order (``tables`` in place of its default ones),
    the chunks' router losses on its aux channel pre-scaled by
    ``router_aux_weight / (chunks * M * shards)``. ``tokens (B, T + 1)``,
    or with ``sp_mode`` full rows under the masked CE."""
    from tpu_dist_nn_torch.parallel.transformer_pipeline import (
        _microbatches,
        _on_device,
        _sp_masked_tail,
        _sp_prep,
    )

    _pp_checks(mesh, cfg, None)
    S, D, M = mesh.shape[AXIS_STAGE], mesh.shape[AXIS_DATA], num_microbatches
    X = mesh.shape[AXIS_EXPERT]
    Q = mesh.shape[AXIS_SEQ] if sp_mode is not None else 1
    n_shards = D * X
    if tables is None:
        tables = schedule_tables(schedule, S, num_virtual, M)
    if tables is None:  # gpipe, 1f1b: chunk c on slot c
        order, dev = training_order(schedule, S, num_virtual, M), None
    else:
        order, dev = table_order(tables), tables.dev_of_chunk
    layout = _EPLayout(S, num_virtual, interleaved, dev)
    V = layout.num_chunks
    scale = cfg.router_aux_weight / (V * M * n_shards * Q)

    def value_and_grad(params, tokens):
        attn = (attn_fn or default_attn_fn() if sp_mode is None
                else _sp_attn_fn(sp_mode, in_schedule=True, attn_fn=attn_fn))
        blocks = params["blocks"]
        Lc = blocks["w_router"].shape[2 if interleaved else 1]
        leaves: dict = {}

        def leaf(k, idx):
            if (k, idx) not in leaves:
                leaves[(k, idx)] = blocks[k][idx].detach().requires_grad_()
            return leaves[(k, idx)]

        views = layout.views(blocks, X, Q, leaf)
        top = {k: params[k].detach().requires_grad_() for k in _TOP}
        fns = [[_shards_fn(cfg, views[c], mesh.shard_model_slots(layout.dev(c), d), attn,
                           n_seq=Q, top=top if c == 0 else None, first_layer=c * Lc,
                           aux_scale=scale)
                for c in range(V)] for d in range(D)]

        def ce_tail(ys, targets, _mask):
            """Each shard's CE mean over ``M * shards``, summed in shard
            order on the cell's lead."""
            ys, targets = _as_tuple(ys), _as_tuple(targets)
            dev0 = targets[0].device
            head = cfg.cast_params({k: top[k].to(dev0) for k in _TAIL})
            total = None
            for y, tgt in zip(ys, targets):
                part = next_token_ce(unembed(head, _on_device(y, dev0)), tgt) / (M * n_shards)
                total = part if total is None else total + part
            return total

        def sp_tail(ys, targets, masks):
            dev0 = targets[0].device
            head = cfg.cast_params({k: top[k].to(dev0) for k in _TAIL})
            total = None
            for y, tgt, mask in zip(ys, targets, masks):
                part = _sp_masked_tail(head, _on_device(y, dev0), tgt, mask)
                total = part if total is None else total + part
            return total

        def weights_of(c):
            own = [t for shard in views[c] for t in shard.values()]
            own += [top[k] for k in ("tok_embed", "pos_embed")] if c == 0 else []
            own += [top[k] for k in _TAIL] if c == V - 1 else []
            return list({id(t): t for t in own}.values())

        last = [mesh.shards(layout.dev(V - 1), d) for d in range(D)]

        def placed(rows_mb):
            return [[tuple(t.to(last[d][i].device)
                           for i, t in enumerate(_shard_rows(r, X, Q))) if X * Q > 1
                     else r.to(last[d][0].device) for d, r in enumerate(row)]
                    for row in _microbatches(rows_mb, M, D)]

        _check_pp_batch(tokens.shape[0], M, n_shards)
        if sp_mode is None:
            xs = [[_one_or_shards(r, X, Q) for r in row]
                  for row in _microbatches(tokens[:, :-1], M, D)]
            targets, masks, tail = placed(tokens[:, 1:]), [[None] * D] * M, ce_tail
        else:
            tgt, mask = _sp_prep(cfg, tokens, Q)
            xs = [[_one_or_shards(r, X, Q) for r in row] for row in _microbatches(tokens, M, D)]
            targets, masks, tail = placed(tgt), placed(mask), sp_tail
        weights = [weights_of(c) for c in range(V)]
        losses = run_schedule(mesh, fns, order, xs, targets, masks, tail=tail,
                              weights=[weights] * D, with_aux=True)
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


def make_pipeline_ep_lm_gpipe_grad(mesh: Mesh, cfg: MoEConfig, num_stages: int,
                                   num_microbatches: int, attn_fn=None):
    """-> ``f(params, tokens) -> (loss, grads)`` in the GPipe order (every
    forward, then every backward), the router losses pre-scaled on the
    aux channel: the gradient of :func:`make_pipeline_ep_lm_loss`, played
    op by op. :func:`shard_blocks_pp_ep` layout, grads in it too."""
    _pp_checks(mesh, cfg, num_stages)
    return _moe_scheduled_grad(mesh, cfg, "gpipe", 1, num_microbatches, attn_fn,
                               interleaved=False)


def make_pipeline_ep_lm_1f1b_grad(mesh: Mesh, cfg: MoEConfig, num_stages: int,
                                  num_microbatches: int, attn_fn=None):
    """-> ``f(params, tokens) -> (loss, grads)``: 1F1B x expert
    parallelism, each chunk's router loss pre-scaled by
    ``router_aux_weight / (S * M * shards)`` on the aux channel.
    :func:`shard_blocks_pp_ep` layout, grads in it too."""
    _pp_checks(mesh, cfg, num_stages)
    return _moe_scheduled_grad(mesh, cfg, "1f1b", 1, num_microbatches, attn_fn,
                               interleaved=False)


def make_pipeline_ep_lm_interleaved_grad(mesh: Mesh, cfg: MoEConfig, num_virtual: int,
                                         num_microbatches: int, attn_fn=None, tables=None):
    """Interleaved (virtual-stage) 1F1B x expert parallelism (or
    ``tables``: the zero-bubble ones, whose split backward sends the
    aux's input gradient through BWD_B and its weight gradient through
    BWD_W), each chunk's router loss pre-scaled by ``1 / (S * v * M *
    shards)``. :func:`shard_blocks_interleaved_ep` layout
    (:func:`shard_blocks_vshape_ep` for the V-shape tables)."""
    return _moe_scheduled_grad(mesh, cfg, "interleaved", num_virtual, num_microbatches, attn_fn,
                               interleaved=True, tables=tables)


def make_pipeline_ep_lm_zb_grad(mesh: Mesh, cfg: MoEConfig, num_virtual: int,
                                num_microbatches: int, attn_fn=None):
    """ZB-H1 x expert parallelism: the zero-bubble tables with MoE chunks
    and the aux channel. :func:`shard_blocks_interleaved_ep` layout."""
    tables = build_zero_bubble(mesh.shape[AXIS_STAGE], num_virtual, num_microbatches)
    return make_pipeline_ep_lm_interleaved_grad(mesh, cfg, num_virtual, num_microbatches,
                                                attn_fn, tables=tables)


def make_pipeline_ep_lm_zb_v_grad(mesh: Mesh, cfg: MoEConfig, num_microbatches: int,
                                  attn_fn=None):
    """ZB-V x expert parallelism: the V-placement zero-bubble tables with
    MoE chunks and the aux channel. :func:`shard_blocks_vshape_ep`
    layout."""
    tables = build_zb_v(mesh.shape[AXIS_STAGE], num_microbatches)
    return make_pipeline_ep_lm_interleaved_grad(mesh, cfg, 2, num_microbatches, attn_fn,
                                                tables=tables)


def make_pipeline_sp_ep_lm_gpipe_grad(mesh: Mesh, cfg: MoEConfig, num_stages: int,
                                      num_microbatches: int, mode: str = "ring", attn_fn=None):
    """-> ``f(params, tokens) -> (loss, grads)``: pipeline x sequence x
    expert parallelism in the GPipe order, the gradient of
    :func:`make_pipeline_sp_ep_lm_loss` played op by op (full rows).
    :func:`shard_blocks_pp_ep` layout."""
    _pp_checks(mesh, cfg, num_stages)
    return _moe_scheduled_grad(mesh, cfg, "gpipe", 1, num_microbatches, attn_fn,
                               interleaved=False, sp_mode=mode)
