"""Autoregressive decoding with a static KV cache: the byte-level LM's generation.

Port of :mod:`tpu_dist_nn.models.generate`, on one device:

* Prefill + decode: :func:`prefill` runs the prompt through the batched
  forward once (the materialised ``dot_product_attention``, as in the
  JAX package), filling an ``(L, B, max_len, H, Dh)`` cache zero-padded
  to ``max_len``; :func:`decode_step` then attends one query a row
  against the cache, written in place at a position held in a device
  tensor (``index_copy_``): a captured step reads it on every replay,
  where a Python int would be frozen into the graph.
* :func:`generate`: greedy at ``temperature == 0``, else the Gumbel-max
  form of ``jax.random.categorical`` over ``logits / temperature`` after
  top-k / top-p truncation; a row that emits ``eos_id`` is frozen. On a
  card the prefill and the first sample run once, then one decode step
  is captured as a CUDA graph
  (:class:`~tpu_dist_nn_torch.train.graphs.GraphedStep`) and replayed
  once a token with no host sync between replays; the CPU runs the same
  step eagerly. One :class:`GenerateProgram` (buffers and graph) is
  cached per configuration, as the JAX package caches one compiled
  program per configuration.
* Sampling noise: the JAX package splits its key once a call and scans
  over the keys. Here the Gumbel noise of all ``N`` draws, ``(N, B,
  V)`` float32, is drawn once a call from the caller's
  ``torch.Generator`` into a buffer that the step reads at its device
  step index: no generator state lives in the graph, and the graphed and
  the eager loop read the same draws.
* The slot cache under the continuous scheduler: :func:`init_slot_cache`,
  :func:`prefill_into_cache`, :func:`copy_cache_slot`,
  :func:`prefill_chunk_into_cache`, :func:`decode_blocks_slots`,
  :func:`decode_step_slots`. Slot, start and position indices are device
  tensors (or ints, moved to the device). The port updates a cache in
  place and returns it; the JAX functions return a new one.

Numerics: every attention over a cache (decode, slot decode, chunk
prefill) is one body, :func:`_attend_cache`, in the JAX cast order: q
and k in float32, divided by ``sqrt(Dh)``, keys past the frontier at
``-inf``, softmax in float32, cast to the compute type for the product
with v, over the cache's whole ``max_len`` key extent. A chunk prefill
computes all ``max_len`` rows of its slot whatever the chunk's length:
a matrix product's rows are not bit-stable across row counts (CPU BLAS
and cuBLAS pick their kernels by shape), so one shape per cache is what
keeps a prompt prefilled whole and in chunks bit-equal.
"""

from __future__ import annotations

import functools
import math
import threading
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from tpu_dist_nn_torch.models.transformer import (
    _COMPUTE_DTYPES,
    TransformerConfig,
    attn_sublayer,
    embed,
    ffn_sublayer,
    layer_norm,
    param_leaves,
    tree_map,
    unembed,
    unstack_blocks,
)
from tpu_dist_nn_torch.utils.device import resolve_device

_NEG = torch.finfo(torch.float32).min
_TINY = torch.finfo(torch.float32).tiny


def _index(i, device) -> torch.Tensor:
    """A position, slot or start as a ``(1,)`` int64 tensor on ``device``;
    a tensor already there is used as it is (no host read)."""
    if isinstance(i, torch.Tensor):
        return i.to(device=device, dtype=torch.long).reshape(1)
    return torch.tensor([int(i)], dtype=torch.long, device=device)


def _tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device).long()


def _device_of(params: dict) -> torch.device:
    return params["tok_embed"].device


@torch.no_grad()
def prefill_blocks(blocks: dict, x, cfg: TransformerConfig, max_len: int):
    """Run ``x (B, T, D)`` through a stacked block group, filling a
    ``max_len`` cache for those blocks: ``(x, {"k", "v"})`` with each
    ``(L, B, max_len, H, Dh)``, zero past ``T``."""
    ks, vs = [], []
    for block in unstack_blocks(blocks):
        y, k, v = attn_sublayer(block, x, cfg, return_kv=True)
        x = ffn_sublayer(block, y)
        ks.append(k)
        vs.append(v)
    pad = (0, 0, 0, 0, 0, max_len - x.shape[1])
    return x, {"k": F.pad(torch.stack(ks), pad), "v": F.pad(torch.stack(vs), pad)}


@torch.no_grad()
def prefill(params: dict, tokens, cfg: TransformerConfig, max_len: int):
    """Run the prompt ``(B, T)``, filling a ``max_len`` cache. Returns
    ``(logits (B, T, V), cache)``: the caller samples from ``logits[:,
    T - 1]`` and decodes from position ``T``."""
    params = cfg.cast_params(params)
    tokens = _tokens(tokens, _device_of(params))
    T = tokens.shape[1]
    if T > max_len:
        raise ValueError(f"prompt length {T} exceeds cache length {max_len}")
    x, cache = prefill_blocks(params["blocks"], embed(params, tokens), cfg, max_len)
    return unembed(params, x), cache


def _attend_cache(q, k_cache, v_cache, live):
    """``q (B, Tq, H, Dh)`` against a ``(B, M, H, Dh)`` cache; ``live``
    ``(B or 1, Tq, M)`` marks the keys each query sees. The one attention
    body of every cached path (module docstring)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(~live[:, None], -math.inf)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v_cache)


def _cached_layers(blocks: dict, cache: dict, x, cfg: TransformerConfig, write, live):
    """The block loop of the cached paths: each layer's k and v land in
    its cache layer through ``write(cache_layer, new)`` (in place), then
    the layer's queries attend over the cache."""
    B, Tq, D = x.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    for block, k_cache, v_cache in zip(unstack_blocks(blocks), cache["k"], cache["v"]):
        h = layer_norm(x, block["ln1_g"], block["ln1_b"])
        qkv = h @ block["w_qkv"] + block["b_qkv"]
        q, k, v = qkv.reshape(B, Tq, 3 * H, Dh).split(H, dim=2)
        write(k_cache, k)
        write(v_cache, v)
        o = _attend_cache(q, k_cache, v_cache, live).reshape(B, Tq, D)
        x = ffn_sublayer(block, x + o @ block["w_o"] + block["b_o"])
    return x


@torch.no_grad()
def decode_blocks(blocks: dict, cache: dict, pos, x, cfg: TransformerConfig):
    """One decode step through a stacked block group: ``x (B, 1, D)``
    attends against the group's cache, written at ``pos`` (in place).
    Positions past ``pos`` are masked. Returns ``(x, cache)``."""
    pos = _index(pos, x.device)
    live = (torch.arange(cache["k"].shape[2], device=x.device) <= pos)[None, None]

    def write(c, new):
        c.index_copy_(1, pos, new.to(c.dtype))

    return _cached_layers(blocks, cache, x, cfg, write, live), cache


@torch.no_grad()
def decode_step(params: dict, cache: dict, pos, token, cfg: TransformerConfig):
    """One decode step: ``token (B,)`` at position ``pos`` (an int or a
    device tensor). Returns ``(logits (B, V), cache)``, the cache
    updated at ``pos`` in place."""
    params = cfg.cast_params(params)
    dev = _device_of(params)
    pos = _index(pos, dev)
    x = (params["tok_embed"][_tokens(token, dev)][:, None, :]
         + params["pos_embed"].index_select(0, pos)[None])
    x, cache = decode_blocks(params["blocks"], cache, pos, x, cfg)
    return unembed(params, x)[:, 0], cache


def _truncate_logits(logits, top_k: int | None, top_p: float | None):
    """Restrict ``logits (B, V)`` to the top-k and/or nucleus (top-p)
    sets by setting everything else to float32's lowest value, in
    float32. Top-p keeps the smallest prefix of probability-sorted tokens
    whose mass reaches ``p`` (the first token always survives)."""
    logits = logits.float()
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, _NEG, logits)
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # Token i survives if the mass before it is < p; the smallest
        # surviving sorted logit is the cutoff.
        keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool),
                          cum[..., :-1] < top_p], dim=-1)
        cutoff = torch.where(keep, sorted_logits, math.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, _NEG, logits)
    return logits


def validate_generate_args(cfg: TransformerConfig, prompt_len: int, max_new_tokens: int,
                           temperature: float, top_k: int | None, top_p: float | None,
                           generator: torch.Generator | None, eos_id: int | None = None):
    """The generation argument contract, with the JAX package's texts.
    Returns the generator (``None`` is allowed for greedy decoding)."""
    total = prompt_len + max_new_tokens
    if not cfg.causal:
        raise ValueError(
            "generation requires a causal model (decode_step always "
            "masks future positions; cfg.causal=False would disagree "
            "with the prefill logits)"
        )
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    # Positions 0 .. total-2 are embedded (the last sampled token is
    # returned, never fed back): total == max_seq_len + 1 is valid.
    if total - 1 > cfg.max_seq_len:
        raise ValueError(
            f"prompt {prompt_len} + new {max_new_tokens} needs "
            f"{total - 1} positions, exceeding max_seq_len "
            f"{cfg.max_seq_len}"
        )
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a PRNG key: a torch.Generator "
                         "on the params' device")
    if top_k is not None and not 1 <= top_k <= cfg.vocab_size:
        raise ValueError(f"top_k must be in [1, {cfg.vocab_size}], got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if temperature == 0 and (top_k is not None or top_p is not None):
        raise ValueError(
            "top_k/top_p shape the sampling distribution; greedy "
            "decoding (temperature == 0) would silently ignore them"
        )
    if eos_id is not None and not 0 <= int(eos_id) < cfg.vocab_size:
        raise ValueError(f"eos_id must be in [0, {cfg.vocab_size}), got {eos_id}")
    return generator


def _same_device(a: torch.device, b: torch.device) -> bool:
    def index(d):
        return d.index if d.index is not None else torch.cuda.current_device()

    return a.type == b.type and (a.type != "cuda" or index(a) == index(b))


def generate(params: dict, cfg: TransformerConfig, prompt, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: int | None = None, top_p: float | None = None,
             generator: torch.Generator | None = None, eos_id: int | None = None):
    """Generate ``(B, max_new_tokens)`` int64 continuations of ``prompt
    (B, T)`` on the params' device (a device tensor; reading it is the
    caller's one host sync).

    Greedy when ``temperature == 0``, else samples from
    ``softmax(logits / temperature)`` with noise drawn from
    ``generator`` (on the params' device), optionally restricted to the
    ``top_k`` most likely tokens and/or the ``top_p`` nucleus. ``T +
    max_new_tokens - 1`` positions must fit ``cfg.max_seq_len``. A row
    that emits ``eos_id`` is frozen: every later position emits
    ``eos_id``. The params are cast to the compute type once a call."""
    device = _device_of(params)
    prompt = _tokens(prompt, device)
    B, T = prompt.shape
    generator = validate_generate_args(cfg, T, max_new_tokens, temperature, top_k, top_p,
                                       generator, eos_id)
    if temperature > 0 and not _same_device(generator.device, device):
        raise ValueError(f"the generator is on {generator.device}, the params on {device}")
    run = _compiled_generate(
        cfg, B, T, max_new_tokens, float(temperature), None if top_k is None else int(top_k),
        None if top_p is None else float(top_p), None if eos_id is None else int(eos_id),
        device)
    return run(params, prompt, generator)


# One program holds a configuration's buffers (about the cache's size and
# a copy of the params) and its graph: a small bound keeps that memory
# bounded.
@functools.lru_cache(maxsize=8)
def _compiled_generate(cfg: TransformerConfig, batch: int, prompt_len: int,
                       max_new_tokens: int, temperature: float, top_k, top_p, eos_id, device):
    return GenerateProgram(cfg, batch, prompt_len, max_new_tokens, temperature, top_k, top_p,
                           eos_id, device)


def _sample(logits, noise, temperature: float, top_k, top_p):
    """Greedy argmax, or Gumbel-max over the truncated ``logits /
    temperature`` with ``noise (B, V)``."""
    if temperature == 0:
        return logits.argmax(dim=-1)
    return (_truncate_logits(logits, top_k, top_p) / temperature + noise).argmax(dim=-1)


def _freeze(done, tok, eos_id):
    """Stop-token semantics: a finished row emits ``eos_id``; the token
    equal to ``eos_id`` is still emitted, then marks its row done
    (``done`` is updated in place)."""
    if eos_id is None:
        return tok
    tok = torch.where(done, eos_id, tok)
    done.logical_or_(tok == eos_id)
    return tok


def _decode_token(s: SimpleNamespace, cfg: TransformerConfig, temperature: float, top_k, top_p,
                  eos_id) -> None:
    """One decode step over the program's buffers ``s``, all updated in
    place: the token at ``s.pos`` runs through the cache, the next token
    is sampled with the noise at ``s.step`` and written to ``s.out``'s
    column ``s.step``. Reads nothing on the host: this is what the graph
    captures."""
    logits, _ = decode_step(s.params, s.cache, s.pos, s.token, cfg)
    noise = None if s.noise is None else s.noise.index_select(0, s.step)[0]
    nxt = _freeze(s.done, _sample(logits, noise, temperature, top_k, top_p), eos_id)
    s.out.index_copy_(1, s.step, nxt[:, None])
    s.token.copy_(nxt)
    s.pos.add_(1)
    s.step.add_(1)


class GenerateProgram:
    """The decode loop of one ``(cfg, batch, prompt_len, max_new_tokens,
    temperature, top_k, top_p, eos_id, device)`` configuration over
    static buffers: the params cast to the compute type, the ``(L, B,
    prompt_len + max_new_tokens - 1, H, Dh)`` cache, the token, position
    and step indices, the done mask, the ``(B, max_new_tokens)`` output
    and the noise. ``__call__`` is :func:`generate`'s body; :meth:`start`
    and :meth:`decode` are its two halves, apart for timing. One call at a
    time (a lock): the buffers are shared."""

    def __init__(self, cfg: TransformerConfig, batch: int, prompt_len: int,
                 max_new_tokens: int, temperature: float, top_k, top_p, eos_id, device):
        self.cfg, self.prompt_len, self.max_new_tokens = cfg, prompt_len, max_new_tokens
        self.temperature, self.top_k, self.top_p, self.eos_id = temperature, top_k, top_p, eos_id
        self.device = torch.device(device)
        self.dtype = _COMPUTE_DTYPES[cfg.compute_dtype]
        self.max_len = prompt_len + max_new_tokens - 1
        shape = (cfg.n_layers, batch, self.max_len, cfg.n_heads, cfg.head_dim)
        dev = self.device

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.state = SimpleNamespace(
            params=None,
            cache={"k": zeros(shape, self.dtype), "v": zeros(shape, self.dtype)},
            token=zeros((batch,), torch.long), pos=zeros((1,), torch.long),
            step=zeros((1,), torch.long), done=zeros((batch,), torch.bool),
            out=zeros((batch, max_new_tokens), torch.long),
            noise=(zeros((max_new_tokens, batch, cfg.vocab_size), torch.float32)
                   if temperature > 0 else None))
        # The step holds the buffers, not this object: no reference cycle
        # through the graph (graphs.py).
        self.step_fn = functools.partial(_decode_token, self.state, cfg, temperature, top_k,
                                         top_p, eos_id)
        self.graph = None
        self._lock = threading.Lock()

    @torch.no_grad()
    def start(self, params: dict, prompt, generator) -> None:
        """Cast the params into the static copy, prefill the cache, draw
        the noise and sample the first token into ``out[:, 0]``."""
        s = self.state
        if s.params is None:
            s.params = tree_map(lambda a: torch.empty(a.shape, dtype=self.dtype,
                                                      device=self.device), params)
        for dst, src in zip(param_leaves(s.params), param_leaves(params)):
            dst.copy_(src)
        logits, cache = prefill(s.params, prompt, self.cfg, self.max_len)
        s.cache["k"].copy_(cache["k"])
        s.cache["v"].copy_(cache["v"])
        if s.noise is not None:
            s.noise.uniform_(generator=generator).clamp_(min=_TINY).log_().neg_().log_().neg_()
        s.done.zero_()
        first = _freeze(s.done, _sample(logits[:, self.prompt_len - 1],
                                        None if s.noise is None else s.noise[0],
                                        self.temperature, self.top_k, self.top_p), self.eos_id)
        s.out[:, 0] = first
        s.token.copy_(first)
        s.pos.fill_(self.prompt_len)
        s.step.fill_(1)

    @torch.no_grad()
    def decode(self, n: int | None = None, *, graphed: bool) -> None:
        """Run ``n`` decode steps (default: the rest of ``max_new_tokens``).
        ``graphed``: replays of the captured step (a CUDA device only; the
        first call ever is the capture's warm-up, a real step), else the
        eager step."""
        n = self.max_new_tokens - 1 if n is None else n
        if graphed and self.graph is None:
            from tpu_dist_nn_torch.train.graphs import GraphedStep

            self.graph = GraphedStep(self.step_fn, self.device)
        run = self.graph if graphed else self.step_fn
        for _ in range(n):
            run()

    def __call__(self, params: dict, prompt, generator):
        with self._lock, torch.no_grad():
            self.start(params, prompt, generator)
            self.decode(graphed=self.device.type == "cuda")
            return self.state.out.clone()


# ---------------------------------------------------------------------------
# Slot-wise decoding: the functions under the continuous scheduler. One
# (L, S, max_len, H, Dh) cache holds S request slots; a prompt lands in
# any free slot, and one step advances every slot at its own position.
# ---------------------------------------------------------------------------


def init_slot_cache(cfg: TransformerConfig, slots: int, max_len: int, dtype=None, *,
                    device=None) -> dict:
    """A zeroed ``(L, S, max_len, H, Dh)`` slot cache in the compute type
    (or ``dtype``) on ``device`` (default: cuda): :func:`prefill`'s
    layout with the batch axis as slots."""
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    if max_len < 1 or max_len > cfg.max_seq_len:
        raise ValueError(f"max_len must be in [1, {cfg.max_seq_len}], got {max_len}")
    dtype = _COMPUTE_DTYPES[cfg.compute_dtype] if dtype is None else dtype
    shape = (cfg.n_layers, slots, max_len, cfg.n_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


@torch.no_grad()
def prefill_chunk_into_cache(params: dict, cfg: TransformerConfig, cache: dict, slot, tokens,
                             start):
    """Prefill one chunk of a prompt into slot ``slot``: ``tokens (1, C)``
    take positions ``[start, start + C)`` and attend to the slot's cache
    below ``start`` (a prefix copied in by :func:`copy_cache_slot`, or
    earlier chunks) and to themselves, causally. ``start`` is clamped so
    the chunk fits, as ``lax.dynamic_slice`` clamps it.

    All ``max_len`` rows of the slot are computed, each at its position,
    the chunk's rows written to the cache (module docstring: one shape
    per cache keeps chunked and whole prefills bit-equal). Returns
    ``(logits (1, V) of the chunk's last position, cache)``, the cache
    updated in place."""
    params = cfg.cast_params(params)
    M = cache["k"].shape[2]
    dev = cache["k"].device
    tokens = _tokens(tokens, dev)
    C = tokens.shape[1]
    if C > M:
        raise ValueError(f"prompt length {C} exceeds cache length {M}")
    slot, start = _index(slot, dev), _index(start, dev)
    steps = torch.arange(C, device=dev)
    at = start.clamp(0, M - C) + steps
    emb_at = start.clamp(0, params["pos_embed"].shape[0] - C) + steps
    x = torch.zeros((1, M, cfg.d_model), dtype=params["tok_embed"].dtype, device=dev)
    x.index_copy_(1, at, (params["tok_embed"][tokens[0]]
                          + params["pos_embed"].index_select(0, emb_at))[None])
    rows = torch.arange(M, device=dev)
    live = (rows[None, :] <= rows[:, None])[None]  # row r sees keys j <= r
    slot_cache = {part: cache[part].index_select(1, slot) for part in ("k", "v")}

    def write(c, new):
        c.index_copy_(1, at, new.index_select(1, at).to(c.dtype))

    x = _cached_layers(params["blocks"], slot_cache, x, cfg, write, live)
    for part in ("k", "v"):
        cache[part].index_copy_(1, slot, slot_cache[part])
    return unembed(params, x.index_select(1, at[-1:]))[:, 0], cache


@torch.no_grad()
def prefill_into_cache(params: dict, cfg: TransformerConfig, cache: dict, slot, tokens):
    """Prefill one prompt ``(1, T)`` into slot ``slot``: the slot's whole
    extent is zeroed first (a reused slot leaks nothing of its previous
    occupant), then the prompt is one chunk at position 0. Returns
    ``(logits (1, V) of the last prompt position, cache)``."""
    dev = cache["k"].device
    slot = _index(slot, dev)
    for part in ("k", "v"):
        cache[part].index_fill_(1, slot, 0)
    return prefill_chunk_into_cache(params, cfg, cache, slot, tokens, 0)


@torch.no_grad()
def copy_cache_slot(cache: dict, src, dst) -> dict:
    """Copy slot ``src``'s whole ``max_len`` extent onto slot ``dst`` (the
    prefix-cache transfer), in place."""
    dev = cache["k"].device
    src, dst = _index(src, dev), _index(dst, dev)
    for part in ("k", "v"):
        cache[part].index_copy_(1, dst, cache[part].index_select(1, src))
    return cache


@torch.no_grad()
def decode_blocks_slots(blocks: dict, cache: dict, pos, x, cfg: TransformerConfig, active):
    """One decode step through a stacked block group with per-slot
    positions: ``x (S, 1, D)`` attends against each slot's cache, written
    at ``pos[s]`` for active slots only (a retired slot writes nothing,
    nor does a position past the cache). Keys past ``pos[s]`` are masked."""
    S = x.shape[0]
    M = cache["k"].shape[2]
    slots = torch.arange(S, device=x.device)
    at = pos.clamp(max=M - 1)
    ok = (active & (pos < M))[:, None, None]
    live = (torch.arange(M, device=x.device)[None, :] <= pos[:, None])[:, None]

    def write(c, new):
        c[slots, at] = torch.where(ok, new[:, 0].to(c.dtype), c[slots, at])

    return _cached_layers(blocks, cache, x, cfg, write, live), cache


@torch.no_grad()
def decode_step_slots(params: dict, cache: dict, pos, token, cfg: TransformerConfig,
                      active=None):
    """One decode step for all slots: ``token (S,)`` at per-slot positions
    ``pos (S,)``, gated by ``active (S,)`` bool (default: all). With
    ``pos`` all equal and every slot active it computes
    :func:`decode_step`'s logits and cache, bit for bit. Positions are
    clipped to the positional table. Returns ``(logits (S, V), cache)``."""
    params = cfg.cast_params(params)
    dev = _device_of(params)
    token = _tokens(token, dev)
    active = (torch.ones(token.shape, dtype=torch.bool, device=dev) if active is None
              else torch.as_tensor(active, device=dev).bool())
    safe = _tokens(pos, dev).clamp(0, params["pos_embed"].shape[0] - 1)
    x = params["tok_embed"][token][:, None, :] + params["pos_embed"][safe][:, None, :]
    x, cache = decode_blocks_slots(params["blocks"], cache, safe, x, cfg, active)
    return unembed(params, x)[:, 0], cache
