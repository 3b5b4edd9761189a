"""Continuous batching for LM generation: the iteration-level decode
scheduler (Orca, OSDI '22) on a slot KV cache, with shared-prefix KV
reuse (exact-match tiers) and chunked prefill (Sarathi-Serve).

Port of :mod:`tpu_dist_nn.serving.continuous`, on one device:

* One fixed ``(L, S + P, max_len, H, Dh)`` slot cache
  (:func:`~tpu_dist_nn_torch.models.generate.init_slot_cache`) holds
  ``S`` request slots plus ``P`` prefix-pool blocks. Shapes never
  change: admission and retirement flip entries of a per-slot active
  mask (one request = one slot = one contiguous ``max_len`` extent).
* **Prefix caching**: the pool caches K/V for chunk-aligned token
  prefixes, keyed on the exact prefix bytes. A hit admits by COPYING the
  block into the request's slot (copy-on-write: the request decodes in
  its own slot and never mutates the shared block) and prefilling only
  the suffix. Blocks are ref-counted from admission to retirement and
  evicted LRU at refcount 0 (``tdn_prefix_cache_*``).
* **Chunked prefill**: a prompt is prefilled ``prefill_chunk`` tokens
  per scheduler iteration (:func:`~tpu_dist_nn_torch.models.generate.
  prefill_chunk_into_cache`, eager, one launch set a chunk) beside the
  resident decode step, so a long prompt never freezes the live
  streams. Every admission goes through the chunk function (a whole
  prompt is one chunk), so cache-on and cache-off share ONE numeric path
  and greedy outputs are bit-identical.
* **The decode step** advances every slot at its own position
  (:func:`~tpu_dist_nn_torch.models.generate.decode_step_slots` over the
  request region as a VIEW, ``cache[...][:, :S]``: the prefix blocks
  are never copied), samples (greedy, or Gumbel-max over the truncated
  logits with noise from the scheduler's own ``torch.Generator``), and
  computes the numeric guard's ``isfinite(logits).all(-1)`` per slot.
  On a card the step is captured once as a CUDA graph
  (:class:`~tpu_dist_nn_torch.train.graphs.GraphedStep`, the counterpart
  of the JAX step's ``jax.jit(donate_argnums=(1,))``) over static
  buffers: the host writes ``pos`` / ``active`` / ``tok`` into one
  pinned buffer copied in before each replay, draws the step's noise
  into its static buffer (no generator state lives in the graph), and
  fetches the tokens and the ``ok`` mask in ONE device-to-host copy,
  the step's only sync. The CPU runs the same step eagerly.
* **Early retirement** on ``eos_id`` or the per-request
  ``max_new_tokens``; the freed slot is refilled on the same iteration.
* **Decode-slot preemption**: a ``critical`` request that cannot bind
  evicts the best victim (dead waiters first, then the lowest class,
  then the fewest generated tokens) and binds into the freed slot; the
  victim re-queues with its generated prefix and resumes by prompt
  re-prefill + forced-token REPLAY through the same step, the exact
  original computation, so its greedy output is bit-identical to an
  unpreempted run.

Resilience: admission, shedding, close and drain are the shared
scheduling core (:mod:`~tpu_dist_nn_torch.serving.sched_core`);
``close(timeout)`` lets resident rows (half-prefilled slots included)
finish before failing still-pending waiters over as UNAVAILABLE.
``launch_hook`` fires before every step, ``fetch_hook`` after it and
before its token fetch, ``prefill_hook`` before every prefill chunk (a
mid-prefill fault fails that request over, frees its slot and releases
its prefix-block reference).

One thread owns the device: the scheduler's loop thread (it sets the
cache's card as its current device) is the only thread that launches
prefill chunks, slot copies and steps, or replays the graph;
:meth:`ContinuousScheduler.warm` hands its work to that thread.
"""

from __future__ import annotations

import collections
import functools
import itertools
import logging
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from tpu_dist_nn_torch.obs import trace as _trace
from tpu_dist_nn_torch.obs.goodput import GOODPUT, LMFlopModel
from tpu_dist_nn_torch.obs.log import get_logger
from tpu_dist_nn_torch.obs.registry import POW2_BUCKETS, REGISTRY
from tpu_dist_nn_torch.serving import integrity as _integrity
from tpu_dist_nn_torch.serving.sched_core import (
    CLASS_RANK,
    SchedCore,
    slide_stream_deadline,
)
from tpu_dist_nn_torch.serving.stream import StreamDone, TokenStream
from tpu_dist_nn_torch.utils.errors import IntegrityError, UnavailableError

log = logging.getLogger(__name__)
slog = get_logger(__name__)

_TTFT = REGISTRY.histogram(
    "tdn_gen_ttft_seconds",
    "time to first token: request submit to its first sampled token "
    "(prefill complete), continuous scheduler",
)
_TOKENS = REGISTRY.counter(
    "tdn_gen_tokens_total",
    "tokens emitted by the continuous decode scheduler",
)
_RETIRED = REGISTRY.counter(
    "tdn_gen_requests_retired_total",
    "request rows retired from a decode slot, by reason",
    labels=("reason",),
)
_PREEMPTED = REGISTRY.counter(
    "tdn_gen_preemptions_total",
    "decode-slot preemptions: a resident row evicted mid-stream so a "
    "critical-class request could bind, re-queued with its generated "
    "prefix for replay (by the VICTIM's class)",
    labels=("slo_class",),
)
# The static batcher's family (rows per device launch): here a launch is
# one slot step and its rows are the active slots it advanced.
_BATCH_ROWS = REGISTRY.histogram(
    "tdn_batch_rows", "coalesced rows per device launch (pre-padding)",
    labels=("method",), buckets=POW2_BUCKETS,
)
_PREFIX_HITS = REGISTRY.counter(
    "tdn_prefix_cache_hits_total",
    "admissions served from a cached prefix block (copy-on-write "
    "block copy + suffix-only prefill)",
)
_PREFIX_MISSES = REGISTRY.counter(
    "tdn_prefix_cache_misses_total",
    "admissions whose prompt matched no cached prefix tier "
    "(full prefill)",
)
_PREFIX_EVICTIONS = REGISTRY.counter(
    "tdn_prefix_cache_evictions_total",
    "refcount-0 prefix blocks evicted (LRU) to admit a new prefix",
)


def _scheduler_step(st: SimpleNamespace, cfg, S: int, temperature: float, top_k,
                    top_p) -> None:
    """The scheduler's device step over its static buffers ``st``, all
    updated in place: every slot's token ``st.inp[2]`` at its position
    ``st.inp[0]`` (written only where ``st.inp[1]`` is set) runs through
    the REQUEST region of the cache, a view (the prefix blocks past slot
    ``S`` are never touched or copied); the sample lands in
    ``st.res[0]`` and the guard's per-slot ``isfinite(logits)`` in
    ``st.res[1]``. Reads nothing on the host: this is what the graph
    captures."""
    from tpu_dist_nn_torch.models.generate import _sample, decode_step_slots

    head = {"k": st.cache["k"][:, :S], "v": st.cache["v"][:, :S]}
    logits, _ = decode_step_slots(st.params, head, st.inp[0], st.inp[2], cfg,
                                  active=st.inp[1].bool())
    st.res[0].copy_(_sample(logits, st.noise, temperature, top_k, top_p))
    st.res[1].copy_(torch.isfinite(logits).all(dim=-1))


class PrefixCachePool:
    """Host-side bookkeeping for the reserved prefix region of the slot
    cache: which pool block holds which token-prefix, with refcounts
    and LRU eviction. Exact-match only — the key IS the prefix bytes,
    so there are no collisions and no radix tree.

    Single-threaded by design: the scheduler loop thread is the only
    caller (lookups/inserts happen at admission and chunk boundaries,
    releases at retirement — all loop-side events), so no lock.

    A block is REFERENCED from the admission that hit it until that
    request retires (or fails): a referenced block is never evicted, so
    a hot shared header cannot be thrashed out from under the requests
    using it. Eviction picks the least-recently-USED block among
    refcount-0 blocks; with every block referenced, insertion is simply
    skipped (caching is an optimization, never a correctness gate).
    """

    def __init__(self, blocks: int):
        if blocks < 1:
            raise ValueError(f"pool needs >= 1 block, got {blocks}")
        self.blocks = int(blocks)
        self._key: list[bytes | None] = [None] * self.blocks
        self._len = [0] * self.blocks
        self._refs = [0] * self.blocks
        self._last_use = [0] * self.blocks
        self._by_key: dict[bytes, int] = {}
        self._tick = itertools.count(1)
        self.hits_total = 0
        self.misses_total = 0
        self.evictions_total = 0

    @property
    def used(self) -> int:
        """Blocks currently holding a cached prefix."""
        return len(self._by_key)

    def refs(self, block: int) -> int:
        return self._refs[block]

    def block_len(self, block: int) -> int:
        return self._len[block]

    def lookup(self, candidates) -> tuple[int, int] | None:
        """The longest cached prefix among ``candidates`` (``(length,
        key_bytes)`` pairs, longest FIRST). A hit takes a reference and
        bumps recency, returning ``(block, length)``; a full miss
        returns None. Exactly one hit-or-miss is accounted per call
        (per admission)."""
        for length, key in candidates:
            b = self._by_key.get(key)
            if b is not None:
                self._refs[b] += 1
                self._last_use[b] = next(self._tick)
                self.hits_total += 1
                return b, length
        self.misses_total += 1
        return None

    def release(self, block: int) -> None:
        """Drop one reference (the request that held it retired)."""
        if self._refs[block] <= 0:
            raise AssertionError(
                f"release of unreferenced prefix block {block}"
            )
        self._refs[block] -= 1

    def clear(self) -> None:
        """Drop every cached block — the backing cache was rebuilt
        after a device fault, so the K/V the blocks pointed at is gone.
        Lifetime counters survive (they are totals, not state). The
        caller fails/releases every resident first, so no block can
        still be referenced."""
        if any(self._refs):
            raise AssertionError(
                "clear() with live references — release residents first"
            )
        self._key = [None] * self.blocks
        self._len = [0] * self.blocks
        self._last_use = [0] * self.blocks
        self._by_key.clear()

    def insert(self, key: bytes, length: int) -> tuple[int | None, bool]:
        """Reserve a block for a new prefix: a free block, else the LRU
        refcount-0 block (eviction), else None — all blocks referenced,
        insertion skipped. Returns ``(block, evicted)``; ``(None,
        False)`` when skipped or the key is already cached."""
        if key in self._by_key:
            return None, False
        free = next(
            (b for b in range(self.blocks) if self._key[b] is None), None
        )
        evicted = False
        if free is None:
            idle = [b for b in range(self.blocks) if self._refs[b] == 0]
            if not idle:
                return None, False
            free = min(idle, key=lambda b: self._last_use[b])
            del self._by_key[self._key[free]]
            self.evictions_total += 1
            evicted = True
        self._key[free] = key
        self._len[free] = int(length)
        self._refs[free] = 0
        self._last_use[free] = next(self._tick)
        self._by_key[key] = free
        return free, evicted


class ContinuousScheduler:
    """Iteration-level decode scheduler over a slot KV cache.

    ``submit(rows)`` blocks the calling (gRPC worker) thread until every
    row's sequence is finished, as ``Batcher.submit`` does; behind the
    call one daemon loop thread owns the device, interleaving at most one
    prefill CHUNK an iteration with single-token steps over all decoding
    slots, and retires each row the moment it hits EOS or its budget.

    ``prefix_cache_blocks > 0`` reserves that many pool blocks at the
    tail of the slot cache and turns shared-prefix reuse on: admission
    looks the prompt's chunk-aligned prefixes up (longest tier first),
    copies a hit's block into the request slot and prefills only the
    suffix. ``prefill_chunk`` bounds tokens a prefill launch (None = the
    whole prompt or suffix in one chunk) and is also the tier grain.

    ``device``: where the cache and the params' static copy live (None =
    the card). Construction builds the buffers and launches nothing;
    :meth:`warm` runs each chunk length and the slot copy once and
    captures the step, on the loop thread.

    Counter attributes mirror ``Batcher`` (``requests_total``,
    ``batches_total`` = step launches, ``rows_total``, ``pending_rows``,
    ``inflight_rows`` = rows resident in slots, ``shed_total``); the
    generation-specific ones (``slots_active``, ``steps_total``,
    ``slot_steps_total``, ``ttft_recent``, ``prefill_chunks_total``,
    ``preempted_total``, the ``prefix_*`` accessors) feed the
    ``tdn_gen_*`` / ``tdn_prefix_cache_*`` families.

    ``prefill_fn`` / ``step_fn`` / ``copy_fn`` are testing seams with the
    JAX package's signatures (``prefill_fn(params, cache, slot, tokens,
    start, key) -> (token, cache)``, ``step_fn(params, cache, pos,
    active, tok, key) -> (tokens, cache)``, ``copy_fn(cache, src, dst)
    -> cache``): deterministic cost models with no device work. The real
    kernels take ``key=None``: sampling noise comes from the scheduler's
    generator.
    """

    method = "Generate"

    def __init__(self, params, cfg, *, slots: int, prompt_len: int,
                 max_new_tokens: int, temperature: float = 0.0,
                 top_k: int | None = None, top_p: float | None = None,
                 eos_id: int | None = None, seed: int = 0,
                 submit_timeout: float | None = 120.0,
                 max_pending_rows: int | None = None,
                 prefix_cache_blocks: int = 0,
                 prefill_chunk: int | None = None,
                 class_watermarks: dict | None = None,
                 device=None,
                 prefill_fn=None, step_fn=None, copy_fn=None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self._S = int(slots)
        self._T = int(prompt_len)
        self._N = int(max_new_tokens)
        self._eos = None if eos_id is None else int(eos_id)
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self._chunk = None if prefill_chunk is None else int(prefill_chunk)
        self._P = int(prefix_cache_blocks)
        if self._P < 0:
            raise ValueError(
                f"prefix_cache_blocks must be >= 0, got {prefix_cache_blocks}"
            )
        # Prefix tiers: the cacheable prefix lengths, chunk-aligned so a
        # hit resumes exactly at a chunk boundary. Without chunking the
        # one tier is the whole prompt but its last token; capped at
        # T - 1 so a hit always leaves a suffix token for the logits.
        grain = self._chunk if self._chunk is not None else self._T - 1
        self._tiers: tuple[int, ...] = tuple(
            sorted(
                (k * grain for k in range(1, self._T)
                 if 1 <= k * grain <= self._T - 1),
                reverse=True,
            )
        ) if self._P else ()
        if self._P and not self._tiers:
            raise ValueError(
                f"prefix_cache_blocks={self._P} has no cacheable tier: "
                f"need a prefix length in [1, prompt_len - 1 = "
                f"{self._T - 1}] — lower prefill_chunk (got "
                f"{self._chunk}) or raise prompt_len"
            )
        self._pool = PrefixCachePool(self._P) if self._P else None
        self._temperature = float(temperature)
        self._device = None
        self._graph = None
        if prefill_fn is not None or step_fn is not None:
            if prefill_fn is None or step_fn is None:
                raise ValueError("prefill_fn and step_fn must be injected together")

            # The public step_fn seam keeps its (toks, cache) contract;
            # internally steps return (toks, ok, cache), ok=None here:
            # injected kernels carry no logits for the guard.
            def _step_no_guard(*a, _fn=step_fn):
                toks, cache = _fn(*a)
                return toks, None, cache

            self._prefill, self._step = prefill_fn, _step_no_guard
            # Fake caches have no block storage; the default injected
            # copy is the identity (the pool bookkeeping still runs).
            self._copy = copy_fn if copy_fn is not None else (lambda cache, src, dst: cache)
            self._fetch = _fetch_host
            self._params = params
            self._cache = None
            self._reset_cache = None
            self._gp_model = None  # no architecture: no FLOP model
        else:
            if copy_fn is not None:
                raise ValueError(
                    "copy_fn is an injection seam: pass it together "
                    "with prefill_fn/step_fn"
                )
            from tpu_dist_nn_torch.models.generate import validate_generate_args
            from tpu_dist_nn_torch.utils.device import resolve_device

            self._device = resolve_device(device)
            self._gen = torch.Generator(device=self._device).manual_seed(int(seed))
            validate_generate_args(
                cfg, self._T, self._N, temperature, top_k, top_p,
                self._gen if temperature > 0 else None, eos_id,
            )
            self._build_kernels(params, cfg, top_k, top_p)
        # Host-side slot state: the loop thread is the only writer.
        # _active marks DECODING slots; a bound slot still chunking its
        # prefill has an occupant but is not active yet.
        self._pos = np.zeros(self._S, np.int32)
        self._active = np.zeros(self._S, bool)
        self._tok = np.zeros(self._S, np.int32)
        self._occupant: list[dict | None] = [None] * self._S
        self._prefill_rr = 0  # round-robin fairness over chunking slots
        # Fault hooks: at the top of every step / before its token fetch
        # / before every prefill chunk.
        self.launch_hook = None
        self.fetch_hook = None
        self.prefill_hook = None
        self._sched_core = SchedCore(
            self.method, max_pending_rows=max_pending_rows,
            submit_timeout=submit_timeout,
            class_watermarks=class_watermarks,
        )
        self._cond = self._sched_core.cond
        # Preempted rows awaiting re-bind, with their generated prefix
        # for replay. Mutated under _cond.
        self._resume: collections.deque[dict] = collections.deque()  # guarded-by: _cond
        # warm() hands its work to the loop thread through this slot.
        self._warm_req: tuple | None = None  # guarded-by: _cond
        self.rows_total = 0        # rows that entered a slot
        self.batches_total = 0     # step launches (steps_total aliases it)
        self.overlapped_total = 0  # N/A here; kept for sampler parity
        self.preempted_total = 0   # rows evicted for a critical bind
        self.slot_steps_total = 0  # active slots summed over steps
        self.retired_total = 0     # rows retired (eos + max_tokens + cancelled)
        self.prefill_chunks_total = 0  # chunk launches
        self.ttft_recent: collections.deque[float] = collections.deque(maxlen=1024)
        self._m_rows = _BATCH_ROWS.labels(method=self.method)
        self._thread = threading.Thread(
            target=self._loop, name="tdn-gen-continuous", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------ kernels

    def _build_kernels(self, params, cfg, top_k, top_p) -> None:
        from tpu_dist_nn_torch.models.generate import (
            _COMPUTE_DTYPES,
            _TINY,
            _sample,
            copy_cache_slot,
            init_slot_cache,
            prefill_chunk_into_cache,
        )
        from tpu_dist_nn_torch.models.transformer import tree_map

        if self._device.type == "cuda" and self._device.index is None:
            # torch.cuda.set_device (the loop's) wants an index.
            self._device = torch.device("cuda", torch.cuda.current_device())
        dev, S, T, N = self._device, self._S, self._T, self._N
        dtype = _COMPUTE_DTYPES[cfg.compute_dtype]
        # The scheduler's own copy of the params in the compute type:
        # the captured step reads them at fixed addresses, and a caller
        # that keeps training its params must not move them under it.
        self._params = tree_map(
            lambda a: a.detach().to(device=dev, dtype=dtype, copy=True), params)
        # The last decode writes position T + N - 2 (generate's cache
        # sizing), so the slot extent is T + N - 1. The prefix pool rides
        # the SAME cache as P extra slots past the request region.
        M = T + N - 1 if N > 1 else T
        self._cache = init_slot_cache(cfg, S + self._P, M, device=dev)

        def reset_cache():
            # In place: the graph holds the cache's addresses.
            for part in self._cache.values():
                part.zero_()

        self._reset_cache = reset_cache
        # The goodput FLOP model at the kernels' static shapes: the step
        # runs the REQUEST region only, extent M.
        self._gp_model = LMFlopModel.from_config(cfg, M)
        GOODPUT.ensure_peak(device_count=1, dtype=cfg.compute_dtype)
        top_k = None if top_k is None else int(top_k)
        top_p = None if top_p is None else float(top_p)
        temperature = self._temperature
        V = cfg.vocab_size
        pin = dev.type == "cuda"
        # Static buffers of the step: inp = (pos, active, tok) as one
        # (3, S) int64 block (one host-to-device copy a step), res =
        # (sampled token, ok) as one (2, S) block (one copy back).
        self._st = SimpleNamespace(
            params=self._params, cache=self._cache,
            inp=torch.zeros((3, S), dtype=torch.long, device=dev),
            res=torch.zeros((2, S), dtype=torch.long, device=dev),
            noise=(torch.zeros((S, V), dtype=torch.float32, device=dev)
                   if temperature > 0 else None))
        self._inp_host = torch.zeros((3, S), dtype=torch.long, pin_memory=pin)
        self._res_host = torch.zeros((2, S), dtype=torch.long, pin_memory=pin)
        # The step holds the buffers, not this object: no reference
        # cycle through the graph.
        self._eager_step = functools.partial(_scheduler_step, self._st, cfg, S, temperature,
                                             top_k, top_p)
        gen = self._gen

        def draw(noise):
            noise.uniform_(generator=gen).clamp_(min=_TINY).log_().neg_().log_().neg_()
            return noise

        self._prefill_noise = (torch.zeros((1, V), dtype=torch.float32, device=dev)
                               if temperature > 0 else None)

        def prefill_chunk(params, cache, slot, tokens, start, key):
            logits, cache = prefill_chunk_into_cache(params, cfg, cache, slot, tokens, start)
            noise = None if self._prefill_noise is None else draw(self._prefill_noise)
            return _sample(logits, noise, temperature, top_k, top_p)[0], cache

        def step(params, cache, pos, active, tok, key):
            h = self._inp_host.numpy()
            h[0], h[1], h[2] = pos, active, tok
            self._st.inp.copy_(self._inp_host, non_blocking=True)
            if self._st.noise is not None:
                draw(self._st.noise)
            self._run_step()
            return self._st.res[0], self._st.res[1], cache

        self._prefill = prefill_chunk
        self._copy = copy_cache_slot
        self._step = step
        self._fetch = self._fetch_device

    def _run_step(self, graphed: bool | None = None) -> None:
        """One step over the static buffers: the captured graph on a card
        (captured at its first call), else the eager function."""
        if graphed is None:
            graphed = self._device.type == "cuda"
        if not graphed:
            self._eager_step()
            return
        if self._graph is None:
            from tpu_dist_nn_torch.train.graphs import GraphedStep

            self._graph = GraphedStep(self._eager_step, self._device)
        self._graph()

    def _fetch_device(self, toks, ok):
        """The step's one device-to-host copy: tokens and the ok mask
        together."""
        self._res_host.copy_(self._st.res)
        res = self._res_host.numpy()
        return res[0].copy(), res[1].astype(bool)

    def _chunk_lengths(self) -> list[int]:
        """Every chunk length the scheduler can launch: walking from each
        possible start (0, or any prefix tier a hit resumes at) in
        ``prefill_chunk`` strides. {chunk, T mod chunk} in the common
        case."""
        starts = {0, *self._tiers}
        lengths: set[int] = set()
        for s in starts:
            pos = s
            while pos < self._T:
                c = (
                    self._T - pos if self._chunk is None
                    else min(self._chunk, self._T - pos)
                )
                lengths.add(c)
                pos += c
        return sorted(lengths, reverse=True)

    def warm(self) -> list[str]:
        """Run every kernel the loop can launch once, so the port opens
        hot: the chunk prefill at each chunk LENGTH the configuration can
        produce, the slot copy (prefix pool on), and the step (on a card
        its first call captures the graph). Runs on the loop thread,
        against slot 0 of the real cache with zero prompts: the slot is
        free, so its junk K/V is masked and the next occupant's prefill
        overwrites it. Returns the names of what ran."""
        done = threading.Event()
        box: dict = {}
        with self._cond:
            if self._sched_core.closed:
                raise UnavailableError("scheduler is closed")
            self._warm_req = (done, box)
            self._cond.notify_all()
        done.wait()
        if "err" in box:
            raise box["err"]
        return box["warmed"]

    def _warm_kernels(self) -> list[str]:
        key = None  # the seams' key: sampling noise comes from the generator
        for c in self._chunk_lengths():
            tok, self._cache = self._prefill(
                self._params, self._cache, 0, np.zeros((1, c), np.int32), 0, key)
            int(tok)
        warmed = ["prefill_chunk_into_cache"]
        if self._P:
            # Self-copy of free slot 0: runs the copy without touching
            # live state.
            self._cache = self._copy(self._cache, 0, 0)
            warmed.append("copy_cache_slot")
        zeros = np.zeros(self._S, np.int32)
        toks, ok, self._cache = self._step(
            self._params, self._cache, zeros, np.zeros(self._S, bool), zeros, key)
        self._fetch(toks, ok)
        warmed.append("decode_step_slots")
        return warmed


    # ------------------------------------------------------------ submit

    @property
    def inflight_rows(self) -> int:
        """Rows resident in slots — decoding OR mid-prefill."""
        return sum(1 for o in self._occupant if o is not None)

    # The Batcher's counter surface (drain plumbing and tests read these
    # names on both schedulers), owned by the shared core.
    @property
    def pending_rows(self) -> int:
        """Rows awaiting a slot: queued fresh rows plus preempted rows
        awaiting re-bind. Lock-free (a GIL-atomic int read and a deque
        len): a gauge read never queues behind admission."""
        return self._sched_core.pending_rows + len(self._resume)

    @property
    def requests_total(self) -> int:
        return self._sched_core.requests_total

    @property
    def shed_total(self) -> int:
        return self._sched_core.shed_total

    @property
    def expired_total(self) -> int:
        return self._sched_core.expired_total

    def queue_depth(self) -> int:
        """Entries awaiting a slot (lock-free, the runtime sampler's
        per-tick read): queued fresh items plus preempted rows awaiting
        resume."""
        return self._sched_core.queue_depth() + len(self._resume)

    def pending_by_class(self) -> dict:
        return self._sched_core.pending_by_class()

    @property
    def slots(self) -> int:
        return self._S

    @property
    def slots_active(self) -> int:
        """Alias of :attr:`inflight_rows` under its generation name."""
        return self.inflight_rows

    @property
    def steps_total(self) -> int:
        """Step-kernel launches, under the name the occupancy ratio
        reads naturally (alias of ``batches_total`` — a device launch
        IS a decode step here)."""
        return self.batches_total

    # Prefix-cache accounting (None-safe: 0 with the pool off, so the
    # readers see one shape whatever the configuration).
    @property
    def prefix_blocks(self) -> int:
        return self._P

    @property
    def prefix_blocks_used(self) -> int:
        return self._pool.used if self._pool is not None else 0

    @property
    def prefix_hits_total(self) -> int:
        return self._pool.hits_total if self._pool is not None else 0

    @property
    def prefix_misses_total(self) -> int:
        return self._pool.misses_total if self._pool is not None else 0

    @property
    def prefix_evictions_total(self) -> int:
        return self._pool.evictions_total if self._pool is not None else 0

    @property
    def prefix_hit_ratio(self) -> float:
        n = self.prefix_hits_total + self.prefix_misses_total
        return self.prefix_hits_total / n if n else 0.0

    def submit(self, x: np.ndarray, *, max_new_tokens: int | None = None,
               timeout: float | None = None, ctx=None,
               slo_class: str = "standard") -> np.ndarray:
        """Block until every row of ``x (N, prompt_len)`` has finished
        generating; returns ``(N, prompt_len + max_new_tokens)`` int64
        (prompt included, post-retirement positions padded with
        ``eos_id``, or with token id 0 when no ``eos_id`` is configured:
        the static scheduler's row semantics).

        ``max_new_tokens`` caps THIS request below the endpoint budget
        (the row simply retires earlier); the output width stays the
        endpoint's. ``timeout``/``ctx`` follow ``Batcher.submit``.
        ``slo_class`` sets queue priority and the shed watermark; a
        ``critical`` row that cannot bind may PREEMPT a lower-class
        resident.
        """
        x = np.asarray(x, np.int32)
        if x.ndim != 2 or x.shape[1] != self._T:
            raise ValueError(
                f"expected prompts of shape (N, {self._T}), got "
                f"{tuple(x.shape)}"
            )
        budget = self._N if max_new_tokens is None else int(max_new_tokens)
        if not 1 <= budget <= self._N:
            raise ValueError(
                f"max_new_tokens must be in [1, {self._N}], got {budget}"
            )
        n = len(x)
        out = np.full(
            (n, self._T + self._N),
            self._eos if self._eos is not None else 0, np.int64,
        )
        out[:, :self._T] = x
        if n == 0:
            # Nothing to decode: answer immediately (the static batcher
            # round-trips an empty matrix too). Queueing it would hand
            # the loop a rowless item whose bogus occupant corrupts the
            # ledger.
            return out
        item = {
            "x": x, "budget": budget, "out": out, "next_row": 0,
            "remaining": n, "done": threading.Event(), "err": None,
            "abandoned": False, "t_submit": time.monotonic(),
            "slo_class": slo_class,
            "ctx": ctx if ctx is not None and ctx.sampled else None,
        }
        # Admission (class watermark, close check, deadline stamp) and
        # the bounded wait are the shared core's contract, the Batcher's
        # own. Abandoned rows already decoding finish their (bounded)
        # budget and are discarded; rows still pending are skipped at
        # bind.
        self._sched_core.admit(item, timeout)
        self._sched_core.wait(item, what="generation")
        return item["out"]

    def submit_stream(self, x: np.ndarray, *,
                      max_new_tokens: int | None = None,
                      timeout: float | None = None, ctx=None,
                      slo_class: str = "standard",
                      resume_tokens=None,
                      max_buffer: int = 4096) -> TokenStream:
        """Admit ONE prompt row ``(1, prompt_len)`` for streaming
        generation and return its :class:`TokenStream` immediately (the
        GenerateStream handler drains it; nothing blocks here beyond
        admission itself, which can shed). Single-row by contract:
        frame ordering and failover resume are per-sequence concepts —
        a client streams N prompts over N streams.

        ``timeout`` is STREAM-aware: it bounds the
        submit-to-first-token wait (queue + prefill) and then each
        NEXT-TOKEN gap — the deadline slides forward at every published
        token — instead of total retirement time, so a long generation
        that is steadily producing tokens never expires mid-stream.

        ``resume_tokens`` is the router's mid-stream-failover prefix:
        tokens the CLIENT already holds. The row binds through the
        preemption-resume path (prompt re-prefill + forced-token
        replay, bit-identical at temperature 0) and the stream's sent
        cursor swallows the replayed prefix, so the client receives
        each token exactly once across the replica switch.
        """
        x = np.asarray(x, np.int32)
        if x.ndim != 2 or x.shape != (1, self._T):
            raise ValueError(
                f"streaming expects ONE prompt of shape (1, {self._T}), "
                f"got {tuple(x.shape)}"
            )
        budget = self._N if max_new_tokens is None else int(max_new_tokens)
        if not 1 <= budget <= self._N:
            raise ValueError(
                f"max_new_tokens must be in [1, {self._N}], got {budget}"
            )
        resume = [int(t) for t in resume_tokens] if resume_tokens else None
        stream = TokenStream(max_buffer)
        if resume is not None:
            # The client already holds the whole replayed prefix.
            stream.seed(len(resume))
            # Degenerate resumes — the stream actually FINISHED on the
            # dead replica (terminal frame lost in the failover): there
            # is nothing left to generate, so answer the terminal
            # without burning a slot on a full replay.
            if self._eos is not None and self._eos in resume:
                stream.finish("eos")
                return stream
            if len(resume) >= budget:
                stream.finish("max_tokens")
                return stream
        out = np.full(
            (1, self._T + self._N),
            self._eos if self._eos is not None else 0, np.int64,
        )
        out[:, :self._T] = x
        item = {
            "x": x, "budget": budget, "out": out, "next_row": 0,
            "remaining": 1, "err": None,
            "abandoned": False, "t_submit": time.monotonic(),
            "slo_class": slo_class,
            "ctx": ctx if ctx is not None and ctx.sampled else None,
            "stream": stream,
            # Per-token-gap budget: _publish slides item["deadline"]
            # forward by this much at every published token.
            "gap_budget": timeout,
            # Consumed at bind: routes the row through the preemption-
            # resume path (forced-token replay).
            "resume_tokens": resume,
        }
        # The done Event is the terminal seam: every existing exit path
        # (_retire, _free_slot_on_error, queue expiry, close sweeps)
        # already stamps err/finish_reason then calls done.set() — the
        # StreamDone subclass turns that into the END frame.
        item["done"] = StreamDone(item, stream)
        self._sched_core.admit(item, timeout)
        return stream

    # ------------------------------------------------------------ loop

    def _publish(self, occ: dict) -> None:
        """Flush the occupant's known-token list into its stream, if it
        has one (called after every ``occ["tokens"]`` append). A dead
        stream (client gone / buffer overflow) marks the item abandoned
        — the loop's reap pass frees the slot next iteration. A live
        publish slides the stream's next-token-gap deadline."""
        item = occ["item"]
        stream = item.get("stream")
        if stream is None:
            return
        if not stream.publish(occ["tokens"]):
            item["abandoned"] = True
            return
        slide_stream_deadline(item, item.get("gap_budget"))

    def _reap_cancelled(self) -> None:
        """Free resident slots whose STREAM item died — client abandon,
        gRPC cancellation, or backpressure overflow (the
        cancel-propagation half of the streaming contract). Unary items
        keep their documented semantics: abandoned rows already
        decoding finish their bounded budget and are discarded."""
        for s in range(self._S):
            occ = self._occupant[s]
            if occ is None:
                continue
            item = occ["item"]
            if item.get("stream") is None:
                continue
            if not (item["abandoned"] or item["err"] is not None):
                continue
            self._occupant[s] = None
            self._active[s] = False
            self._release_block(occ)
            self.retired_total += 1
            _RETIRED.labels(reason="cancelled").inc()
            _TOKENS.inc(len(occ["tokens"]))
            self._sched_core.note_drained(1)
            item["remaining"] -= 1
            slog.info(
                "gen.stream_cancelled", slot=s,
                tokens_generated=len(occ["tokens"]),
            )

    def _release_block(self, occ: dict) -> None:
        """Drop the occupant's prefix-block reference, if it holds one
        (once — retire, fault, and drain paths all funnel here)."""
        block = occ.pop("block", None)
        if block is not None and self._pool is not None:
            self._pool.release(block)

    def _free_slot_on_error(self, slot: int, e: Exception) -> None:
        """Fail ONE occupant's item over (a mid-prefill or per-request
        fault) and free its slot + prefix ref so the scheduler keeps
        serving later arrivals."""
        occ = self._occupant[slot]
        self._occupant[slot] = None
        self._active[slot] = False
        self._release_block(occ)
        item = occ["item"]
        if item["err"] is None:
            item["err"] = e
            item["done"].set()

    def _fail_occupants(self, e: Exception) -> None:
        """A step-kernel fault leaves the shared cache pytree in an
        unknown state, so it hits every resident row — decoding AND
        mid-prefill: fail their items over (a row cannot be replayed —
        its sampling position in the stream is gone) and free the
        slots so the scheduler keeps serving later arrivals."""
        for s in range(self._S):
            if self._occupant[s] is not None:
                self._free_slot_on_error(s, e)

    def _device_fault(self, e: Exception) -> None:
        """A REAL kernel call raised (not an injected hook fault, which
        fires before the launch): the cache was updated in place by a
        call that stopped part way, so per-slot recovery is impossible —
        fail every resident over, zero the cache IN PLACE (every slot is
        free after the fan-out, so zeroes are the correct contents, and
        the captured step keeps its addresses), and drop the prefix
        pool, whose blocks lived in it. The scheduler then keeps serving
        later arrivals, with a cold prefix pool."""
        self._fail_occupants(e)
        if self._reset_cache is not None:
            try:
                self._reset_cache()
            except Exception:  # noqa: BLE001 — device fully down
                log.exception("cache reset after device fault failed")
        if self._pool is not None:
            self._pool.clear()

    def _retire(self, slot: int, reason: str) -> None:
        occ = self._occupant[slot]
        item, row = occ["item"], occ["row"]
        toks = occ["tokens"]
        item["out"][row, self._T:self._T + len(toks)] = toks
        # Terminal state BEFORE done.set(): a streaming item's
        # StreamDone reads it to build the END frame.
        item["finish_reason"] = reason
        self._active[slot] = False
        self._occupant[slot] = None
        self._release_block(occ)
        self.retired_total += 1
        _RETIRED.labels(reason=reason).inc()
        _TOKENS.inc(len(toks))
        # Completions feed the drain-rate window behind the shed
        # replies' x-tdn-retry-after-ms hint.
        self._sched_core.note_drained(1)
        if item["ctx"] is not None:
            _trace.TRACER.record_span(
                "decode", item["ctx"], occ["t_first"],
                time.monotonic() - occ["t_first"],
                attrs={"slot": slot, "steps": len(toks), "reason": reason},
            )
        item["remaining"] -= 1
        if item["remaining"] == 0 and not item["abandoned"]:
            item["done"].set()

    def _tier_keys(self, row: np.ndarray):
        """The prompt's cacheable-prefix candidates, longest first —
        the exact-match lookup/insert keys (the raw prefix bytes: no
        hash collisions to reason about). Lazy: ``lookup`` early-exits
        on the first (longest) hit, so a warm-pool deepest-tier hit
        copies exactly one prefix instead of materializing every tier
        of a long prompt on the scheduler loop thread."""
        return ((ln, row[:ln].tobytes()) for ln in self._tiers)

    def _bind_slot(self, item: dict, row: int,
                   resume: list | None = None) -> None:
        """Bind one pending row to a free slot (there is one — the
        caller checked): prefix-pool lookup, copy-on-write block copy
        on a hit, and the slot enters its chunked-prefill phase. No
        prompt tokens run here — chunks are the loop's per-iteration
        work, so binding never stalls the decode frontier.

        ``resume`` is a PREEMPTED row's generated token prefix: the
        slot re-prefills the prompt (prefix-cache hits make that
        cheap), then REPLAYS the prefix through the shared decode-step
        kernel with forced tokens — the exact computation the original
        run performed, so the resumed K/V and every subsequent greedy
        token are bit-identical to an unpreempted run (and a sampled
        run resumes its ORIGINAL stream instead of redrawing)."""
        slot = int(
            next(s for s in range(self._S) if self._occupant[s] is None)
        )
        now = time.monotonic()
        occ = {
            "item": item, "row": row, "tokens": [],
            "budget": item["budget"], "t_first": None,
            "t_bind": now, "fill": 0, "block": None,
            # Generated tokens to replay after the prompt re-prefill
            # (preemption resume); None on a fresh bind.
            "resume": list(resume) if resume else None,
        }
        self._occupant[slot] = occ
        self.rows_total += 1
        if item["ctx"] is not None and resume is None:
            _trace.TRACER.record_span(
                "queue_wait", item["ctx"], item["t_submit"],
                now - item["t_submit"],
            )
        if self._pool is None:
            return
        hit = self._pool.lookup(self._tier_keys(item["x"][row]))
        if hit is None:
            _PREFIX_MISSES.inc()
            return
        block, length = hit
        # Counted at lookup, BEFORE the copy, so this counter can never
        # diverge from the pool's own hits_total (which lookup() just
        # bumped) — a hit whose COW copy then faults is still a hit in
        # both ledgers.
        _PREFIX_HITS.inc()
        try:
            self._cache = self._copy(self._cache, self._S + block, slot)
        except Exception as e:  # noqa: BLE001 — cache in an unknown state: global
            occ["block"] = block
            self._device_fault(e)
            return
        occ["fill"] = length
        occ["block"] = block
        if self._gp_model is not None:
            # The hit's savings: the chunk launches that will never run
            # for positions [0, length) (counted as savings, never as
            # useful work — the work was NOT done).
            GOODPUT.record_prefix_saved(
                self._gp_model.prefill_chunks_flops(0, length, self._chunk)
            )
        slog.info(
            "gen.prefix_hit", slot=slot, block=block, prefix_len=length,
            suffix_len=self._T - length,
        )

    def _next_prefill_slot(self) -> int | None:
        """The next slot with prefill work, round-robin so concurrent
        long prompts chunk fairly instead of head-of-line blocking each
        other."""
        for i in range(self._S):
            s = (self._prefill_rr + i) % self._S
            occ = self._occupant[s]
            if occ is not None and not self._active[s] \
                    and occ["fill"] < self._T:
                self._prefill_rr = (s + 1) % self._S
                return s
        return None

    def _maybe_insert_tiers(self, slot: int, occ: dict, start: int) -> None:
        """After a chunk lands, publish any newly-completed prefix tier
        in ``(start, fill]`` into the pool (slot -> block copy). Failure
        to insert — pool full of referenced blocks, or a copy fault —
        skips silently: caching is an optimization, never load-bearing."""
        row = occ["item"]["x"][occ["row"]]
        for length in reversed(self._tiers):  # ascending
            if not start < length <= occ["fill"]:
                continue
            block, evicted = self._pool.insert(row[:length].tobytes(), length)
            if evicted:
                _PREFIX_EVICTIONS.inc()
            if block is None:
                continue
            try:
                self._cache = self._copy(self._cache, slot, self._S + block)
            except Exception as e:  # noqa: BLE001 — cache in an unknown state: global
                log.warning("prefix-block insert copy failed: %s", e)
                self._device_fault(e)
                return

    def _prefill_chunk_once(self, slot: int) -> None:
        """Run ONE chunk of ``slot``'s pending prefill — the at-most-
        one-chunk-per-iteration budget that keeps a long prompt from
        freezing the resident decode streams. The final chunk yields
        the prompt's last-position sample: the request's first token
        (TTFT), after which the slot joins the decode frontier."""
        occ = self._occupant[slot]
        item = occ["item"]
        start = occ["fill"]
        size = (
            self._T - start if self._chunk is None
            else min(self._chunk, self._T - start)
        )
        tokens = item["x"][occ["row"]:occ["row"] + 1, start:start + size]
        t0 = time.monotonic()
        if self.prefill_hook is not None:
            # Hook faults fire BEFORE the dispatch: the cache is still
            # intact, so only THIS request fails over — the mid-prefill
            # chaos contract (slot freed, prefix ref released).
            try:
                self.prefill_hook(tokens)
            except Exception as e:  # noqa: BLE001 — per item
                self._free_slot_on_error(slot, e)
                return
        try:
            tok, cache = self._prefill(
                self._params, self._cache, slot, tokens, start, None,
            )
        except Exception as e:  # noqa: BLE001 — cache in an unknown state: global
            self._device_fault(e)
            return
        self._cache = cache
        try:
            tok = int(tok)  # the token fetch (host sync)
        except Exception as e:  # noqa: BLE001 — cache in an unknown state: global
            # On a card a failed LAUNCH surfaces here, at the first host
            # sync of its results: a device fault, not a per-item one.
            self._device_fault(e)
            return
        occ["fill"] = start + size
        self.prefill_chunks_total += 1
        if self._gp_model is not None:
            # A resume re-prefill's last-position logits are DISCARDED
            # (the first generated token is already known), so its
            # final chunk carries no sampled-unembed useful work.
            GOODPUT.record_prefill_chunk(
                self._gp_model, start, size,
                final=occ["fill"] >= self._T and occ["resume"] is None,
            )
        now = time.monotonic()
        if item["ctx"] is not None:
            _trace.TRACER.record_span(
                "prefill.chunk", item["ctx"], t0, now - t0,
                attrs={"slot": slot, "start": start, "tokens": size},
            )
        if self._pool is not None:
            self._maybe_insert_tiers(slot, occ, start)
            if self._occupant[slot] is not occ:
                return  # an insert-copy fault failed the slot over
        if occ["fill"] < self._T:
            return
        if occ["resume"] is not None:
            # Preemption resume: the first generated token is KNOWN —
            # the prefill's last-position sample is discarded, the
            # remaining prefix replays through the shared step kernel
            # with forced tokens (bit-identical K/V to the original
            # run; TTFT was observed on the first pass and is not
            # re-counted).
            known = occ["resume"]
            occ["resume"] = None
            occ["replay"] = known[1:]
            first = int(known[0])
            occ["t_first"] = now
            if item["ctx"] is not None:
                _trace.TRACER.record_span(
                    "prefill", item["ctx"], occ["t_bind"],
                    now - occ["t_bind"],
                    attrs={
                        "slot": slot, "prompt_len": self._T,
                        "prefix_hit": occ["block"] is not None,
                        "resume_tokens": len(known),
                    },
                )
            occ["tokens"].append(first)
            self._publish(occ)
            self._active[slot] = True
            self._pos[slot] = self._T
            self._tok[slot] = first
            return
        # Prefill complete: `tok` is the sample from the prompt's last
        # position — the first generated token.
        ttft = now - item["t_submit"]
        _TTFT.observe(ttft)
        self.ttft_recent.append(ttft)
        occ["t_first"] = now
        if item["ctx"] is not None:
            _trace.TRACER.record_span(
                "prefill", item["ctx"], occ["t_bind"], now - occ["t_bind"],
                attrs={
                    "slot": slot, "prompt_len": self._T,
                    "prefix_hit": occ["block"] is not None,
                },
            )
        occ["tokens"].append(tok)
        self._publish(occ)
        self._active[slot] = True
        self._pos[slot] = self._T
        self._tok[slot] = tok
        if self._eos is not None and tok == self._eos:
            self._retire(slot, "eos")
        elif len(occ["tokens"]) >= occ["budget"]:
            self._retire(slot, "max_tokens")

    def _step_once(self) -> None:
        """One step over every decoding slot; retire/refill happens on
        the host between steps (the iteration-level boundary)."""
        t0 = time.monotonic()
        traced = [
            self._occupant[s] for s in range(self._S)
            if self._active[s] and self._occupant[s]["item"]["ctx"] is not None
        ]
        def fail(e: Exception, kernel: bool) -> None:
            # Rate-limited: a wedged backend fails every subsequent
            # step too — the first few stack traces are the signal,
            # thousands more per minute are noise.
            slog.exception(
                "gen.step_failed", error=f"{type(e).__name__}: {e}",
                active_slots=int(self._active.sum()),
                steps_total=self.batches_total,
            )
            # A raise from the step itself may have left the cache half
            # written; hook faults leave it intact.
            self._device_fault(e) if kernel else self._fail_occupants(e)

        if self.launch_hook is not None:
            try:
                self.launch_hook(self._tok)
            except Exception as e:  # noqa: BLE001 — fan out to occupants
                fail(e, kernel=False)
                return
        try:
            toks, ok, cache = self._step(
                self._params, self._cache, self._pos, self._active,
                self._tok, None,
            )
        except Exception as e:  # noqa: BLE001 — fan out to occupants
            fail(e, kernel=True)
            return
        self._cache = cache
        if self.fetch_hook is not None:
            try:
                self.fetch_hook(toks)
            except Exception as e:  # noqa: BLE001 — fan out to occupants
                fail(e, kernel=False)
                return
        try:
            toks, ok = self._fetch(toks, ok)
        except Exception as e:  # noqa: BLE001 — fan out to occupants
            # A card surfaces a failed launch at this first host sync:
            # recover as a device fault (kernel=True), unlike the
            # pre-sync hook fault above which leaves the cache intact.
            fail(e, kernel=True)
            return
        # Act on the in-step numeric guard (a host decision: the runtime
        # opt-out never changes the captured step): a slot
        # whose logits went non-finite fails over ALONE with INTEGRITY
        # before its garbage token ships; every other slot's stream is
        # untouched (bit-parity preserved).
        bad_slots: list[int] = []
        if ok is not None and _integrity.GUARD.enabled:
            bad_slots = [
                s for s in range(self._S)
                if self._active[s] and not ok[s]
            ]
        if bad_slots:
            _integrity.GUARD_ROWS_FAILED.inc(len(bad_slots))
            _integrity.GUARD_LAUNCHES.inc()
            for s in bad_slots:
                slog.warning(
                    "gen.integrity_guard_tripped", slot=s,
                    tokens_generated=len(self._occupant[s]["tokens"]),
                )
                self._free_slot_on_error(s, IntegrityError(
                    f"numeric guard: decode step produced non-finite "
                    f"logits for slot {s} — failing this row instead "
                    f"of shipping a garbage token"
                ))
        self.batches_total += 1
        active = int(self._active.sum())
        self.slot_steps_total += active
        self._m_rows.observe(active)
        if self._gp_model is not None:
            # Goodput split of this launch at slot granularity (Orca's
            # waste taxonomy): active lanes are useful up to their live
            # attention frontier (launch-time pos — read BEFORE the
            # retire loop advances it), occupied-but-chunking lanes are
            # mid_prefill pad, empty lanes idle pad.
            active_pos = []
            idle = mid = replay = 0
            for s in range(self._S):
                if self._active[s]:
                    if self._occupant[s].get("replay"):
                        # Re-doing work the preemption threw away:
                        # booked as pad (reason preempt_replay), never
                        # as useful.
                        replay += 1
                    else:
                        active_pos.append(int(self._pos[s]))
                elif self._occupant[s] is None:
                    idle += 1
                else:
                    mid += 1
            GOODPUT.record_decode_step(
                self._gp_model, active_pos, idle, mid,
                replay_slots=replay,
            )
        dur = time.monotonic() - t0
        for occ in traced:
            if occ["item"]["err"] is not None:
                continue
            _trace.TRACER.record_span(
                "decode.step", occ["item"]["ctx"], t0, dur,
                attrs={"active_slots": active},
            )
        for s in range(self._S):
            if not self._active[s]:
                continue
            occ = self._occupant[s]
            if occ.get("replay"):
                # Preemption replay: the step WROTE this position's
                # K/V from the forced token (the same computation the
                # original run performed); its sample is discarded —
                # the next token is already known. No retire checks:
                # the replayed stream was mid-decode when preempted.
                forced = int(occ["replay"].pop(0))
                occ["tokens"].append(forced)
                self._publish(occ)
                self._pos[s] += 1
                self._tok[s] = forced
                continue
            tok = int(toks[s])
            occ["tokens"].append(tok)
            self._publish(occ)
            self._pos[s] += 1
            self._tok[s] = tok
            if self._eos is not None and tok == self._eos:
                self._retire(s, "eos")
            elif len(occ["tokens"]) >= occ["budget"]:
                self._retire(s, "max_tokens")

    def _resident(self) -> bool:
        """Any slot occupied — decoding or mid-prefill (both must drain
        before close() may stop the loop)."""
        return any(o is not None for o in self._occupant)

    def _next_bindable(self, max_rank: int | None = None):  # caller-holds: _cond
        """The next row to bind, in class-priority order across BOTH
        sources — preempted rows awaiting resume and the fresh queue
        (a tie goes to the resume row: it was admitted earlier).
        ``max_rank=0`` restricts to critical (the preemption pop).
        Returns ``("resume", entry)`` / ``("fresh", (item, row))`` /
        None."""
        core = self._sched_core
        while True:
            # Best-ranked resume entry, FIFO within rank: _resume is
            # one deque in preemption order, so a head-only peek would
            # let an earlier best_effort eviction shadow a later
            # standard one.
            entry = idx = None
            e_rank = 99
            for i, cand in enumerate(self._resume):
                r = CLASS_RANK.get(cand["slo_class"], 1)
                if max_rank is not None and r > max_rank:
                    continue
                if r < e_rank:
                    entry, idx, e_rank = cand, i, r
                    if r == 0:
                        break  # nothing outranks critical
            f_rank = core.peek_rank()
            if (f_rank is not None and max_rank is not None
                    and f_rank > max_rank):
                f_rank = None
            if entry is not None and (f_rank is None or e_rank <= f_rank):
                del self._resume[idx]
                item = entry["item"]
                if item["abandoned"] or item["err"] is not None:
                    continue  # waiter gone while awaiting resume
                dl = item.get("deadline")
                if dl is not None and time.monotonic() >= dl:
                    # Budget died while the row waited to resume: same
                    # expiry contract as a queued entry.
                    core._expire(item, time.monotonic())
                    continue
                return "resume", entry
            got = core.pop_row(max_rank=max_rank)
            if got is not None:
                return "fresh", got
            if entry is None:
                return None
            # Fresh queue exhausted (or all dead): retry the resume
            # head on the next pass.

    def _bind(self, bindable) -> None:
        kind, data = bindable
        if kind == "resume":
            self._bind_slot(data["item"], data["row"],
                            resume=data["tokens"])
        else:
            item, row = data
            # A streaming failover resume (submit_stream's
            # resume_tokens) rides the SAME replay path a preemption
            # victim uses: re-prefill the prompt, force-replay the
            # already-delivered tokens, continue bit-identically.
            self._bind_slot(item, row,
                            resume=item.pop("resume_tokens", None))

    def _pick_victim(self) -> int | None:
        """The slot to preempt for a critical bind: never a critical
        resident; prefer occupants whose waiter is already gone
        (abandoned / budget-expired — evicting them costs nothing),
        then the LOWEST class, then the fewest generated tokens (the
        cheapest replay). None when every resident is critical."""
        now = time.monotonic()
        best = best_key = None
        for s in range(self._S):
            occ = self._occupant[s]
            if occ is None:
                continue
            item = occ["item"]
            rank = CLASS_RANK.get(item.get("slo_class", "standard"), 1)
            if rank == 0:
                continue
            dl = item.get("deadline")
            dead = item["abandoned"] or (dl is not None and now >= dl)
            key = (0 if dead else 1, -rank, len(occ["tokens"]))
            if best_key is None or key < best_key:
                best_key, best = key, s
        return best

    def _preempt_slot(self, slot: int) -> None:
        """Evict one resident so a critical row can bind: the victim's
        prompt + generated prefix re-queue for resume (re-prefill +
        forced-token replay — bit-identical continuation), its slot
        and prefix-block reference free immediately."""
        now = time.monotonic()
        occ = self._occupant[slot]
        item = occ["item"]
        cls = item.get("slo_class", "standard")
        # The full known generated stream, whatever phase the victim
        # was in: mid-resume-prefill (resume holds it all), mid-replay
        # (tokens + the un-replayed remainder), or plain decoding.
        if occ.get("resume"):
            prefix = list(occ["resume"])
        else:
            prefix = list(occ["tokens"]) + list(occ.get("replay") or ())
        self._occupant[slot] = None
        self._active[slot] = False
        self._release_block(occ)
        self.preempted_total += 1
        _PREEMPTED.labels(slo_class=cls).inc()
        if item["ctx"] is not None and occ["t_first"] is not None:
            _trace.TRACER.record_span(
                "decode", item["ctx"], occ["t_first"],
                now - occ["t_first"],
                attrs={"slot": slot, "steps": len(occ["tokens"]),
                       "reason": "preempted"},
            )
        slog.info(
            "gen.preempted", slot=slot, slo_class=cls,
            tokens_generated=len(prefix),
        )
        if item["abandoned"] or item["err"] is not None:
            return  # nobody is waiting: evicted work is simply dropped
        with self._cond:
            self._resume.append({
                "item": item, "row": occ["row"], "tokens": prefix,
                "slo_class": cls,
            })

    def _preempt_for_critical(self) -> None:
        """While a critical row is queued with no free slot, evict the
        best victim and bind the critical row INTO the freed slot —
        same scheduler iteration, so the class the SLO pages on never
        waits out a lower-class resident's full decode."""
        while True:
            victim = self._pick_victim()
            if victim is None:
                return
            with self._cond:
                got = self._next_bindable(max_rank=0)
            if got is None:
                return
            self._preempt_slot(victim)
            self._bind(got)

    def _loop(self) -> None:
        # The loop thread owns the card: its current device is the
        # cache's, and autograd stays off (grad mode is per thread).
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        with torch.no_grad():
            self._serve()

    def _serve(self) -> None:
        core = self._sched_core
        while True:
            # Cancel propagation first: slots freed by dead streams are
            # bindable THIS iteration (a cancel storm must not strand
            # slots for even one extra step).
            self._reap_cancelled()
            admits = []
            with self._cond:
                while (not core.closed and not core.has_pending()
                       and not self._resume and not self._resident()
                       and self._warm_req is None):
                    self._cond.wait()
                warm, self._warm_req = self._warm_req, None
                if core.closed and not self._resident() and warm is None:
                    return  # close() sweeps whatever is still pending
                if not core.closed:
                    free = sum(1 for o in self._occupant if o is None)
                    while len(admits) < free:
                        got = self._next_bindable()
                        if got is None:
                            break
                        admits.append(got)
            core.drain_deferred()
            if warm is not None:
                done, box = warm
                try:
                    box["warmed"] = self._warm_kernels()
                except Exception as e:  # noqa: BLE001 — handed to warm()
                    box["err"] = e
                done.set()
            # Device work OUTSIDE the lock: submitters must never block
            # behind a block copy, a prefill chunk, or a step.
            for bindable in admits:
                self._bind(bindable)
            if not core.closed:
                self._preempt_for_critical()
            slot = self._next_prefill_slot()
            if slot is not None:
                self._prefill_chunk_once(slot)
            if self._active.any():
                self._step_once()

    # ------------------------------------------------------------ close

    def close(self, timeout: float = 10.0) -> None:
        """Stop admitting, let resident rows — including half-prefilled
        slots, which finish their remaining chunks — complete their
        (bounded) decodes, then fail still-pending waiters over as
        UNAVAILABLE (preempted rows awaiting resume included): the
        ``Batcher.close`` contract ``GracefulDrain`` relies on."""
        self._sched_core.close_begin()
        self._thread.join(timeout=timeout)
        # Preempted rows still awaiting a resume slot are pending too:
        # their waiters fail over like any queued entry's. Popped
        # under _cond, so a still-alive (wedged past the join timeout)
        # loop thread and this sweep can never double-serve or strand
        # an entry.
        leftovers = []
        with self._cond:
            while self._resume:
                leftovers.append(self._resume.popleft())
        for entry in leftovers:
            item = entry["item"]
            if not item["abandoned"] and item["err"] is None:
                item["err"] = UnavailableError(
                    "server shut down before this request was served"
                )
                item["done"].set()
        self._sched_core.sweep_leftovers()

    def join(self, timeout: float | None = None) -> bool:
        """Wait for the loop thread to end; True when it has."""
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()


def _fetch_host(toks, ok):
    """The injected kernels' fetch: their results as host numpy."""
    return np.asarray(toks), (np.asarray(ok) if ok is not None else None)
