"""Goodput and MFU accounting: how much of the card the live workload
uses, and where the rest went.

Port of :mod:`tpu_dist_nn.obs.goodput`:

* **Analytic per-launch FLOP models** — :func:`fcnn_flops_per_row` for
  the dense chain and :class:`LMFlopModel` for the generation kernels.
  Counts are matmul FLOPs (2mnk) at the STATIC shapes the device
  launches: a decode step attends over the full cache extent and a
  prefill chunk's scores span the whole key ladder, masked; masked
  lanes still cost the card, and that structural waste is what this
  plane exposes. Elementwise, layer-norm and softmax work is excluded.
* **Exact useful / pad split** — every recorded launch's FLOPs divide
  into ``useful + pad == total`` BY CONSTRUCTION (pad is the remainder
  of the same integer model), so conservation is testable to the FLOP.
  Pad carries a reason (``pad_rows``, ``idle_slot``,
  ``mid_prefill_slot``, ``attn_tail``, ``chunk_tail``, ``eos_frozen``,
  ``preempt_replay``, ``dead_waiter``) and a path (``batcher``,
  ``gen``, ``engine``).
* **One peak calibration** — :data:`PEAK_FLOPS` holds the card's table
  (the H100 SXM's dense BF16 and FP32 rates, picked by the workload's
  compute dtype); :func:`host_calibration_gflops` measures the host's
  BLAS, the peak on the CPU.

Exports: ``tdn_goodput_flops_total{kind=useful|pad}``, ``tdn_mfu_ratio``
(refreshed by :meth:`GoodputTracker.tick`: plain float math),
``tdn_pad_ratio{path}``, ``tdn_prefix_flops_saved_total`` (prefill FLOPs
a prefix-cache hit made unnecessary: savings, never useful work), and
:meth:`GoodputTracker.snapshot`, the per-stage breakdown.

Cost: recording is a handful of integer adds per DEVICE LAUNCH on the
thread that owns the launch.
"""

from __future__ import annotations

import threading
import time

from tpu_dist_nn_torch.obs.registry import REGISTRY, Registry

# Peak dense FLOP/s per card, by ``torch.cuda.get_device_name`` substring
# and compute dtype (NVIDIA's H100 SXM figures: BF16 tensor cores without
# sparsity, FP32 on the CUDA cores). The first match wins.
PEAK_FLOPS = (
    ("h100", {"bfloat16": 989e12, "float32": 67e12}),
)


def device_peak_flops(device_kind: str | None, dtype: str = "bfloat16") -> float | None:
    """Table peak for a device name (substring match) in ``dtype``
    (``"bfloat16"`` or ``"float32"``), or None."""
    if not device_kind:
        return None
    kind = device_kind.lower()
    for key, peaks in PEAK_FLOPS:
        if key in kind:
            return peaks.get(dtype)
    return None


def host_calibration_gflops(reps: int = 5) -> float:
    """Fixed host-BLAS anchor: f32 1024^2 matmul GFLOP/s, min-of-reps.

    numpy only, so it measures the BOX, not the framework; it is the
    measured peak for CPU MFU: off the card the best this host can do at
    a dense matmul IS the denominator utilization is judged against.
    """
    import numpy as np

    a = np.ones((1024, 1024), np.float32)
    b = np.ones((1024, 1024), np.float32)
    a @ b  # warm the BLAS path
    best = float("inf")
    for _ in range(reps):
        t0 = time.monotonic()
        a @ b
        best = min(best, time.monotonic() - t0)
    return 2 * 1024**3 / best / 1e9


_HOST_PEAK_CACHE: list[float] = []
_HOST_PEAK_LOCK = threading.Lock()


def measured_host_peak_flops() -> float:
    """One-shot cached host-BLAS peak in FLOP/s (the CPU-fallback MFU
    denominator). Measured at configure time, never on a sampler tick."""
    with _HOST_PEAK_LOCK:
        if not _HOST_PEAK_CACHE:
            _HOST_PEAK_CACHE.append(host_calibration_gflops() * 1e9)
        return _HOST_PEAK_CACHE[0]


def resolve_peak(device_kind: str | None = None, dtype: str = "bfloat16") -> tuple[float, str]:
    """``(peak_flops, source)``: the table entry for ``device_kind`` when
    it names a known card, else the measured host anchor. ``source``
    records which."""
    peak = device_peak_flops(device_kind, dtype)
    if peak is not None:
        return peak, f"table:{device_kind}:{dtype}"
    return measured_host_peak_flops(), "measured-host-blas"


# ---------------------------------------------------------------- models


def fcnn_flops_per_row(dims) -> int:
    """Matmul FLOPs for ONE row through a dense chain with layer widths
    ``dims = [d0, d1, ..., dk]``: sum of 2*a*b per layer (the standard
    dense count; bias adds and activations excluded)."""
    dims = [int(d) for d in dims]
    return sum(2 * a * b for a, b in zip(dims, dims[1:]))


class LMFlopModel:
    """Analytic FLOPs for the transformer generation kernels at their
    STATIC launch shapes (models/generate.py).

    Per token, per layer: QKV+output projections cost ``8*d^2``, the
    FFN ``4*d*f``; attention scores+apply cost ``4*d`` per KEY POSITION
    in the einsum — the static kernels compute the full ``cache_extent``
    key ladder and mask, so a launch's TOTAL counts every position
    while its USEFUL counts only the causally-live ones (the dead tail
    is ``attn_tail`` pad). The unembed costs ``2*d*V`` per position;
    only sampled positions (the decode token, a final chunk's last
    position) count as useful — the rest is ``chunk_tail``.

    All quantities are exact python ints so the useful+pad==total
    conservation contract is testable without float slop.
    """

    def __init__(self, n_layers: int, d_model: int, d_ff: int,
                 vocab_size: int, cache_extent: int):
        self.L = int(n_layers)
        self.d = int(d_model)
        self.f = int(d_ff)
        self.V = int(vocab_size)
        self.M = int(cache_extent)
        # Per-token constants (see class docstring).
        self._proj = self.L * (8 * self.d * self.d + 4 * self.d * self.f)
        self._attn_per_key = 4 * self.d * self.L
        self._logit = 2 * self.d * self.V

    @classmethod
    def from_config(cls, cfg, cache_extent: int) -> "LMFlopModel":
        return cls(cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size,
                   cache_extent)

    # -- decode step (decode_step_slots: one token per slot) ----------
    def step_flops(self) -> int:
        """Static per-slot cost of one decode-step launch."""
        return self._proj + self._attn_per_key * self.M + self._logit

    def step_useful_flops(self, pos: int) -> int:
        """Live per-slot cost at position ``pos`` (attends ``pos + 1``
        keys; its logits are sampled)."""
        return self._proj + self._attn_per_key * (int(pos) + 1) + self._logit

    def steps_useful_sum(self, start_pos: int, n_steps: int) -> int:
        """Sum of :meth:`step_useful_flops` over positions
        ``start_pos .. start_pos + n_steps - 1`` (closed form)."""
        n = int(n_steps)
        if n <= 0:
            return 0
        keys = n * int(start_pos) + n * (n + 1) // 2  # sum of (pos + 1)
        return n * (self._proj + self._logit) + self._attn_per_key * keys

    # -- prefill chunk (prefill_chunk_into_cache) ---------------------
    def chunk_flops(self, size: int) -> int:
        """Static cost of one chunk launch of ``size`` tokens: every
        query scores the full ``cache_extent`` key ladder and the
        unembed is expressed over all ``size`` positions."""
        c = int(size)
        return c * (self._proj + self._attn_per_key * self.M + self._logit)

    def chunk_useful_flops(self, start: int, size: int,
                           final: bool) -> int:
        """Live cost of that chunk: query ``i`` (absolute position
        ``start + i``) attends ``start + i + 1`` keys; only the FINAL
        chunk's last-position logits are sampled."""
        c, s = int(size), int(start)
        keys = c * s + c * (c + 1) // 2
        return (c * self._proj + self._attn_per_key * keys
                + (self._logit if final else 0))

    def prefill_chunks_flops(self, start: int, end: int,
                             chunk: int | None) -> int:
        """Static cost of the chunk launches covering token span
        ``[start, end)`` under a ``prefill_chunk`` budget (None = one
        monolithic chunk) — what a prefix hit of ``end - start`` tokens
        SAVES."""
        total = 0
        pos = int(start)
        end = int(end)
        while pos < end:
            c = end - pos if chunk is None else min(int(chunk), end - pos)
            total += self.chunk_flops(c)
            pos += c
        return total


# --------------------------------------------------------------- tracker


class GoodputTracker:
    """Process-wide FLOP ledger behind the goodput metric families.

    ``record_*`` calls run on the thread that owns the launch (batcher
    dispatch, scheduler loop, engine caller) and cost a few integer
    adds under one lock; :meth:`tick` runs on the runtime-sampler tick
    and only does float math over the ledger (tick-pure — peak
    calibration happens in :meth:`ensure_peak` at configure time).
    ``enabled = False`` turns every record into a no-op (the disarmed
    arm of an overhead A/B).
    """

    def __init__(self, registry: Registry | None = None):
        reg = registry if registry is not None else REGISTRY
        self._lock = threading.Lock()
        self.enabled = True
        # Integer FLOP ledgers (exact conservation is asserted on these;
        # the registry counters are their float mirrors).
        self._paths: dict[str, list[int]] = {}  # guarded-by: _lock
        self._stages: dict[str, list[int]] = {}  # guarded-by: _lock
        self._reasons: dict[str, int] = {}  # guarded-by: _lock
        self._saved = 0  # guarded-by: _lock
        self._launches = 0  # guarded-by: _lock
        self._peak: float | None = None  # guarded-by: _lock
        self._peak_source: str | None = None  # guarded-by: _lock
        self._tick_state: tuple[float, int] | None = None  # guarded-by: _lock
        self._last_mfu = 0.0  # guarded-by: _lock
        fam = reg.counter(
            "tdn_goodput_flops_total",
            "analytic model FLOPs by the live workload's device "
            "launches, split exactly into useful work vs structural "
            "pad (bucket pad rows, idle/frozen slots, masked attention "
            "tails)",
            labels=("kind",),
        )
        self._c_useful = fam.labels(kind="useful")
        self._c_pad = fam.labels(kind="pad")
        self._c_saved = reg.counter(
            "tdn_prefix_flops_saved_total",
            "prefill FLOPs skipped via prefix-cache hits (savings — "
            "work NOT done; never counted in tdn_goodput_flops_total)",
        )
        self._g_mfu = reg.gauge(
            "tdn_mfu_ratio",
            "useful model FLOPs per second over the last sampler "
            "window, divided by the resolved hardware peak (table for "
            "a known accelerator, measured host-BLAS anchor on the "
            "CPU fallback); 0 while idle",
        )
        self._g_pad = reg.gauge(
            "tdn_pad_ratio",
            "cumulative pad / (useful + pad) FLOP share per "
            "accounting path (batcher = Process coalescer buckets, "
            "gen = generation schedulers, engine = direct host-fed "
            "calls)",
            labels=("path",),
        )

    # ------------------------------------------------------------ peak

    def set_peak(self, peak_flops: float, source: str) -> None:
        with self._lock:
            self._peak = float(peak_flops)
            self._peak_source = source

    def ensure_peak(self, device_kind: str | None = None,
                    device_count: int | None = None,
                    dtype: str = "bfloat16") -> float:
        """Resolve the peak: the card's table entry in ``dtype`` (the
        workload's compute dtype) times the DEVICE COUNT it launches
        over, else the measured host anchor (the CPU: no multiplier).
        ``device_kind`` defaults to ``torch.cuda.get_device_name(0)``
        when a card is visible, ``device_count`` to the visible cards.
        The LARGEST peak configured so far wins: MFU is never overstated
        by a smaller later placement. Called at CONFIGURE time
        (scheduler and server construction): the host measurement is a
        real matmul and never rides a tick."""
        kind = device_kind
        if kind is None:
            try:
                import torch

                if torch.cuda.is_available():
                    kind = torch.cuda.get_device_name(0)
                    if device_count is None:
                        device_count = torch.cuda.device_count()
            except Exception:  # noqa: BLE001 — no card: the host anchor
                kind = None
        per_device = device_peak_flops(kind, dtype)
        if per_device is not None:
            n = max(int(device_count or 1), 1)
            peak = per_device * n
            source = f"table:{kind}:{dtype}" + (f" x{n}" if n > 1 else "")
        else:
            peak = measured_host_peak_flops()
            source = "measured-host-blas"
        with self._lock:
            if self._peak is not None and peak <= self._peak:
                return self._peak
            self._peak = peak
            self._peak_source = source
            return peak

    # ---------------------------------------------------------- record

    def _add(self, stage: str, path: str, useful: int,
             pads: dict[str, int]) -> None:
        pad = sum(pads.values())
        with self._lock:
            self._launches += 1
            st = self._stages.setdefault(stage, [0, 0, 0])
            st[0] += useful
            st[1] += pad
            st[2] += 1
            pp = self._paths.setdefault(path, [0, 0])
            pp[0] += useful
            pp[1] += pad
            for reason, v in pads.items():
                self._reasons[reason] = self._reasons.get(reason, 0) + v
        if useful:
            self._c_useful.inc(useful)
        if pad:
            self._c_pad.inc(pad)

    def record_rows(self, flops_per_row: int, total_rows: int,
                    useful_rows: int, *, path: str = "engine",
                    stage: str = "infer",
                    reason: str = "pad_rows") -> None:
        """One row-shaped launch (the FCNN paths): ``total_rows`` went
        to the device, ``useful_rows`` of them carried request data —
        the remainder is bucket/shard pad."""
        if not self.enabled or flops_per_row <= 0 or total_rows <= 0:
            return
        useful_rows = max(0, min(int(useful_rows), int(total_rows)))
        useful = int(flops_per_row) * useful_rows
        pad = int(flops_per_row) * (int(total_rows) - useful_rows)
        self._add(stage, path, useful, {reason: pad} if pad else {})

    def record_decode_step(self, model: LMFlopModel, active_pos,
                           idle_slots: int, mid_prefill_slots: int, *,
                           replay_slots: int = 0,
                           path: str = "gen") -> None:
        """One ``decode_step_slots`` launch: ``active_pos`` is the
        launch-time position of every ACTIVE slot; inactive lanes split
        into empty (``idle_slot``) and occupied-but-still-prefilling
        (``mid_prefill_slot``); active lanes' dead key extent is
        ``attn_tail``. ``replay_slots`` are active lanes re-running
        tokens a preemption threw away (``preempt_replay`` — work
        re-done, never useful twice)."""
        if not self.enabled:
            return
        sf = model.step_flops()
        useful = sum(model.step_useful_flops(p) for p in active_pos)
        pads: dict[str, int] = {}
        if idle_slots > 0:
            pads["idle_slot"] = int(idle_slots) * sf
        if mid_prefill_slots > 0:
            pads["mid_prefill_slot"] = int(mid_prefill_slots) * sf
        if replay_slots > 0:
            pads["preempt_replay"] = int(replay_slots) * sf
        tail = len(list(active_pos)) * sf - useful
        if tail > 0:
            pads["attn_tail"] = tail
        self._add("decode", path, useful, pads)

    def record_prefill_chunk(self, model: LMFlopModel, start: int,
                             size: int, final: bool, *,
                             path: str = "gen") -> None:
        """One prefill-chunk launch: the masked key tail and the
        non-sampled unembed positions are ``chunk_tail`` pad."""
        if not self.enabled:
            return
        total = model.chunk_flops(size)
        useful = model.chunk_useful_flops(start, size, final)
        tail = total - useful
        self._add("prefill", path, useful,
                  {"chunk_tail": tail} if tail > 0 else {})

    def record_static_generate(self, model: LMFlopModel, outputs,
                               useful_rows: int, total_rows: int,
                               prompt_len: int,
                               eos_id: int | None, *,
                               dead_rows: int = 0,
                               path: str = "gen") -> None:
        """One run-to-completion Generate launch (the static scheduler
        behind the ``Batcher``): ``outputs (total_rows, T + N)`` are the
        materialized sequences. Bucket pad rows cost their full
        prefill+decode; real rows split per token — positions after a
        row's first EOS are ``eos_frozen`` pad (the done-mask keeps
        decoding them), masked attention tails are ``attn_tail``, the
        prefill's non-final logits/tail ``chunk_tail``. ``dead_rows``
        of the useful rows had waiters that abandoned after dispatch
        (the one window deadline expiry cannot close): their full ride
        is ``dead_waiter`` pad, never useful."""
        if not self.enabled or total_rows <= 0:
            return
        import numpy as np

        out = np.asarray(outputs)
        T = int(prompt_len)
        width = int(out.shape[1]) if out.ndim == 2 else 0
        steps = max(width - T - 1, 0)  # decode steps after the prefill
        n_gen = width - T  # tokens per row (first one from the prefill)
        useful_rows = max(0, min(int(useful_rows), int(total_rows)))
        pad_rows = int(total_rows) - useful_rows
        dead_rows = max(0, min(int(dead_rows), useful_rows))
        useful_rows -= dead_rows
        prefill_total = model.chunk_flops(T)
        prefill_useful = model.chunk_useful_flops(0, T, final=True)
        sf = model.step_flops()
        # Per-row useful token counts (first EOS inclusive; everything
        # after it is frozen).
        if useful_rows and n_gen > 0:
            gen = out[:useful_rows, T:]
            if eos_id is None:
                useful_tokens = np.full(useful_rows, n_gen, np.int64)
            else:
                hit = gen == int(eos_id)
                found = hit.any(axis=1)
                first = hit.argmax(axis=1)
                useful_tokens = np.where(found, first + 1, n_gen)
        else:
            useful_tokens = np.zeros(0, np.int64)
        pre_pads: dict[str, int] = {}
        dec_pads: dict[str, int] = {}
        if pad_rows:
            pre_pads["pad_rows"] = pad_rows * prefill_total
            if steps:
                dec_pads["pad_rows"] = pad_rows * steps * sf
        if dead_rows:
            # Full static ride at pad cost: the launch happened, nobody
            # was waiting for these rows' results.
            pre_pads["dead_waiter"] = dead_rows * prefill_total
            if steps:
                dec_pads["dead_waiter"] = dead_rows * steps * sf
        pre_tail = useful_rows * (prefill_total - prefill_useful)
        if pre_tail > 0:
            pre_pads["chunk_tail"] = pre_tail
        dec_useful = 0
        frozen = attn_tail = 0
        for k in useful_tokens:
            u_steps = max(int(k) - 1, 0)  # steps producing useful tokens
            row_useful = model.steps_useful_sum(T, u_steps)
            dec_useful += row_useful
            frozen += (steps - u_steps) * sf
            attn_tail += u_steps * sf - row_useful
        if frozen > 0:
            dec_pads["eos_frozen"] = frozen
        if attn_tail > 0:
            dec_pads["attn_tail"] = attn_tail
        self._add("prefill", path, useful_rows * prefill_useful, pre_pads)
        if steps or dec_pads:
            self._add("decode", path, dec_useful, dec_pads)

    def record_prefix_saved(self, flops: int) -> None:
        if not self.enabled or flops <= 0:
            return
        with self._lock:
            self._saved += int(flops)
        self._c_saved.inc(int(flops))

    # ------------------------------------------------------------ tick

    def tick(self, now: float | None = None) -> None:
        """The runtime-sampler callback: refresh ``tdn_mfu_ratio``
        (windowed useful-FLOP rate over resolved peak) and the per-path
        ``tdn_pad_ratio`` gauges. Pure ledger math — no calibration, no
        blocking call, no device work."""
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            useful_total = sum(p[0] for p in self._paths.values())
            paths = {k: (v[0], v[1]) for k, v in self._paths.items()}
            peak = self._peak
            last = self._tick_state
            self._tick_state = (t, useful_total)
            mfu = 0.0
            if last is not None and peak:
                dt = t - last[0]
                if dt > 0:
                    mfu = max((useful_total - last[1]) / (peak * dt), 0.0)
            self._last_mfu = mfu
        self._g_mfu.set(mfu)
        for path, (u, p) in paths.items():
            total = u + p
            self._g_pad.labels(path=path).set(p / total if total else 0.0)

    # -------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        """The ``GET /goodput`` document: per-stage and per-path FLOP
        breakdown whose shares sum to 1, plus the peak provenance."""
        with self._lock:
            paths = {k: list(v) for k, v in self._paths.items()}
            stages = {k: list(v) for k, v in self._stages.items()}
            reasons = dict(self._reasons)
            saved = self._saved
            launches = self._launches
            peak = self._peak
            source = self._peak_source
            mfu = self._last_mfu
        useful = sum(v[0] for v in paths.values())
        pad = sum(v[1] for v in paths.values())
        total = useful + pad
        return {
            "enabled": self.enabled,
            "peak_flops": peak,
            "peak_source": source,
            "launches": launches,
            "mfu": mfu,
            "pad_ratio": pad / total if total else 0.0,
            "flops": {
                "useful": useful,
                "pad": pad,
                "total": total,
                "prefix_saved": saved,
            },
            "shares": {
                "useful": useful / total if total else 0.0,
                "pad": pad / total if total else 0.0,
            },
            "paths": {
                k: {
                    "useful": v[0],
                    "pad": v[1],
                    "pad_ratio": v[1] / (v[0] + v[1]) if v[0] + v[1] else 0.0,
                }
                for k, v in paths.items()
            },
            "stages": {
                k: {
                    "useful": v[0],
                    "pad": v[1],
                    "total": v[0] + v[1],
                    "share": (v[0] + v[1]) / total if total else 0.0,
                    "launches": v[2],
                }
                for k, v in stages.items()
            },
            "pad_reasons": reasons,
        }


# The process-wide tracker the serving/engine wiring records into and
# ``GET /goodput`` / the runtime sampler read from (the REGISTRY /
# TRACER convention). Tests build private ``GoodputTracker(registry=)``
# instances for isolation.
GOODPUT = GoodputTracker()
