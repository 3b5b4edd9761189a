"""Background runtime sampler: the gauges nobody increments.

Counters and histograms are pushed by the code paths that own the
events; STATE (queue depth, rows in flight on the device, coalescing
efficiency, memory) has no event to hook, so a daemon thread samples
it on an interval. Everything read here is a plain python attribute
or a host query — sampling never blocks the batcher or dispatches
device work (``torch.cuda.memory_stats`` reads the caching allocator's
host-side counters, not the card).

Port of :mod:`tpu_dist_nn.obs.runtime`: the same families, labels and
tick order; device memory is labelled ``device="cuda:K"``.
"""

from __future__ import annotations

import logging
import threading

from tpu_dist_nn_torch.obs.registry import REGISTRY, Registry

log = logging.getLogger(__name__)


def _read_rss_bytes() -> int | None:
    """Resident set size from /proc (linux); None where unavailable."""
    try:
        with open("/proc/self/statm") as f:
            fields = f.read().split()
        import resource

        return int(fields[1]) * resource.getpagesize()
    except (OSError, IndexError, ValueError):
        return None


class RuntimeSampler:
    """Samples registered sources into gauges every ``interval`` s.

    Sources attach after construction (``add_batcher`` from the
    serving wiring, ``add_engine`` where one exists); host RSS and —
    when the backend exposes them — per-device memory stats are
    sampled unconditionally. ``start()`` publishes one immediate
    sample so a scrape right after bring-up is never empty.
    """

    def __init__(self, interval: float = 5.0, *,
                 registry: Registry | None = None):
        reg = registry if registry is not None else REGISTRY
        self._interval = float(interval)
        self._batchers: list[tuple[str, object]] = []
        self._engines: list[object] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._g_queue = reg.gauge(
            "tdn_batcher_queue_depth",
            "requests waiting in the coalescing queue", labels=("method",),
        )
        self._g_pending_rows = reg.gauge(
            "tdn_batcher_pending_rows",
            "rows waiting in the coalescing queue (the admission-control "
            "watermark ledger; sheds start when this would pass "
            "--max-pending-rows)", labels=("method",),
        )
        self._g_inflight = reg.gauge(
            "tdn_batcher_inflight_rows",
            "rows in the batch currently on the device", labels=("method",),
        )
        self._g_ratio = reg.gauge(
            "tdn_batcher_coalesce_ratio",
            "requests served per device launch (cumulative)",
            labels=("method",),
        )
        self._g_overlap = reg.gauge(
            "tdn_batcher_overlap_ratio",
            "fraction of launches issued while a prior batch was still "
            "materializing (cumulative; > 0 means the double-buffered "
            "pipeline is actually overlapping)",
            labels=("method",),
        )
        self._g_class_pending = reg.gauge(
            "tdn_sched_class_pending_rows",
            "rows waiting in the scheduler queue per SLO class (the "
            "degradation ladder's per-class backlog view; sheds start "
            "at each class's watermark fraction)",
            labels=("method", "slo_class"),
        )
        self._g_rss = reg.gauge(
            "tdn_host_rss_bytes", "resident set size of this process",
        )
        self._g_dev = reg.gauge(
            "tdn_device_memory_bytes",
            "per-device memory from the backend allocator",
            labels=("device", "kind"),
        )
        self._g_ready = reg.gauge(
            "tdn_engine_ready",
            "1 when every registered engine would report ready",
        )
        # Continuous-batching decode (serving/continuous.py): slot
        # residency now, plus the cumulative occupancy ratio — the
        # decode-efficiency figure (1.0 = every step advanced a full
        # slot ladder; low values say --gen-slots is oversized for the
        # offered load).
        self._g_gen_slots = reg.gauge(
            "tdn_gen_slots_active",
            "decode slots currently occupied by a generating request",
        )
        self._g_gen_occ = reg.gauge(
            "tdn_gen_slot_occupancy_ratio",
            "cumulative active-slot-steps / (steps * slots) of the "
            "continuous decode scheduler",
        )
        self._g_prefix_used = reg.gauge(
            "tdn_prefix_cache_blocks_used",
            "prefix-pool blocks currently holding a cached shared "
            "prefix (continuous scheduler; hit/miss/evict counters are "
            "the tdn_prefix_cache_* families)",
        )
        self._gen_scheds: list[object] = []
        # Router replica pools (serving/pool.py): the fleet-state
        # gauges nobody increments — per-replica outstanding requests
        # and the blended load view the placement policy compares.
        self._g_pool_outstanding = reg.gauge(
            "tdn_router_replica_outstanding",
            "requests this router currently has in flight on each "
            "replica (the p2c fallback signal when gauges are stale)",
            labels=("replica",),
        )
        self._g_pool_pending = reg.gauge(
            "tdn_router_replica_pending_rows",
            "last scraped tdn_batcher_pending_rows backlog per replica "
            "(the p2c load signal while fresh)",
            labels=("replica",),
        )
        self._pools: list[object] = []
        # Replica labels written on the previous tick: membership churn
        # (pool.remove) must retire the dead series, not leave phantom
        # last values on /metrics forever.
        self._pool_replicas_seen: set[str] = set()
        # The tracer observing itself: buffer occupancy plus an
        # eviction counter, so "why is my slow request's trace gone"
        # has a scrapeable answer (dropped > 0: raise the buffer or
        # lower the sample rate).
        self._g_trace_buf = reg.gauge(
            "tdn_trace_buffer_spans",
            "completed spans resident in the trace ring buffer",
        )
        self._c_trace_dropped = reg.counter(
            "tdn_trace_spans_dropped_total",
            "spans evicted from the trace ring buffer before export",
        )
        self._tracers: list = []
        # Last dropped_total seen per tracer (by position): counters
        # tick by DELTA at sample time, so the drop path itself stays a
        # plain int increment with no registry work.
        self._trace_dropped_seen: list[float] = []
        # Goodput trackers tick BEFORE the time-series rings
        # collect, so a ring tick records this tick's tdn_mfu_ratio /
        # tdn_pad_ratio values, not last tick's.
        self._goodput: list = []
        # Fleet observability plane: time-series rings sample
        # AFTER the gauges above are refreshed (so a ring tick sees
        # this tick's state, not last tick's), and SLO trackers
        # evaluate after the rings (their windows read ring deltas).
        self._timeseries: list = []
        self._slo_trackers: list = []
        # Flight recorders check their detectors LAST in a
        # tick: the rings have collected and the SLO trackers have
        # evaluated, so a detector sees this tick's state.
        self._incident_recorders: list = []
        # Autoscalers tick after the SLO trackers (their
        # burn-rate signal is the tracker's fresh verdict) and BEFORE
        # the incident recorders (an autoscale.flap must be visible to
        # the detector pass of the same tick).
        self._autoscalers: list = []
        # Admission governors tick right after the SLO
        # trackers too: the burn verdict they map to admission
        # pressure is this tick's, and a tightening this tick must be
        # visible to the detector pass.
        self._admission_governors: list = []

    # ------------------------------------------------------------ wiring

    def add_batcher(self, batcher, method: str = "Process") -> None:
        self._batchers.append((method, batcher))

    def add_engine(self, engine) -> None:
        self._engines.append(engine)

    def add_generation_scheduler(self, sched) -> None:
        """Register a continuous decode scheduler for the tdn_gen_*
        slot gauges (its queue/counter families ride :meth:`add_batcher`
        — the scheduler satisfies the batcher attribute contract)."""
        self._gen_scheds.append(sched)

    def add_pool(self, pool) -> None:
        """Register a router :class:`~tpu_dist_nn_torch.serving.pool
        .ReplicaPool` for the per-replica fleet gauges (the pool's own
        scraper refreshes load; this publishes the router-side view —
        tdn_router_replica_healthy is written by the pool itself on
        state transitions, so it is live even without a sampler)."""
        self._pools.append(pool)

    def add_tracer(self, tracer) -> None:
        self._tracers.append(tracer)
        self._trace_dropped_seen.append(float(tracer.dropped_total))

    def add_goodput(self, tracker) -> None:
        """Register a :class:`~tpu_dist_nn_torch.obs.goodput.GoodputTracker`
        whose :meth:`~tpu_dist_nn_torch.obs.goodput.GoodputTracker.tick`
        refreshes the MFU/pad gauges once per tick — before the
        time-series rings collect, so the ring records this tick's
        utilization. The tick is pure ledger math; peak calibration
        happened at configure time."""
        self._goodput.append(tracker)

    def add_timeseries(self, ring) -> None:
        """Register a :class:`~tpu_dist_nn_torch.obs.timeseries.TimeSeriesRing`
        to snapshot once per tick (after the gauges refresh)."""
        self._timeseries.append(ring)

    def add_slo_tracker(self, tracker) -> None:
        """Register an :class:`~tpu_dist_nn_torch.obs.slo.SLOTracker` to
        evaluate once per tick (after its ring collected)."""
        self._slo_trackers.append(tracker)

    def add_autoscaler(self, autoscaler) -> None:
        """Register a :class:`~tpu_dist_nn_torch.serving.autoscale.Autoscaler`
        whose control loop evaluates once per tick — after the SLO
        trackers (burn rate is its scale-up signal), before the
        incident recorders (a flap suppression this tick must be seen
        by this tick's detector pass)."""
        self._autoscalers.append(autoscaler)

    def add_admission_governor(self, governor) -> None:
        """Register an :class:`~tpu_dist_nn_torch.serving.sched_core
        .AdmissionGovernor` to tick once per sample, after the SLO
        trackers evaluate (its input is the tracker's fresh fast-burn
        verdict) and before the autoscalers/incident recorders see
        the tick. The tick is pure — it reads the tracker's cached
        status and flips an int on each scheduling core."""
        self._admission_governors.append(governor)

    def add_incident_recorder(self, recorder) -> None:
        """Register a :class:`~tpu_dist_nn_torch.obs.incident.FlightRecorder`
        whose detectors run once per tick, after the rings collected
        and the SLO trackers evaluated — arming the recorder adds ONE
        host-side detector pass per tick to this daemon thread and
        nothing to any request path."""
        self._incident_recorders.append(recorder)

    # ------------------------------------------------------------ loop

    def start(self) -> "RuntimeSampler":
        if self._thread is not None:
            return self
        self._safe_sample()
        self._thread = threading.Thread(
            target=self._run, name="tdn-obs-sampler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self._safe_sample()

    def _safe_sample(self) -> None:
        try:
            self.sample_once()
        except Exception:  # noqa: BLE001 — sampling must never kill serving
            log.exception("runtime sample failed")

    def sample_once(self) -> None:
        """One synchronous sample of every source (also used by tests)."""
        for method, b in self._batchers:
            # queue_depth() is the schedulers' lock-free O(1) read;
            # len(_pending) (a full queue copy under the admission
            # lock on the rebased schedulers) stays as the fallback
            # for fakes predating the shared core.
            depth_fn = getattr(b, "queue_depth", None)
            self._g_queue.labels(method=method).set(
                depth_fn() if callable(depth_fn) else len(b._pending)
            )
            self._g_pending_rows.labels(method=method).set(
                getattr(b, "pending_rows", 0)
            )
            self._g_inflight.labels(method=method).set(
                getattr(b, "inflight_rows", 0)
            )
            launches = max(b.batches_total, 1)
            self._g_ratio.labels(method=method).set(
                b.requests_total / launches
            )
            self._g_overlap.labels(method=method).set(
                getattr(b, "overlapped_total", 0) / launches
            )
            by_class = getattr(b, "pending_by_class", None)
            if by_class is not None:
                for cls, rows in by_class().items():
                    self._g_class_pending.labels(
                        method=method, slo_class=cls
                    ).set(rows)
        if self._gen_scheds:
            self._g_gen_slots.set(
                sum(int(s.slots_active) for s in self._gen_scheds)
            )
            steps = sum(
                int(s.steps_total) * int(s.slots) for s in self._gen_scheds
            )
            slot_steps = sum(
                int(s.slot_steps_total) for s in self._gen_scheds
            )
            self._g_gen_occ.set(slot_steps / steps if steps else 0.0)
            self._g_prefix_used.set(
                sum(
                    int(getattr(s, "prefix_blocks_used", 0))
                    for s in self._gen_scheds
                )
            )
        if self._pools:
            seen: set[str] = set()
            for pool in self._pools:
                for snap in pool.snapshot():
                    seen.add(snap["target"])
                    self._g_pool_outstanding.labels(
                        replica=snap["target"]
                    ).set(float(snap["outstanding"]))
                    self._g_pool_pending.labels(replica=snap["target"]).set(
                        float(snap["pending_rows"] or 0.0)
                    )
            for gone in self._pool_replicas_seen - seen:
                self._g_pool_outstanding.remove(replica=gone)
                self._g_pool_pending.remove(replica=gone)
            self._pool_replicas_seen = seen
        if self._engines:
            # (tdn_engine_warm_buckets is NOT sampled here: the engine's
            # warm_buckets method is its single writer — a second writer
            # with aggregate semantics would flap the series between
            # per-engine and summed values.)
            # Engine.is_ready is attribute-only (health()'s probe would
            # launch a device program per sample). All engines must be
            # up: a per-engine overwrite would let the last-registered
            # one mask a dead sibling.
            ready = all(
                bool(getattr(e, "is_ready", False)) for e in self._engines
            )
            self._g_ready.set(1.0 if ready else 0.0)
        if self._tracers:
            self._g_trace_buf.set(
                sum(t.buffer_len() for t in self._tracers)
            )
            for i, t in enumerate(self._tracers):
                now = float(t.dropped_total)
                delta = now - self._trace_dropped_seen[i]
                if delta > 0:
                    self._c_trace_dropped.inc(delta)
                    self._trace_dropped_seen[i] = now
        rss = _read_rss_bytes()
        if rss is not None:
            self._g_rss.set(rss)
        self._sample_devices()
        for tracker in self._goodput:
            tracker.tick()
        for ring in self._timeseries:
            ring.collect()
        for tracker in self._slo_trackers:
            tracker.evaluate()
        for governor in self._admission_governors:
            # Guarded per governor: one broken policy tick must not
            # starve the autoscalers/detectors below of the same tick.
            try:
                governor.tick()
            except Exception:  # noqa: BLE001 — admission must never kill sampling
                log.exception("admission governor tick failed")
        for autoscaler in self._autoscalers:
            # Guarded per autoscaler: one broken policy tick must not
            # starve the incident recorders below of the same tick.
            try:
                autoscaler.tick()
            except Exception:  # noqa: BLE001 — scaling must never kill sampling
                log.exception("autoscaler tick failed")
        for recorder in self._incident_recorders:
            # check() contains its own per-detector/per-capture guards;
            # anything escaping still only costs this tick (the
            # _safe_sample wrapper), never the serving path.
            recorder.check()

    def _devices(self) -> list:
        """The CUDA devices to report: every card a registered engine
        is placed on, else every visible card. Empty when this process
        has not initialised CUDA (nothing of it is on a card)."""
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return []
        devs = set()
        for e in self._engines:
            for d in [getattr(e, "device", None)] + sorted(
                    getattr(getattr(e, "mesh", None), "devices", None) or (), key=str):
                if isinstance(d, torch.device) and d.type == "cuda":
                    devs.add(torch.device("cuda", d.index or 0))
        if not devs:
            devs = {torch.device("cuda", i) for i in range(torch.cuda.device_count())}
        return sorted(devs, key=lambda d: d.index)

    def _sample_devices(self) -> None:
        # Host queries only: torch.cuda.memory_stats reads the caching
        # allocator's counters and get_device_properties the properties
        # cached at CUDA init. Neither launches device work, allocates,
        # or synchronises a stream, so a tick cannot stall a serving
        # launch or break a CUDA graph being captured on another thread.
        try:
            import torch

            for d in self._devices():
                stats = torch.cuda.memory_stats(d)
                name = f"cuda:{d.index}"
                for kind, value in (
                        ("bytes_in_use", stats.get("allocated_bytes.all.current")),
                        ("peak_bytes_in_use", stats.get("allocated_bytes.all.peak")),
                        ("bytes_limit", torch.cuda.get_device_properties(d).total_memory)):
                    if value is not None:
                        self._g_dev.labels(device=name, kind=kind).set(value)
        except Exception:  # noqa: BLE001 — no card / no stats: skip quietly
            log.debug("device memory stats unavailable", exc_info=True)
