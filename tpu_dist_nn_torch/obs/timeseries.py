"""Embedded time-series ring: bounded history for the live registry.

Port of :mod:`tpu_dist_nn.obs.timeseries` (the same documents and numbers).

Every metric the registry serves is a point-in-time scrape — "what is
pending_rows NOW" — with no history unless an external Prometheus is
running, which on the boxes this framework actually runs on (CI
containers, rented accelerator hosts) it never is. This module is the
embedded alternative: a bounded in-memory ring the
:class:`~tpu_dist_nn_torch.obs.runtime.RuntimeSampler` tick snapshots
selected metric families into, at a configurable resolution and
retention (default 5s x 1h = 720 points per series), served as
``GET /timeseries?family=F&window=S`` JSON.

It is the data plane under two consumers:

* the SLO tracker (:mod:`tpu_dist_nn_torch.obs.slo`) computes windowed
  deltas of cumulative counters and histogram buckets from it — burn
  rates need "errors over the last 5 minutes", which a gauge of the
  all-time total cannot answer;
* ``tdn top`` pulls sparkline history from it, so the dashboard shows
  trend, not just the instant.

Design constraints (the registry's own discipline):

* **Stdlib-only, host-side only** — dict + deque under one lock; a
  sample tick is O(selected series), never touches a device.
* **Bounded** — each series is a ``deque(maxlen=retention/resolution)``;
  the family allowlist bounds series count (histogram families record
  one series per bucket edge, so an unbounded allowlist would
  multiply).
* **Cumulative stays cumulative** — counters and histogram buckets are
  recorded as their raw cumulative values; consumers difference them
  (and treat a value drop as a process restart). Storing rates here
  would bake one window into the data.

Series keys are exposition-format (``name{label="v"}``), with
histogram children fanned out as ``name_count`` / ``name_sum`` /
``name_bucket{...,le="edge"}`` — the same naming a scrape would yield,
so :func:`~tpu_dist_nn_torch.obs.exposition.split_series` parses both.
"""

from __future__ import annotations

import collections
import threading
import time

from tpu_dist_nn_torch.obs.registry import REGISTRY, Registry

# The families the serving data plane's health story needs, kept small
# on purpose (each histogram fans out per bucket edge). Callers with
# different workloads pass their own allowlist.
DEFAULT_FAMILIES = (
    "tdn_rpc_requests_total",
    "tdn_rpc_errors_total",
    "tdn_batch_wait_seconds",
    "tdn_batcher_pending_rows",
    "tdn_batcher_shed_total",
    # Degradation ladder: per-class sheds/backlog, expiry,
    # and the governor's tightening level — the /timeseries evidence
    # of an overload handled selectively.
    "tdn_sched_class_shed_total",
    "tdn_sched_class_pending_rows",
    "tdn_batcher_expired_total",
    "tdn_sched_pressure",
    "tdn_gen_preemptions_total",
    "tdn_gen_ttft_seconds",
    "tdn_gen_tokens_total",
    "tdn_gen_slots_active",
    "tdn_gen_slot_occupancy_ratio",
    "tdn_prefix_cache_hits_total",
    "tdn_prefix_cache_misses_total",
    "tdn_goodput_flops_total",
    "tdn_mfu_ratio",
    "tdn_pad_ratio",
    "tdn_prefix_flops_saved_total",
    "tdn_router_requests_total",
    "tdn_router_request_seconds",
    "tdn_router_failovers_total",
    "tdn_router_replica_healthy",
    "tdn_router_replica_pending_rows",
    "tdn_host_rss_bytes",
)


def _labelstr(names, values) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
    return "{" + inner + "}"


class TimeSeriesRing:
    """Bounded per-series history of selected registry families.

    ``collect()`` snapshots every allowlisted family's children at the
    current grid bucket (``floor(now / resolution)``); two collects in
    one bucket overwrite rather than append, so the cadence of the
    caller (the runtime sampler's tick) and the ring's resolution can
    differ without double points. Timestamps are wall-clock
    (``time.time()``) — the JSON consumers line them up with logs and
    other processes, which monotonic values cannot.
    """

    def __init__(self, resolution: float = 5.0, retention: float = 3600.0,
                 *, families=DEFAULT_FAMILIES,
                 registry: Registry | None = None):
        if resolution <= 0:
            raise ValueError(f"resolution must be > 0, got {resolution}")
        if retention < resolution:
            raise ValueError(
                f"retention {retention} must be >= resolution {resolution}"
            )
        self.resolution = float(resolution)
        self.retention = float(retention)
        self._families = set(families)
        self._reg = registry if registry is not None else REGISTRY
        self._capacity = max(int(retention / resolution), 1)
        self._lock = threading.Lock()
        # series key -> deque[(bucket_ts, value)], plus the base family
        # each key belongs to (a histogram's _bucket series resolve
        # back to their family for filtered reads).
        self._data: dict[str, collections.deque] = {}  # guarded-by: _lock
        self._family_of: dict[str, str] = {}  # guarded-by: _lock
        # Bucket of the previous collect() pass: a cumulative series
        # first seen on a LATER pass was born since then, and gets a
        # zero baseline at this bucket — without it, an error counter
        # whose first increment IS the incident would have one point,
        # no computable delta, and an invisible burn (the labeled-
        # children-are-lazy corollary of the registry's unlabeled-
        # counter rule).
        self._last_collect_bucket: float | None = None  # guarded-by: _lock

    # ------------------------------------------------------------ write

    def record(self, series: str, value: float, *, family: str | None = None,
               now: float | None = None, born_zero: bool = False) -> None:
        """Record one point (grid-aligned; same-bucket writes
        overwrite). ``family`` defaults to the series' bare name;
        ``born_zero`` seeds a first-seen series with a 0.0 baseline at
        the previous collect tick (cumulative families only — see
        :meth:`collect`)."""
        t = time.time() if now is None else float(now)
        bucket = (t // self.resolution) * self.resolution
        fam = family if family is not None else series.split("{", 1)[0]
        with self._lock:
            dq = self._data.get(series)
            if dq is None:
                dq = self._data[series] = collections.deque(
                    maxlen=self._capacity
                )
                self._family_of[series] = fam
                last = self._last_collect_bucket
                if born_zero and last is not None and last < bucket:
                    dq.append((last, 0.0))
            if dq and dq[-1][0] == bucket:
                dq[-1] = (bucket, float(value))
            else:
                dq.append((bucket, float(value)))

    def collect(self, now: float | None = None) -> None:
        """One snapshot of every allowlisted family into the ring (the
        runtime sampler calls this per tick; tests call it with a
        controlled ``now``)."""
        for m in self._reg.collect():
            if m.name not in self._families:
                continue
            cumulative = m.kind in ("counter", "histogram")
            for values, child in m.samples():
                base = _labelstr(m.labelnames, values)
                if m.kind == "histogram":
                    self.record(f"{m.name}_count{base}", child.value,
                                family=m.name, now=now, born_zero=True)
                    self.record(f"{m.name}_sum{base}", child.sum,
                                family=m.name, now=now, born_zero=True)
                    for edge, n in zip(m.buckets, child.counts):
                        key = _labelstr(
                            m.labelnames + ("le",),
                            values + (repr(float(edge)),),
                        )
                        # Per-bucket (NOT le-cumulative) counts: the
                        # windowed-delta consumer wants each bucket's
                        # own increments, and histogram_quantile takes
                        # exactly this layout.
                        self.record(f"{m.name}_bucket{key}", n,
                                    family=m.name, now=now,
                                    born_zero=True)
                else:
                    self.record(f"{m.name}{base}", child.value,
                                family=m.name, now=now,
                                born_zero=cumulative)
        t = time.time() if now is None else float(now)
        with self._lock:
            self._last_collect_bucket = (
                t // self.resolution
            ) * self.resolution

    # ------------------------------------------------------------- read

    def families(self) -> list[str]:
        with self._lock:
            return sorted(set(self._family_of.values()))

    def keys(self, family: str | None = None) -> list[str]:
        """Series KEYS only (``family`` filters like :meth:`series`) —
        for consumers that enumerate then :meth:`delta` per key (the
        incident spike detectors): materializing every point list just
        to read the dict keys would allocate the whole retained window
        per tick."""
        with self._lock:
            return [
                k for k in self._data
                if family is None or self._family_of[k] == family
            ]

    def series(self, family: str | None = None,
               window: float | None = None,
               now: float | None = None) -> dict[str, list]:
        """``{series_key: [[t, value], ...]}``, oldest first.
        ``family`` filters to one base family (histogram-derived keys
        included); ``window`` keeps points from the last S seconds."""
        t_now = time.time() if now is None else float(now)
        cutoff = None if window is None else t_now - float(window)
        out: dict[str, list] = {}
        with self._lock:
            for key, dq in self._data.items():
                if family is not None and self._family_of[key] != family:
                    continue
                pts = [
                    [t, v] for t, v in dq
                    if cutoff is None or t >= cutoff
                ]
                if pts:
                    out[key] = pts
        return out

    def delta(self, series: str, window: float,
              now: float | None = None) -> tuple[float, float]:
        """Windowed increase of one CUMULATIVE series ->
        ``(delta, covered_seconds)``. The baseline is the newest point
        at or before the window start (so a window that opened between
        two samples still counts the straddling increment), else the
        oldest retained point. A value drop is a process restart: the
        delta restarts from zero at the new value (the Prometheus
        ``increase()`` convention, minus interpolation)."""
        t_now = time.time() if now is None else float(now)
        start = t_now - float(window)
        with self._lock:
            dq = self._data.get(series)
            pts = list(dq) if dq else []
        if len(pts) < 2:
            return 0.0, 0.0
        base_t, base_v = pts[0]
        for t, v in pts:
            if t <= start:
                base_t, base_v = t, v
            else:
                break
        last_t, last_v = pts[-1]
        if last_t <= base_t:
            return 0.0, 0.0
        delta = last_v - base_v
        if delta < 0:  # counter reset across a restart
            delta = last_v
        return delta, last_t - base_t
