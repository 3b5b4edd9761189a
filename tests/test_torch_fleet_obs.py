"""The port's time-series ring, SLO tracker and span profile against the
JAX package's (:mod:`tpu_dist_nn.obs.timeseries`, ``slo``, ``profile``).

The same registry events, collected at the same injected times, give
equal ring windows and deltas; the SLO trackers' burn rates and error
budgets over the same ticks agree to 1e-12 (absolute); the profile
snapshot, self times and the printed table of the same spans are equal.
"""

import math

import numpy as np
import pytest

from tpu_dist_nn.obs import profile as jprof
from tpu_dist_nn.obs import registry as jreg
from tpu_dist_nn.obs import slo as jslo
from tpu_dist_nn.obs import timeseries as jts
from tpu_dist_nn.obs import trace as jtrace
from tpu_dist_nn_torch.obs import profile as pprof
from tpu_dist_nn_torch.obs import registry as preg
from tpu_dist_nn_torch.obs import slo as pslo
from tpu_dist_nn_torch.obs import timeseries as pts
from tpu_dist_nn_torch.obs import trace as ptrace

SLO_TOL = 1e-12


def _traffic(reg_mod, seed, ticks, resolution=5.0, bad_from=None, objectives=None,
             slo_mod=None, ts_mod=None):
    """Seeded Process traffic on a fresh registry, one ring collect (and
    SLO evaluate) per tick at injected times; returns (ring, tracker,
    statuses)."""
    rng = np.random.default_rng(seed)
    r = reg_mod.Registry()
    req = r.counter("tdn_rpc_requests_total", "", labels=("method",))
    err = r.counter("tdn_rpc_errors_total", "", labels=("method", "code"))
    wait = r.histogram("tdn_batch_wait_seconds", "", labels=("method",))
    depth = r.gauge("tdn_batcher_pending_rows", "", labels=("method",))
    ring = ts_mod.TimeSeriesRing(resolution=resolution, retention=600.0, registry=r)
    tracker = None
    if objectives is not None:
        tracker = slo_mod.SLOTracker(ring, objectives(slo_mod), fast_window=30.0,
                                     slow_window=120.0, registry=reg_mod.Registry())
    statuses = []
    for k in range(ticks):
        now = 1_000.0 + k * resolution
        for _ in range(int(rng.integers(5, 20))):
            m = "Process" if rng.random() < 0.8 else "Generate"
            req.labels(method=m).inc()
            slow = bad_from is not None and k >= bad_from
            wait.labels(method=m).observe(float(rng.exponential(0.2 if slow else 0.004)))
            if slow and rng.random() < 0.3:
                err.labels(method=m, code="UNAVAILABLE").inc()
        depth.labels(method="Process").set(float(rng.integers(0, 50)))
        ring.collect(now=now)
        if tracker is not None:
            tracker.evaluate(now=now)
            statuses.append(tracker.status())
    return ring, tracker, statuses


@pytest.mark.parametrize("window", [None, 0.0, 12.0, 60.0, 10_000.0])
@pytest.mark.parametrize("family", [None, "tdn_rpc_requests_total", "tdn_batch_wait_seconds",
                                    "tdn_batcher_pending_rows"])
def test_ring_windows_are_equal(window, family):
    jring = _traffic(jreg, 3, 30, ts_mod=jts)[0]
    pring = _traffic(preg, 3, 30, ts_mod=pts)[0]
    now = 1_000.0 + 29 * 5.0
    assert pring.families() == jring.families()
    assert pring.keys(family=family) == jring.keys(family=family)
    assert (pring.series(family=family, window=window, now=now)
            == jring.series(family=family, window=window, now=now))
    for key in jring.keys(family=family):
        for w in (10.0, 60.0, 300.0):
            assert pring.delta(key, w, now) == jring.delta(key, w, now)


def test_ring_restart_and_born_mid_window_match_jax():
    out = []
    for reg_mod, ts_mod in ((jreg, jts), (preg, pts)):
        ring = ts_mod.TimeSeriesRing(resolution=1.0, retention=60.0,
                                     registry=reg_mod.Registry())
        for t, v in ((10.0, 5.0), (11.0, 9.0), (12.0, 2.0), (13.0, 4.0)):  # a restart at 12
            ring.record("tdn_x_total", v, family="tdn_x_total", now=t)
        ring.record('tdn_y_total{a="1"}', 3.0, family="tdn_y_total", now=13.0, born_zero=True)
        out.append((ring.delta("tdn_x_total", 10.0, 13.0), ring.series(now=13.0),
                    ring.delta('tdn_y_total{a="1"}', 10.0, 13.0)))
    assert out[0] == out[1]


def _objectives(slo_mod):
    return [
        slo_mod.latency_objective("p99", "tdn_batch_wait_seconds", 0.05, q=0.99,
                                  match={"method": "Process"}),
        slo_mod.availability_objective("availability", 0.99,
                                       total_family="tdn_rpc_requests_total",
                                       bad_family="tdn_rpc_errors_total"),
        slo_mod.availability_objective("generate", 0.9, total_family="tdn_rpc_requests_total",
                                       bad_family="tdn_rpc_errors_total",
                                       match={"method": "Generate"}),
    ]


def _close(a, b, path="doc"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert (math.isnan(a) and math.isnan(b)) or abs(a - b) <= SLO_TOL, (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("seed,bad_from", [(0, None), (1, 10), (2, 3), (5, 20)])
def test_slo_burn_rates_and_budgets_agree(seed, bad_from):
    _, jt, jstat = _traffic(jreg, seed, 36, bad_from=bad_from, objectives=_objectives,
                            slo_mod=jslo, ts_mod=jts)
    _, pt, pstat = _traffic(preg, seed, 36, bad_from=bad_from, objectives=_objectives,
                            slo_mod=pslo, ts_mod=pts)
    for p, j in zip(pstat, jstat):
        _close(p, j)
    if bad_from is not None:
        assert any(o["burning"] for o in pstat[-1]["objectives"])


def test_slo_rejects_like_jax():
    msgs = []
    for mod, ts_mod, reg_mod in ((jslo, jts, jreg), (pslo, pts, preg)):
        ring = ts_mod.TimeSeriesRing(registry=reg_mod.Registry())
        got = []
        for fn in (lambda: mod.latency_objective("x", "f", 0.0),
                   lambda: mod.availability_objective("x", 1.5, total_family="f"),
                   lambda: mod.SLOTracker(ring, [], fast_window=0.0),
                   lambda: mod.SLOTracker(ring, [], fast_window=60.0, slow_window=30.0)):
            with pytest.raises(ValueError) as e:
                fn()
            got.append(str(e.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------- profile


def _spans(mod, seed):
    rng = np.random.default_rng(seed)
    t = mod.Tracer(sample_rate=1.0, capacity=4096)
    for k in range(12):
        t0 = 50.0 + k
        hdr = mod.SpanContext(f"{k + 1:032x}", f"{k + 500:016x}", True).header()
        method = "Process" if k % 3 else "Generate"
        root = t.record_span(f"rpc.{method}", mod.SpanContext.from_header(hdr), t0,
                             float(rng.uniform(0.01, 0.05)))
        off = t0
        for stage in ("decode", "queue_wait", "stage", "launch", "fetch", "encode"):
            d = float(rng.uniform(0.0005, 0.006))
            t.record_span(stage, root.ctx, off, d)
            off += d * float(rng.uniform(0.6, 1.2))  # partly overlapping siblings
    return t


@pytest.fixture
def tracers(monkeypatch):
    out = []
    for mod in (jtrace, ptrace):
        n = iter(range(1, 100_000))
        monkeypatch.setattr(mod, "_new_span_id", lambda n=n: f"{next(n):016x}")
        out.append(_spans(mod, 7))
    return out


@pytest.mark.parametrize("window,top", [(None, 5), (None, 1), (5.0, 3), (100.0, 0)])
def test_profile_snapshot_and_table_equal(tracers, window, top):
    jt, pt = tracers
    jdoc = jprof.profile_snapshot(jt, window=window, top=top, now=62.0 + 0.1)
    pdoc = pprof.profile_snapshot(pt, window=window, top=top, now=62.0 + 0.1)
    assert pdoc == jdoc
    assert pprof.format_profile_table(pdoc) == jprof.format_profile_table(jdoc)


def test_self_times_equal(tracers):
    jt, pt = tracers
    jrec = jprof.records_from_spans(jt.snapshot())
    prec = pprof.records_from_spans(pt.snapshot())
    fields = ("name", "trace_id", "span_id", "parent_id", "t0", "dur")
    assert ([tuple(getattr(r, f) for f in fields) for r in prec]
            == [tuple(getattr(r, f) for f in fields) for r in jrec])
    assert pprof.compute_self_times(prec) == jprof.compute_self_times(jrec)


@pytest.mark.parametrize("case", ["nested", "overlap", "leak"])
def test_self_time_edge_cases_equal(case):
    spans = {
        "nested": [("root", None, 0.0, 10.0), ("a", "root", 1.0, 4.0), ("b", "a", 2.0, 1.0)],
        "overlap": [("root", None, 0.0, 10.0), ("a", "root", 1.0, 4.0), ("b", "root", 3.0, 4.0)],
        "leak": [("root", None, 0.0, 5.0), ("a", "root", 4.0, 4.0)],
    }[case]
    out = []
    for mod in (jprof, pprof):
        recs = [mod.SpanRecord(n, "t", n, p, t0, d) for n, p, t0, d in spans]
        out.append(mod.compute_self_times(recs))
    assert out[0] == out[1]
