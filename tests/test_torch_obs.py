"""The port's metric registry, structured log, tracer and endpoint
against the JAX package's (:mod:`tpu_dist_nn.obs`).

The same registry events render byte-equal exposition text in both
packages; JSON log lines, the log ring, Chrome trace exports and the
sample-rate parsing are equal; the ``--metrics-port`` endpoint answers
the same routes with the same status codes and bodies; the port's
``Engine.health`` has the JAX keys and its fingerprint equals the JAX
Engine's for one model file. Everything here is exact (no tolerance).
"""

import io
import json
import logging
import math
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from tpu_dist_nn.obs import exposition as jexp
from tpu_dist_nn.obs import log as jlog
from tpu_dist_nn.obs import registry as jreg
from tpu_dist_nn.obs import trace as jtrace
from tpu_dist_nn_torch.obs import exposition as pexp
from tpu_dist_nn_torch.obs import log as plog
from tpu_dist_nn_torch.obs import registry as preg
from tpu_dist_nn_torch.obs import trace as ptrace

PKGS = {"jax": (jreg, jexp, jlog, jtrace), "port": (preg, pexp, plog, ptrace)}


def _events(reg_mod, seed):
    """One seeded sequence of registry events on a fresh Registry."""
    rng = np.random.default_rng(seed)
    r = reg_mod.Registry()
    c = r.counter("tdn_t_requests_total", "requests\nper method", labels=("method",))
    g = r.gauge("tdn_t_depth", 'a "quoted" gauge', labels=("device", "kind"))
    h = r.histogram("tdn_t_seconds", "latency", labels=("method",),
                    buckets=(0.001, 0.01, 0.1, 1.0))
    u = r.histogram("tdn_t_unlabeled_seconds", "default buckets")
    z = r.counter("tdn_t_never_total", "born at zero")
    for _ in range(40):
        m = str(rng.choice(["Process", "Generate", 'we"ird\\name']))
        c.labels(method=m).inc(float(rng.integers(1, 4)))
        h.labels(method=m).observe(float(rng.exponential(0.05)))
        u.observe(float(rng.uniform(0, 2)))
        g.labels(device=f"cuda:{rng.integers(2)}", kind="bytes_in_use").set(
            float(rng.integers(0, 1 << 40)))
    g.labels(device="cpu", kind="nan").set(math.nan)
    g.labels(device="cpu", kind="inf").set(-math.inf)
    g.labels(device="cpu", kind="frac").set(0.1 + 0.2)
    assert z.labels().value == 0
    return r


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_events_render_byte_equal_and_parse_equal(seed):
    jtext = jexp.render(_events(jreg, seed))
    ptext = pexp.render(_events(preg, seed))
    assert ptext == jtext
    parsed = pexp.parse_prometheus_text(ptext)
    want = jexp.parse_prometheus_text(jtext)
    assert parsed.keys() == want.keys()
    for k, v in want.items():
        got = parsed[k]
        assert got == v or (isinstance(v, float) and math.isnan(v) and math.isnan(got))
    for series in parsed:
        assert pexp.split_series(series) == jexp.split_series(series)
    for q in (0.5, 0.9, 0.99):
        assert (pexp.parsed_histogram_quantile(parsed, "tdn_t_seconds", q)
                == jexp.parsed_histogram_quantile(want, "tdn_t_seconds", q))
        assert (pexp.parsed_histogram_quantile(parsed, "tdn_t_seconds", q, method="Process")
                == jexp.parsed_histogram_quantile(want, "tdn_t_seconds", q, method="Process"))


@pytest.mark.parametrize("op", ["remove", "remove_matching", "reset", "remove_unknown"])
def test_remove_remove_matching_and_reset_match_jax(op):
    out = {}
    for name, (reg_mod, exp_mod, _, _) in PKGS.items():
        r = reg_mod.Registry()
        g = r.gauge("tdn_t_replica", "per replica", labels=("replica", "outcome"))
        for rep in ("a", "b"):
            for oc in ("ok", "err"):
                g.labels(replica=rep, outcome=oc).set(1)
        if op == "remove":
            g.remove(replica="a", outcome="ok")
            g.remove(replica="zz", outcome="ok")  # never existed: no-op
        elif op == "remove_matching":
            g.remove_matching(replica="b")
        elif op == "reset":
            r.reset()
        else:
            with pytest.raises(ValueError) as e:
                g.remove_matching(nope="x")
            with pytest.raises(ValueError) as e2:
                g.remove(replica="a")
            out[name] = (str(e.value), str(e2.value))
            continue
        out[name] = exp_mod.render(r)
    assert out["port"] == out["jax"]


def test_bridge_latency_stats_matches_jax():
    from tpu_dist_nn.utils.profiling import LatencyStats as JStats
    from tpu_dist_nn_torch.utils.profiling import LatencyStats as PStats

    texts = []
    for stats_cls, reg_mod, exp_mod in ((JStats, jreg, jexp), (PStats, preg, pexp)):
        r = reg_mod.Registry()
        stats = reg_mod.bridge_latency_stats(stats_cls("probe"), registry=r, method="Process")
        for v in (0.2, 0.003, 1.5):
            stats.record(v)
        assert len(stats.samples_s) == 3 and stats.summary()["count"] == 3
        texts.append(exp_mod.render(r))
    assert texts[0] == texts[1]
    assert 'tdn_probe_seconds_count{method="Process"} 3' in texts[1]


# ------------------------------------------------------------------ logs


def _log_run(log_mod, name):
    """Emit one fixed set of records through a StructuredLogger with the
    package's JsonFormatter; returns (JSON docs without ts, ring records
    without ts)."""
    log_mod.LOG_RING.clear()
    stream = io.StringIO()
    handler = logging.StreamHandler(stream)
    handler.setFormatter(log_mod.JsonFormatter())
    base = logging.getLogger(name)
    base.addHandler(handler)
    base.setLevel(logging.DEBUG)
    base.propagate = False
    try:
        slog = log_mod.get_logger(name)
        slog.info("server.start", port=5101, method="Process")
        slog.warning("batcher.shed", rows=3, level="clobber", ts="clobber", logger="x")
        for _ in range(40):  # past the bucket's burst: suppressed, counted
            slog.error("storm", n=1)
        try:
            raise RuntimeError("boom")
        except RuntimeError:
            slog.exception("crash", where="here")
        base.info("plain %s record", "logging")
    finally:
        base.removeHandler(handler)
    docs = []
    for line in stream.getvalue().splitlines():
        d = json.loads(line)
        d.pop("ts")
        if "exc" in d:
            d["exc"] = d["exc"].splitlines()[-1]
        docs.append(d)
    ring = [{k: v for k, v in r.items() if k != "ts"} for r in log_mod.LOG_RING.snapshot()]
    return docs, ring


def test_json_log_lines_and_log_ring_equal_jax():
    jdocs, jring = _log_run(jlog, "tdn.cmp.jax")
    pdocs, pring = _log_run(plog, "tdn.cmp.port")
    for d in jdocs + jring:
        d["logger"] = "L"
    for d in pdocs + pring:
        d["logger"] = "L"
    assert pdocs == jdocs and pring == jring
    assert any(d.get("fields") for d in pdocs)  # reserved keys nested
    assert plog.LOG_RING.snapshot(level="error")
    with pytest.raises(ValueError):
        plog.LOG_RING.snapshot(level="bogus")


@pytest.mark.parametrize("capacity,n,window,level,limit", [
    (4, 10, None, None, None), (8, 5, None, "warning", None), (8, 5, None, None, 2),
    (8, 5, 0.0, None, None), (8, 5, None, None, 0)])
def test_log_ring_matches_jax(capacity, n, window, level, limit):
    out = []
    now = time.time()
    for log_mod in (jlog, plog):
        ring = log_mod.LogRing(capacity)
        for i in range(n):
            ring.append({"ts": now - 100 * (i % 2), "level": ["info", "warning"][i % 2],
                         "logger": "x", "event": f"e{i}", "fields": {}})
        out.append((ring.snapshot(window=window, level=level, limit=limit),
                    ring.dropped_total, len(ring)))
    assert out[0] == out[1]


def test_setup_json_logging_replaces_root_handlers():
    root = logging.getLogger()
    saved = root.handlers[:], root.level
    stream = io.StringIO()
    try:
        plog.setup_json_logging(logging.INFO, stream=stream)
        assert len(root.handlers) == 1
        assert isinstance(root.handlers[0].formatter, plog.JsonFormatter)
        logging.getLogger("tdn.cmp.root").warning("hello %d", 3)
        assert json.loads(stream.getvalue().splitlines()[-1])["event"] == "hello 3"
    finally:
        root.handlers[:], _ = saved
        root.setLevel(saved[1])


# ----------------------------------------------------------------- trace


def _ids(monkeypatch, mod):
    n = iter(range(1, 10_000))
    monkeypatch.setattr(mod, "_new_trace_id", lambda: f"{next(n):032x}")
    monkeypatch.setattr(mod, "_new_span_id", lambda: f"{next(n):016x}")
    monkeypatch.setattr(mod, "_EPOCH_OFFSET", 1.7e9)


def _record(mod, monkeypatch, capacity):
    _ids(monkeypatch, mod)
    t = mod.Tracer(capacity=capacity, sample_rate=1.0, exemplar_slots=2)
    for k in range(4):
        hdr = mod.SpanContext(f"{k + 1:032x}", f"{k + 100:016x}", True).header()
        root = t.record_span("rpc.Process", mod.SpanContext.from_header(hdr), 10.0 + k,
                             0.5 + k % 3, attrs={"rows": k})
        t.record_span("queue_wait", root.ctx, 10.0 + k, 0.1, annotations=[(10.05 + k, "note")])
        t.record_span("launch", root.ctx, 10.1 + k, 0.3, attrs={"batch_rows": 8})
    return t


@pytest.mark.parametrize("kw", [{}, {"limit": 3}, {"limit": 0}, {"since": 5},
                                {"trace_id": f"{2:032x}"}, {"limit": 2, "since": 1}])
@pytest.mark.parametrize("capacity", [64, 5])
def test_chrome_trace_and_render_json_equal_jax(monkeypatch, kw, capacity):
    jt = _record(jtrace, monkeypatch, capacity)
    pt = _record(ptrace, monkeypatch, capacity)
    assert pt.chrome_trace(**kw) == jt.chrome_trace(**kw)
    assert pt.render_json(**kw) == jt.render_json(**kw)
    assert (pt.buffer_len(), pt.dropped_total, pt.seq) == (jt.buffer_len(), jt.dropped_total,
                                                           jt.seq)
    assert ([s.name for s in pt.snapshot(**kw)] == [s.name for s in jt.snapshot(**kw)])


@pytest.mark.parametrize("raw", [None, "0.25", "1", "0", "1.5", "-0.1", "nope", "nan", ""])
def test_env_sample_rate_matches_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("TDN_TRACE_SAMPLE_RATE", raising=False)
    else:
        monkeypatch.setenv("TDN_TRACE_SAMPLE_RATE", raw)
    assert ptrace._env_sample_rate() == jtrace._env_sample_rate()
    assert ptrace.Tracer().sample_rate == jtrace.Tracer().sample_rate


def test_active_follows_the_ambient_span():
    t = ptrace.Tracer(sample_rate=1.0)
    assert not ptrace.active()
    span = t.start("x")
    with t.activate(span):
        assert ptrace.active() and not jtrace.active()
    assert not ptrace.active()
    with ptrace.annotation_sink():
        assert ptrace.active()


# --------------------------------------------------------------- endpoint


class _Broken:
    def __call__(self):
        raise RuntimeError("probe exploded")


def _server(exp_mod, reg_mod, trace_mod, health, **kw):
    r = reg_mod.Registry()
    r.counter("tdn_t_total", "c", labels=("m",)).labels(m="a").inc(3)
    tracer = trace_mod.Tracer(sample_rate=1.0)
    return exp_mod.MetricsServer(0, "127.0.0.1", registry=r, health_fn=health, tracer=tracer,
                                 routes={"/x/ok": lambda q: (200, "text/plain", b"ok " + q.encode()),
                                         "/x/bad": lambda q: 1 / 0},
                                 post_routes={"/x/post": lambda q: (202, "text/plain", b"done")},
                                 **kw)


def _get(port, path, method="GET"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=b"" if method == "POST" else None, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


ROUTES = [
    ("/metrics", "GET"), ("/healthz", "GET"), ("/nope", "GET"), ("/trace?limit=x", "GET"),
    ("/trace?since=y", "GET"), ("/trace?limit=2", "GET"), ("/logs?window=abc", "GET"),
    ("/logs?level=bogus", "GET"), ("/logs?limit=0", "GET"), ("/timeseries", "GET"),
    ("/slo", "GET"), ("/goodput", "GET"), ("/profile?top=x", "GET"), ("/profile", "GET"),
    ("/debug/profile?seconds=0", "GET"), ("/debug/profile?seconds=abc", "GET"),
    ("/debug/profile?seconds=61", "GET"), ("/x/ok?a=1", "GET"), ("/x/bad", "GET"),
    ("/x/post", "GET"), ("/x/post", "POST"), ("/x/ok", "POST"), ("/metrics", "POST"),
]


@pytest.fixture(scope="module")
def servers():
    pair = {}
    for name, (reg_mod, exp_mod, _, trace_mod) in PKGS.items():
        pair[name] = (_server(exp_mod, reg_mod, trace_mod, lambda: {"ready": True, "x": 1}),
                      _server(exp_mod, reg_mod, trace_mod, _Broken()),
                      _server(exp_mod, reg_mod, trace_mod, lambda: {"ready": False}))
    yield pair
    for trio in pair.values():
        for s in trio:
            s.close()


@pytest.mark.parametrize("path,method", ROUTES)
def test_routes_and_status_codes_match_jax(servers, path, method):
    got = {name: _get(trio[0].port, path, method) for name, trio in servers.items()}
    (js, jct, jbody), (ps, pct, pbody) = got["jax"], got["port"]
    assert (ps, pct) == (js, jct)
    if path in ("/trace?limit=2", "/logs?limit=0"):
        assert json.loads(pbody).keys() == json.loads(jbody).keys()
    elif path == "/profile":
        assert json.loads(pbody) == json.loads(jbody)
    else:
        assert pbody == jbody


@pytest.mark.parametrize("which,status", [(1, 503), (2, 503)])
def test_healthz_failing_and_not_ready_match_jax(servers, which, status):
    (js, _, jb), (ps, _, pb) = (_get(servers[n][which].port, "/healthz") for n in ("jax", "port"))
    assert ps == js == status and pb == jb


def test_debug_profile_409_while_busy_and_503_when_the_profiler_fails(servers, monkeypatch):
    import jax

    from tpu_dist_nn_torch.utils import profiling

    bodies = {}
    for name in ("jax", "port"):
        srv = servers[name][0]
        assert srv._capture_lock.acquire(blocking=False)
        try:
            bodies[name, 409] = _get(srv.port, "/debug/profile?seconds=1")
        finally:
            srv._capture_lock.release()
    assert bodies["port", 409] == bodies["jax", 409] and bodies["port", 409][0] == 409

    def boom(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(jax.profiler, "trace", boom)
    monkeypatch.setattr(profiling, "capture_chrome_trace", boom)
    for name in ("jax", "port"):
        st, ct, body = _get(servers[name][0].port, "/debug/profile?seconds=0.01")
        assert (st, ct) == (503, "application/json")
        assert json.loads(body)["error"].startswith("device profiler unavailable: RuntimeError")


def test_debug_profile_returns_a_chrome_trace_zip(servers):
    import zipfile

    st, ct, body = _get(servers["port"][0].port, "/debug/profile?seconds=0.05")
    assert (st, ct) == (200, "application/zip")
    with zipfile.ZipFile(io.BytesIO(body)) as z:
        assert z.namelist() == ["trace.json"]
        assert "traceEvents" in json.loads(z.read("trace.json"))


def test_attach_and_late_routes_serve_like_jax():
    from tpu_dist_nn.obs.goodput import GoodputTracker as JGoodput
    from tpu_dist_nn.obs.timeseries import TimeSeriesRing as JRing
    from tpu_dist_nn_torch.obs.goodput import GoodputTracker as PGoodput
    from tpu_dist_nn_torch.obs.timeseries import TimeSeriesRing as PRing

    docs = {}
    for name, ring_cls, gp_cls in (("jax", JRing, JGoodput), ("port", PRing, PGoodput)):
        reg_mod, exp_mod, _, trace_mod = PKGS[name]
        srv = _server(exp_mod, reg_mod, trace_mod, None)
        try:
            r = reg_mod.Registry()
            r.counter("tdn_rpc_requests_total", "c", labels=("method",)).labels(
                method="Process").inc(2)
            ring = ring_cls(registry=r)
            ring.collect(now=100.0)
            srv.attach(timeseries=ring, goodput=gp_cls(registry=reg_mod.Registry()))
            srv.add_routes({"/late": lambda q: (200, "text/plain", b"late")})
            docs[name] = [_get(srv.port, p) for p in (
                "/timeseries?window=abc", "/late", "/healthz")]
            ts = json.loads(_get(srv.port, "/timeseries")[2])
            docs[name].append((ts["families"], sorted(ts["series"])))
            docs[name].append(sorted(json.loads(_get(srv.port, "/goodput")[2])))
        finally:
            srv.close()
            srv.close()  # idempotent
    assert docs["port"] == docs["jax"]


# --------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    from tpu_dist_nn.core.schema import save_model
    from tpu_dist_nn.testing.factories import random_model

    path = tmp_path_factory.mktemp("obs") / "m.json"
    save_model(random_model([12, 16, 8, 3], seed=4), path)
    return path


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_engine_health_keys_and_fingerprint_equal_jax(model_file, quantize, monkeypatch):
    from tpu_dist_nn.api.engine import Engine as JEngine
    from tpu_dist_nn_torch.api.engine import Engine as PEngine

    monkeypatch.setenv("TDN_INT8_AUTO", "0")
    je = JEngine.up(model_file, quantize=quantize)
    pe = PEngine.up(model_file, device="cpu", quantize=quantize)
    assert pe.fingerprint() == je.fingerprint()
    jh, ph = je.health(probe=False), pe.health(probe=False)
    assert ph.keys() == jh.keys() and ph["fingerprint"] == jh["fingerprint"]
    assert (ph["ready"], ph["devices"], ph["pipelined"]) == (jh["ready"], jh["devices"],
                                                              jh["pipelined"])
    jh, ph = je.health(), pe.health()
    assert ph.keys() == jh.keys() and ph["probe_ok"] is jh["probe_ok"] is True
    pe.down()
    je.down()
    jh, ph = je.health(), pe.health()
    assert ph.keys() == jh.keys() and ph["ready"] is jh["ready"] is False


def test_engine_families_count_launches_hits_and_errors(model_file):
    from tpu_dist_nn_torch.api.engine import Engine
    from tpu_dist_nn_torch.obs.registry import REGISTRY

    def val(name):
        return REGISTRY.get(name).labels().value

    before = {n: val(n) for n in ("tdn_engine_compile_cache_hits_total",
                                  "tdn_engine_compile_cache_misses_total",
                                  "tdn_engine_infer_rows_total",
                                  "tdn_engine_infer_errors_total")}
    eng = Engine.up(model_file, device="cpu", warmup=False)
    x = np.random.default_rng(0).uniform(size=(5, 12))
    eng.infer(x)
    eng.infer(x)
    eng.infer(x[:2])
    with pytest.raises(Exception):
        eng.infer(np.zeros((2, 5)))
    assert val("tdn_engine_compile_cache_misses_total") - before[
        "tdn_engine_compile_cache_misses_total"] == 2
    assert val("tdn_engine_compile_cache_hits_total") - before[
        "tdn_engine_compile_cache_hits_total"] == 1
    assert val("tdn_engine_infer_rows_total") - before["tdn_engine_infer_rows_total"] == 12
    assert val("tdn_engine_infer_errors_total") - before["tdn_engine_infer_errors_total"] == 1


def test_drain_wraps_health_with_boot_id_like_jax():
    from tpu_dist_nn.serving import resilience as jres
    from tpu_dist_nn_torch.serving import resilience as pres

    out = []
    for mod in (jres, pres):
        d = mod.GracefulDrain(grace_seconds=0.1)
        fn = d.wrap_health(lambda: {"ready": True, "devices": 1})
        bare = d.wrap_health(None)
        before = (fn(), bare())
        d.begin()
        broken = d.wrap_health(_Broken())
        after = (fn(), bare(), broken())
        for doc in before + after:
            assert doc.pop("boot_id") == mod.BOOT_ID
        out.append((before, after))
    assert out[0] == out[1]
    assert len(pres.BOOT_ID) == 32 and pres.BOOT_ID != jres.BOOT_ID


# --------------------------------------------------------------- sampler


def test_runtime_sampler_samples_a_batcher_and_survives_a_broken_source():
    from tpu_dist_nn_torch.obs.runtime import RuntimeSampler
    from tpu_dist_nn_torch.serving.server import Batcher

    class Eng:
        def infer_async(self, x):
            return np.asarray(x, dtype=np.float64)

        def fetch(self, h):
            return h

    class Broken:
        requests_total = 0
        batches_total = 0

        def queue_depth(self):
            raise RuntimeError("boom")

    r = preg.Registry()
    batcher = Batcher(Eng(), method="Process")
    try:
        sampler = RuntimeSampler(interval=30.0, registry=r)
        sampler.add_batcher(batcher, method="Process")
        tracer = ptrace.Tracer()
        sampler.add_tracer(tracer)
        batcher.submit(np.zeros((3, 4)))
        sampler.sample_once()
        text = pexp.parse_prometheus_text(pexp.render(r))
        assert text['tdn_batcher_queue_depth{method="Process"}'] == 0
        assert text['tdn_batcher_coalesce_ratio{method="Process"}'] >= 1.0
        assert text['tdn_batcher_inflight_rows{method="Process"}'] == 0
        assert text["tdn_host_rss_bytes"] > 0
        # No card in this process: no device series.
        assert not any(k.startswith("tdn_device_memory_bytes{") for k in text)
        sampler.add_batcher(Broken(), method="Broken")
        with pytest.raises(RuntimeError):
            sampler.sample_once()  # a direct call propagates
        sampler.start()  # the thread's wrapper swallows and keeps going
        time.sleep(0.05)
        sampler.stop()
    finally:
        batcher.close()


def test_sampler_tick_order_matches_jax():
    from tpu_dist_nn.obs.runtime import RuntimeSampler as JS
    from tpu_dist_nn_torch.obs.runtime import RuntimeSampler as PS

    orders = []
    for cls, reg_mod in ((JS, jreg), (PS, preg)):
        order = []

        def hook(tag):
            return type("H", (), {m: (lambda self, t=tag: order.append(t))
                                  for m in ("tick", "collect", "evaluate", "check")})()

        s = cls(interval=30.0, registry=reg_mod.Registry())
        s.add_incident_recorder(hook("incident"))
        s.add_autoscaler(hook("autoscale"))
        s.add_admission_governor(hook("governor"))
        s.add_slo_tracker(hook("slo"))
        s.add_timeseries(hook("ring"))
        s.add_goodput(hook("goodput"))
        s.sample_once()
        orders.append(order)
    assert orders[0] == orders[1] == ["goodput", "ring", "slo", "governor", "autoscale",
                                      "incident"]


def test_admission_governor_tightens_and_loosens_like_jax():
    from tpu_dist_nn.serving import sched_core as jsc
    from tpu_dist_nn_torch.serving import sched_core as psc

    class Tracker:
        def __init__(self, seq):
            self.seq = iter(seq)

        def status(self):
            return {"objectives": [{"burning": next(self.seq)}]}

    seq = [True] * 5 + [False] * 14 + [True, False, True, True]
    traces = []
    for mod in (jsc, psc):
        core = mod.SchedCore("Process", max_pending_rows=100)
        gov = mod.AdmissionGovernor(Tracker(seq), [core])
        levels = []
        for _ in seq:
            levels.append(gov.tick())
            levels.append(tuple(core.tightened(c) for c in mod.SLO_CLASSES))
        traces.append(levels)
    assert traces[0] == traces[1]
    assert max(x for x in traces[1] if isinstance(x, int)) == 2
