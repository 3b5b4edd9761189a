"""The port's flight recorder against the JAX package's
(:mod:`tpu_dist_nn.obs.incident`).

Each detector fires on the same registry / ring / SLO deltas as JAX's,
with the same reason text; a bundle's zip members and manifest keys are
JAX's; the store prunes past ``max_incidents``; a detector's cooldown
holds; the incident routes answer with JAX's status codes; and a crash
leaves a bundle. Exact comparisons (no tolerance).
"""

import io
import json
import os
import subprocess
import sys
import time
import zipfile
from pathlib import Path

import pytest

from tpu_dist_nn.obs import incident as jinc
from tpu_dist_nn.obs import registry as jreg
from tpu_dist_nn.obs import timeseries as jts
from tpu_dist_nn.obs import trace as jtrace
from tpu_dist_nn_torch.obs import incident as pinc
from tpu_dist_nn_torch.obs import registry as preg
from tpu_dist_nn_torch.obs import timeseries as pts
from tpu_dist_nn_torch.obs import trace as ptrace

PKGS = {"jax": (jinc, jreg, jts, jtrace), "port": (pinc, preg, pts, ptrace)}
ROOT = Path(__file__).resolve().parents[1]


class _Slo:
    def __init__(self, burns):
        self.burns = burns

    def status(self):
        return {"objectives": [
            {"name": f"o{i}", "objective": "p99 <= 50ms",
             "windows": {"fast": {"burn_rate": b, "total": 10.0 if b else 0.0}}}
            for i, b in enumerate(self.burns)]}


class _Pool:
    def __init__(self):
        self.transitions_total = 0
        self.states = {"a:1": "active", "b:1": "active"}

    def snapshot(self):
        return [{"target": t, "state": s} for t, s in sorted(self.states.items())]


class _Rec:
    def __init__(self, registry, ring=None, slo=None, pool=None):
        self.registry, self.ring, self.slo, self.pool = registry, ring, slo, pool


def _detector_run(name):
    inc, reg_mod, ts_mod, _ = PKGS[name]
    r = reg_mod.Registry()
    ring = ts_mod.TimeSeriesRing(resolution=1.0, retention=600.0, registry=r,
                                 families=("tdn_rpc_errors_total", "tdn_batcher_shed_total",
                                           "tdn_router_requests_total"))
    errors = r.counter("tdn_rpc_errors_total", "", labels=("method", "code"))
    shed = r.counter("tdn_batcher_shed_total", "", labels=("method",))
    routed = r.counter("tdn_router_requests_total", "", labels=("replica", "outcome"))
    breaker = r.gauge("tdn_breaker_state", "", labels=("target",))
    failovers = r.counter("tdn_router_failovers_total", "")
    flaps = r.counter("tdn_autoscale_flaps_total", "")
    slo = _Slo([0.0, 0.0])
    pool = _Pool()
    rec = _Rec(r, ring, slo, pool)
    dets = inc.default_detectors(router=True) + inc.default_detectors()
    fired = []
    for k in range(12):
        now = 100.0 + k
        if k == 2:
            errors.labels(method="Process", code="UNAVAILABLE").inc(7)
        if k == 3:
            shed.labels(method="Process").inc()
            slo.burns = [2.5, 0.5]
        if k == 4:
            breaker.labels(target="a:1").set(2)
            routed.labels(replica="a:1", outcome="error").inc(9)
            routed.labels(replica="a:1", outcome="ok").inc(50)
        if k == 5:
            breaker.labels(target="b:1").set(2)
            failovers.inc(2)
            pool.transitions_total += 1
            pool.states["a:1"] = "draining"
        if k == 6:
            flaps.inc()
            breaker.labels(target="a:1").set(0)
            slo.burns = [0.0, 0.0]
        if k == 8:
            breaker.labels(target="a:1").set(2)
        ring.collect(now=now)
        fired.append([(getattr(d, "name", type(d).__name__), d.check(rec, now)) for d in dets])
    return fired


def test_detectors_fire_on_the_same_deltas_as_jax():
    jf, pf = _detector_run("jax"), _detector_run("port")
    assert pf == jf
    names = {n for tick in pf for n, reason in tick if reason}
    assert names == {"slo.burn", "breaker.open", "rpc.error_spike", "batcher.shed_spike",
                     "router.error_spike", "drain.failover", "autoscale.flap"}


@pytest.mark.parametrize("kw", [
    {}, {"min_count": 1.0}, {"match": {"method": "Generate"}}, {"window": 2.0},
    {"exclude": {"code": "UNAVAILABLE"}}])
def test_spike_detector_options_match_jax(kw):
    out = []
    for name in ("jax", "port"):
        inc, reg_mod, ts_mod, _ = PKGS[name]
        r = reg_mod.Registry()
        ring = ts_mod.TimeSeriesRing(resolution=1.0, registry=r,
                                     families=("tdn_rpc_errors_total",))
        c = r.counter("tdn_rpc_errors_total", "", labels=("method", "code"))
        det = inc.SpikeDetector("x.spike", "tdn_rpc_errors_total", **kw)
        got = []
        for k in range(6):
            c.labels(method=["Process", "Generate"][k % 2], code=["UNAVAILABLE", "INTERNAL"][k % 2]
                     ).inc(k + 1)
            ring.collect(now=10.0 + k)
            got.append(det.check(_Rec(r, ring), 10.0 + k))
        out.append(got)
    assert out[0] == out[1]


def _bundle(name, tmp, with_sources):
    inc, reg_mod, ts_mod, trace_mod = PKGS[name]
    tracer = trace_mod.Tracer(sample_rate=1.0)
    with tracer.start("rpc.Process") as sp:
        sp.set("rows", 3)
    r = reg_mod.Registry()
    r.counter("tdn_rpc_requests_total", "", labels=("method",)).labels(method="Process").inc()
    kw = {}
    if with_sources:
        ring = ts_mod.TimeSeriesRing(registry=r)
        ring.collect()
        kw = dict(ring=ring, slo=_Slo([0.0]), details={"why": "test"},
                  extra_files={"extra.txt": b"x"}, extra_manifest={"note": 1})
    iid, data = inc.capture_bundle("manual", "a reason", tracer=tracer, registry=r, **kw)
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        members = z.namelist()
        manifest = json.loads(z.read("manifest.json"))
        trace = json.loads(z.read("trace.json"))
    return iid, members, manifest, trace


@pytest.mark.parametrize("with_sources", [False, True])
def test_bundle_members_and_manifest_keys_equal_jax(tmp_path, with_sources):
    import torch

    jid, jmem, jman, jtr = _bundle("jax", tmp_path, with_sources)
    pid, pmem, pman, ptr = _bundle("port", tmp_path, with_sources)
    assert pmem == jmem and pman.keys() == jman.keys()
    assert pman["sections"] == jman["sections"]
    assert pinc._BUNDLE_NAME.match(pid + ".zip") and jinc._BUNDLE_NAME.match(jid + ".zip")
    assert pman["versions"]["torch"] == torch.__version__ and "jax" not in pman["versions"]
    assert [e["name"] for e in ptr["traceEvents"] if e["ph"] == "X"] == ["rpc.Process"]


def test_bundle_salvages_past_a_broken_section_like_jax():
    class BadRing:
        resolution = retention = 1.0

        def series(self, **kw):
            raise RuntimeError("ring broke")

    out = []
    for name in ("jax", "port"):
        inc, reg_mod, _, trace_mod = PKGS[name]
        _, data = inc.capture_bundle("t", tracer=trace_mod.Tracer(), registry=reg_mod.Registry(),
                                     ring=BadRing())
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            m = json.loads(z.read("manifest.json"))
            out.append((z.namelist(), m["section_errors"]))
    assert out[0] == out[1]


@pytest.mark.parametrize("max_incidents", [1, 3])
def test_store_prunes_past_max_like_jax(tmp_path, max_incidents):
    listed = []
    for name in ("jax", "port"):
        inc, reg_mod, _, trace_mod = PKGS[name]
        d = tmp_path / name
        store = inc.IncidentStore(str(d), max_incidents=max_incidents)
        (d / "pulled_copy.zip").write_bytes(b"PK\x05\x06" + b"\0" * 18)
        for i in range(5):
            iid, data = inc.capture_bundle(f"trig{i}", "r", tracer=trace_mod.Tracer(),
                                           registry=reg_mod.Registry())
            store.save(iid, data)
            time.sleep(0.02)  # distinct mtimes: prune order is arrival order
        assert (d / "pulled_copy.zip").exists()
        assert store.read("nonexistent") is None and store.manifest("nonexistent") is None
        listed.append([m["trigger"] for m in store.list()])
        with pytest.raises(ValueError):
            inc.IncidentStore(str(d), max_incidents=0)
    assert listed[0] == listed[1] == [f"trig{i}" for i in range(4, 4 - max_incidents, -1)]


class _Always:
    def __init__(self, name, cooldown=None):
        self.name = name
        if cooldown is not None:
            self.cooldown = cooldown

    def check(self, rec, now=None):
        return "always"


class _Raises:
    name = "broken"

    def check(self, rec, now=None):
        raise RuntimeError("detector bug")


@pytest.mark.parametrize("cooldown", [5.0, 30.0])
def test_cooldown_holds_like_jax(tmp_path, cooldown):
    counts = []
    for name in ("jax", "port"):
        inc, reg_mod, _, trace_mod = PKGS[name]
        rec = inc.FlightRecorder(inc.IncidentStore(str(tmp_path / name), max_incidents=50),
                                 detectors=[_Always("a"), _Always("b", cooldown=2.0), _Raises()],
                                 tracer=trace_mod.Tracer(), registry=reg_mod.Registry(),
                                 cooldown=cooldown)
        per_tick = [len(rec.check(now=float(t))) for t in range(0, 40, 1)]
        counts.append((per_tick, rec.captured_total, len(rec.store.ids())))
        # Without a store nothing is checked.
        assert inc.FlightRecorder(None, detectors=[_Always("a")], tracer=trace_mod.Tracer(),
                                  registry=reg_mod.Registry()).check(now=0.0) == []
    assert counts[0] == counts[1]


def _get(port, path):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


@pytest.mark.parametrize("armed", [False, True])
def test_incident_routes_match_jax(tmp_path, armed):
    from tpu_dist_nn.obs import exposition as jexp
    from tpu_dist_nn_torch.obs import exposition as pexp

    out = {}
    for name, exp_mod in (("jax", jexp), ("port", pexp)):
        inc, reg_mod, _, trace_mod = PKGS[name]
        store = inc.IncidentStore(str(tmp_path / name)) if armed else None
        rec = inc.FlightRecorder(store, tracer=trace_mod.Tracer(), registry=reg_mod.Registry())
        srv = exp_mod.MetricsServer(0, "127.0.0.1", registry=reg_mod.Registry())
        srv.add_routes(inc.incident_routes(rec))
        try:
            got = []
            for path in ("/incidents", "/incidents/get", "/incidents/get?id=nope",
                         "/debug/bundle?persist=1&reason=drill", "/debug/bundle?fleet=0",
                         "/incidents"):
                st, ct, body = _get(srv.port, path)
                if ct == "application/zip":
                    with zipfile.ZipFile(io.BytesIO(body)) as z:
                        m = json.loads(z.read("manifest.json"))
                    body = (z.namelist(), m["trigger"], m["reason"])
                elif path == "/incidents" and st == 200:
                    doc = json.loads(body)
                    body = (doc["max_incidents"], doc["captured_total"],
                            [m["trigger"] for m in doc["incidents"]])
                got.append((st, ct, body))
            out[name] = got
        finally:
            srv.close()
    assert out["port"] == out["jax"]


_CRASH = r"""
import sys, threading
from tpu_dist_nn_torch.obs.incident import FlightRecorder, IncidentStore, install_crash_hook
from tpu_dist_nn_torch.obs.trace import Tracer
tracer = Tracer(sample_rate=1.0)
with tracer.start("rpc.Process"):
    pass
rec = FlightRecorder(IncidentStore(sys.argv[1]), tracer=tracer)
install_crash_hook(rec)
if sys.argv[2] == "thread":
    t = threading.Thread(target=lambda: 1 / 0, name="worker")
    t.start(); t.join()
    sys.exit(0)
raise RuntimeError("injected crash for the flight recorder")
"""


@pytest.mark.parametrize("mode,trigger,rc", [("exc", "crash.exception", 1),
                                             ("thread", "crash.thread_exception", 0)])
def test_crash_hook_leaves_a_valid_bundle(tmp_path, mode, trigger, rc):
    proc = subprocess.run([sys.executable, "-c", _CRASH, str(tmp_path), mode], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == rc, proc.stderr[-2000:]
    store = pinc.IncidentStore(str(tmp_path))
    (iid,) = store.ids()
    m = store.manifest(iid)
    assert m["trigger"] == trigger and "traceback" in m["details"]
    with zipfile.ZipFile(io.BytesIO(store.read(iid))) as z:
        trace = json.loads(z.read("trace.json"))
    assert any(e["name"] == "rpc.Process" for e in trace["traceEvents"] if e["ph"] == "X")
    assert (tmp_path / "faulthandler.log").exists()


def test_fleet_capture_is_refused_until_the_router_lands():
    rec = pinc.FlightRecorder(None, pool=_Pool(), tracer=ptrace.Tracer(),
                              registry=preg.Registry())
    with pytest.raises(NotImplementedError, match="fleet capture"):
        rec.bundle("manual")
    iid, data = rec.bundle("manual", fleet=False)
    assert data.startswith(b"PK")
