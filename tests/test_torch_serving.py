"""The port's ``Process`` serving path against the JAX package's, on the CPU.

Both packages serve in this process over loopback gRPC, on the same
numpy-seeded models and rows: each package's client gets correct
replies from the other's server, and both servers answer the same
status code, message and trailing metadata for a wrong width, a shed, an
expired deadline, a downed engine and an engine that raises. The
batchers run against one gated fake engine under a scripted arrival and
form the same batches. The port engine runs its kernels' plain versions
(``device="cpu"``).

On the CPU the f32 plain version multiplies through BLAS, whose result
for a row can change in the last bits with the batch's row count and
the calling thread; so here a coalesced f32 reply is held within 1e-6
of its rows alone and of the bucket it rode, and the int8 replies
(integer products) bit-equal to both. The card's kernels give a row the
same bits in any batch: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold the f32 replies bit-equal to their rows alone
there.
"""

import dataclasses
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import grpc
import numpy as np
import pytest
import torch

from tpu_dist_nn.api.engine import Engine as JaxEngine
from tpu_dist_nn.core.schema import save_model
from tpu_dist_nn.serving import resilience as jax_resilience
from tpu_dist_nn.serving import sched_core as jax_sched
from tpu_dist_nn.serving import server as jax_server
from tpu_dist_nn.testing.factories import random_inputs, random_model
from tpu_dist_nn.utils import errors as jax_errors
from tpu_dist_nn_torch.api.engine import Engine
from tpu_dist_nn_torch.serving import resilience, sched_core, server
from tpu_dist_nn_torch.serving.wire import PROCESS_METHOD, encode_matrix
from tpu_dist_nn_torch.utils import errors

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
MODELS = {"mnist": [784, 128, 64, 10], "narrow": [24, 16, 8, 4]}
# tests/test_torch_engine.py::test_run_inference_matches_jax_engine's.
TOL = {None: dict(atol=1e-6, rtol=1e-5), "int8": dict(atol=1e-7, rtol=1e-6)}


@pytest.fixture(autouse=True)
def _pin_int8_serving(monkeypatch):
    monkeypatch.setenv("TDN_INT8_AUTO", "0")


@pytest.fixture(scope="module", params=list(MODELS))
def model_path(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("serve") / f"{request.param}.json"
    save_model(random_model(MODELS[request.param], seed=3), path)
    return path


def _rows(n, dim, seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (n, dim))


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["f32", "int8"])
def test_each_client_gets_correct_replies_from_the_other_server(model_path, quantize):
    jax_eng = JaxEngine.up(model_path, quantize=quantize)
    eng = Engine.up(model_path, device="cpu", quantize=quantize)
    dim = eng.model.input_dim
    jsrv, jport = jax_server.serve_engine(jax_eng, 0, host="127.0.0.1")
    psrv, pport = server.serve_engine(eng, 0, host="127.0.0.1")
    jcli = jax_server.GrpcClient(f"127.0.0.1:{pport}")
    pcli = server.GrpcClient(f"127.0.0.1:{jport}")
    try:
        for n, seed in ((1, 0), (17, 1), (64, 2)):
            x = _rows(n, dim, seed)
            want = jax_eng.infer(x)
            got_port = jcli.process(x)  # JAX client -> port server
            got_jax = pcli.process(x)  # port client -> JAX server
            assert got_port.shape == got_jax.shape == (n, eng.model.output_dim)
            np.testing.assert_allclose(got_port, want, **TOL[quantize])
            np.testing.assert_array_equal(got_jax, want.astype(np.float64))
            np.testing.assert_allclose(got_port, eng.infer(x), **TOL[quantize])
    finally:
        jcli.close(), pcli.close()
        jsrv.stop(0), psrv.stop(0)


class _Recording:
    """The port engine behind a proxy that keeps every launched batch;
    its first fetch waits for ``gate``, so requests pile up behind it."""

    def __init__(self, engine):
        self.engine, self.model, self.numpy_dtype = engine, engine.model, engine.numpy_dtype
        self.launched = []
        self.gate = threading.Event()

    def infer_async(self, x):
        self.launched.append(np.array(x))
        return self.engine.infer_async(x)

    def fetch(self, handle):
        assert self.gate.wait(30.0)
        return self.engine.fetch(handle)


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["f32", "int8"])
def test_coalesced_replies_match_the_engine_on_each_request(model_path, quantize):
    eng = Engine.up(model_path, device="cpu", quantize=quantize)
    rec = _Recording(eng)
    batcher = server.Batcher(rec)
    handler = server.make_process_handler(rec, batcher)
    dim = eng.model.input_dim
    sizes = [1, 7, 64, 3, 16, 5, 1, 33] * 3
    starts = np.cumsum([0] + sizes)
    rows = _rows(int(starts[-1]), dim, 5).astype(np.float32)
    replies = [None] * len(sizes)

    def worker(k):
        for i in range(k, len(sizes), 6):
            replies[i] = handler(encode_matrix(rows[starts[i]:starts[i + 1]]))[0]

    pool = [threading.Thread(target=worker, args=(k,)) for k in range(6)]
    for th in pool:
        th.start()
    _wait_for(lambda: batcher.requests_total == 6)  # each thread's first request
    rec.gate.set()
    for th in pool:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in pool)
    batcher.close()
    outs = [server.decode_matrix(r) for r in replies]
    assert len(rec.launched) < len(sizes)  # coalesced
    for i, out in enumerate(outs):
        alone = eng.infer(rows[starts[i]:starts[i + 1]])
        if quantize:
            np.testing.assert_array_equal(out, alone.astype(np.float64))
        else:
            np.testing.assert_allclose(out, alone, atol=1e-6, rtol=1e-6)
    # Every launched bucket holds whole requests' rows then a zeroed tail,
    # and the replies are the engine's outputs on that bucket.
    by_row = {r.tobytes(): i for i, r in enumerate(rows)}
    for bucket in rec.launched:
        assert len(bucket) & (len(bucket) - 1) == 0
        live = [by_row.get(r.tobytes()) for r in bucket]
        n = sum(v is not None for v in live)
        assert all(v is not None for v in live[:n]) and (bucket[n:] == 0).all()
        got = np.concatenate(outs)[live[:n]]
        want = eng.infer(bucket)[:n]
        if quantize:
            np.testing.assert_array_equal(got, want.astype(np.float64))
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


# --------------------------------------------------- status code parity


class _GatedEngine:
    """A fake engine for both packages' batchers: ``infer_async``
    records each launched batch, ``fetch`` waits on a gate and returns
    twice the rows; ``raises`` makes ``infer_async`` raise it."""

    def __init__(self, dim=8):
        self.model = dataclasses.make_dataclass("M", ["input_dim"])(dim)
        self.gate = threading.Event()
        self.gate.set()
        self.fetching = threading.Event()
        self.launched = []
        self.raises = None

    def infer_async(self, x):
        if self.raises is not None:
            raise self.raises
        x = np.array(x)
        self.launched.append(x)
        return x * 2.0

    def fetch(self, handle):
        self.fetching.set()
        assert self.gate.wait(30.0)
        return handle


def _raw_call(port, x, metadata=(), timeout=None):
    """One Process call on a raw channel: (code, details, trailing
    metadata as a dict) — the same bytes and headers to either server."""
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        call = ch.unary_unary(PROCESS_METHOD, request_serializer=bytes,
                              response_deserializer=bytes)
        try:
            call(encode_matrix(x), metadata=metadata, timeout=timeout)
            return "OK", None, {}
        except grpc.RpcError as e:
            return e.code().name, e.details(), dict(e.trailing_metadata() or ())


def _both_servers(make_engine, **kw):
    out = []
    for pkg in (jax_server, server):
        eng = make_engine(pkg)
        srv, port = pkg.serve_engine(eng, 0, host="127.0.0.1", **kw)
        out.append((eng, srv, port))
    return out


def _wait_for(cond, seconds=10.0):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert cond()


def _statuses(kind):
    """Drive one failure against both servers; returns their answers."""
    answers = []
    err = {"unavailable": "UnavailableError", "integrity": "IntegrityError",
           "internal": None}
    pkgs = {jax_server: jax_errors, server: errors}
    for pkg, errs in pkgs.items():
        eng = _GatedEngine()
        srv, port = pkg.serve_engine(eng, 0, host="127.0.0.1", pipeline_depth=1,
                                     max_pending_rows=6)
        try:
            if kind == "width":
                answers.append(_raw_call(port, np.zeros((2, 5))))
            elif kind in ("shed", "deadline"):
                eng.gate.clear()
                first = threading.Thread(target=_raw_call, args=(port, np.ones((2, 8))))
                first.start()
                assert eng.fetching.wait(10.0)  # batch 1 held on the device
                if kind == "deadline":
                    answers.append(_raw_call(port, np.ones((3, 8)),
                                             metadata=(("x-tdn-timeout-ms", "200"),)))
                else:
                    second = threading.Thread(target=_raw_call, args=(port, np.ones((4, 8))))
                    second.start()
                    _wait_for(lambda: srv.batcher.pending_rows == 4)
                    answers.append(_raw_call(port, np.ones((3, 8))))
                    eng.gate.set()
                    second.join(10.0)
                eng.gate.set()
                first.join(10.0)
            else:
                eng.raises = (RuntimeError("boom") if err[kind] is None
                              else getattr(errs, err[kind])("engine is down; relaunch"))
                answers.append(_raw_call(port, np.ones((2, 8))))
        finally:
            eng.gate.set()
            srv.stop(0)
    return answers


@pytest.mark.parametrize("kind,code", [
    ("width", "INVALID_ARGUMENT"), ("shed", "RESOURCE_EXHAUSTED"),
    ("deadline", "DEADLINE_EXCEEDED"), ("unavailable", "UNAVAILABLE"),
    ("integrity", "DATA_LOSS"), ("internal", "INTERNAL")])
def test_both_servers_answer_the_same_status(kind, code):
    (jcode, jmsg, jtrail), (pcode, pmsg, ptrail) = _statuses(kind)
    assert jcode == pcode == code
    assert pmsg == jmsg
    assert "x-tdn-trace-id" in ptrail and "x-tdn-trace-id" in jtrail
    assert ptrail.get("x-tdn-retry-after-ms") == jtrail.get("x-tdn-retry-after-ms")
    if kind == "width":
        assert pmsg == "expected input of shape (N, 8), got (2, 5)"
    if kind == "shed":
        assert ptrail["x-tdn-retry-after-ms"] == "5000"  # nothing drained yet


def test_a_downed_engine_is_unavailable_on_both_servers(model_path):
    jax_eng, eng = JaxEngine.up(model_path), Engine.up(model_path, device="cpu")
    answers = []
    for pkg, e in ((jax_server, jax_eng), (server, eng)):
        srv, port = pkg.serve_engine(e, 0, host="127.0.0.1")
        try:
            e.down()
            answers.append(_raw_call(port, np.zeros((2, e.model.input_dim))))
        finally:
            srv.stop(0)
    assert answers[0][:2] == answers[1][:2] == (
        "UNAVAILABLE", "engine is down; relaunch with Engine.up from the model JSON")


class _Context:
    """The JAX handler's gRPC context, recording the abort."""

    def __init__(self):
        self.trailing = ()

    def set_trailing_metadata(self, md):
        self.trailing = tuple(md)

    def abort(self, code, message):
        raise RuntimeError((code.name, message))


@pytest.mark.parametrize("name", ["InvalidArgumentError", "IntegrityError",
                                  "DeadlineExceededError", "ResourceExhaustedError",
                                  "UnavailableError", "ValueError"])
def test_abort_for_exception_maps_like_jax(name):
    def make(errs):
        e = getattr(errs, name, ValueError)("it went wrong")
        e.retry_after_ms = 250
        return e

    ctx = _Context()
    with pytest.raises(RuntimeError) as want:
        jax_server._abort_for_exception(ctx, make(jax_errors), "inference")
    with pytest.raises(server.RpcAbort) as got:
        server._abort_for_exception(make(errors), "inference")
    assert (got.value.code, got.value.message) == want.value.args[0]
    assert got.value.trailing == ctx.trailing


# ------------------------------------------------------------- batcher


def _submit_in_order(b, rows_list, errs):
    """Submit each request from its own thread, one after another: each
    is admitted before the next starts (a scripted arrival). Failures
    land in ``errs``."""
    threads = []
    for x in rows_list:
        def go(x=x):
            try:
                b.submit(x)
            except Exception as e:  # noqa: BLE001 — asserted by the caller
                errs.append(e)
        before = b.requests_total
        threads.append(threading.Thread(target=go))
        threads[-1].start()
        _wait_for(lambda: b.requests_total > before)
    return threads


def _scripted(batcher_cls, depth):
    eng = _GatedEngine()
    eng.gate.clear()
    b = batcher_cls(eng, pipeline_depth=depth, submit_timeout=30.0)
    sizes = [3, 1, 2, 5, 4, 1]
    rows = [np.full((n, 8), float(i + 1)) for i, n in enumerate(sizes)]
    errs = []
    try:
        threads = _submit_in_order(b, rows[:1], errs)
        assert eng.fetching.wait(10.0)
        _wait_for(lambda: len(eng.launched) == 1)
        if depth > 1:
            # The second slot: the next request launches while batch 1
            # is still held; the one after is popped and waits for a
            # slot, and the rest queue behind it.
            threads += _submit_in_order(b, rows[1:2], errs)
            _wait_for(lambda: len(eng.launched) == 2)
            threads += _submit_in_order(b, rows[2:3], errs)
            _wait_for(lambda: not b._core.pending_items())
            threads += _submit_in_order(b, rows[3:], errs)
        else:
            threads += _submit_in_order(b, rows[1:], errs)
        eng.gate.set()
        for th in threads:
            th.join(10.0)
    finally:
        eng.gate.set()
        b.close()
    assert not errs
    return eng.launched, b


@pytest.mark.parametrize("depth", [1, 2])
def test_batchers_form_the_same_batches_from_a_scripted_arrival(depth):
    mine, b = _scripted(server.Batcher, depth)
    theirs, jb = _scripted(jax_server._Batcher, depth)
    assert [len(x) for x in mine] == [len(x) for x in theirs]
    for m, t in zip(mine, theirs):
        np.testing.assert_array_equal(m, t)  # the same rows, the same zeroed tail
    assert (b.batches_total, b.requests_total, b.rows_total) == (
        jb.batches_total, jb.requests_total, jb.rows_total)
    assert b.batches_total < b.requests_total


def test_pipeline_depth_bounds_outstanding_launches():
    for depth in (1, 2, 3):
        eng = _GatedEngine()
        eng.gate.clear()
        b = server.Batcher(eng, pipeline_depth=depth, submit_timeout=30.0)
        outs = [None] * 8
        threads = []
        try:
            for i in range(8):
                def go(i=i):
                    outs[i] = b.submit(np.full((1, 8), float(i)))
                threads.append(threading.Thread(target=go))
                threads[-1].start()
            _wait_for(lambda: len(eng.launched) == depth and b.requests_total == 8)
            time.sleep(0.2)
            assert len(eng.launched) == depth  # the next launch waits on a slot
        finally:
            eng.gate.set()
            for th in threads:
                th.join(10.0)
            b.close()
        assert all(o is not None for o in outs)


def test_replies_and_errors_fan_out_to_their_own_requests_under_load():
    class Flaky(_GatedEngine):
        def infer_async(self, x):
            x = np.array(x)
            if (x == -1).any():
                raise errors.InvalidArgumentError("poisoned batch")
            return super().infer_async(x)

    eng = Flaky()
    b = server.Batcher(eng, submit_timeout=30.0)
    results, failures = {}, {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(k):
            for j in range(20):
                tag = k * 100 + j
                x = np.full((1 + tag % 3, 8), float(tag))
                if tag % 37 == 0:
                    x[0, 0] = -1
                try:
                    results[tag] = (x, b.submit(x))
                except errors.InvalidArgumentError as e:
                    failures[tag] = e
        pool = [threading.Thread(target=client, args=(k,)) for k in range(12)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(60.0)
        assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(old)
        b.close()
    assert len(results) + len(failures) == 240
    assert {t for t in range(1200) if t % 100 < 20 and t % 37 == 0} <= set(failures)
    assert all(str(e) == "poisoned batch" for e in failures.values())
    for x, out in results.values():
        np.testing.assert_array_equal(out, 2.0 * x)
    assert b.batches_total < 240


def test_abandoned_requests_are_discarded_at_pop():
    eng = _GatedEngine()
    eng.gate.clear()
    b = server.Batcher(eng, pipeline_depth=1, submit_timeout=30.0)
    abandoned = server._ABANDONED.labels(method="Process")
    before = abandoned.value
    try:
        first = threading.Thread(target=b.submit, args=(np.full((1, 8), 1.0),))
        first.start()
        assert eng.fetching.wait(10.0)
        with pytest.raises(errors.DeadlineExceededError, match="within 0.05s"):
            b.submit(np.full((2, 8), 7.0), timeout=0.05)
        eng.gate.set()
        first.join(10.0)
        assert b.submit(np.full((1, 8), 3.0)).tolist() == [[6.0] * 8]
    finally:
        eng.gate.set()
        b.close()
    assert all((x != 7.0).all() for x in eng.launched)  # never launched
    assert abandoned.value == before + 1


def test_close_drains_both_stages_then_refuses():
    eng = _GatedEngine()
    eng.gate.clear()
    b = server.Batcher(eng, pipeline_depth=2, submit_timeout=30.0)
    outs = [None] * 4
    threads = []
    for i in range(4):
        def go(i=i):
            outs[i] = b.submit(np.full((1, 8), float(i + 1)))
        threads.append(threading.Thread(target=go))
        threads[-1].start()
    assert eng.fetching.wait(10.0)
    closer = threading.Thread(target=b.close)
    closer.start()
    time.sleep(0.1)
    eng.gate.set()
    closer.join(15.0)
    for th in threads:
        th.join(10.0)
    assert not closer.is_alive()
    assert [o.tolist() for o in outs] == [[[2.0 * (i + 1)] * 8] for i in range(4)]
    with pytest.raises(errors.UnavailableError, match="shutting down"):
        b.submit(np.ones((1, 8)))


def test_a_lone_request_on_a_bucket_boundary_is_launched_as_it_is():
    seen = []

    class Keep(_GatedEngine):
        def infer_async(self, x):
            seen.append(x)
            return np.asarray(x) * 2.0

    b = server.Batcher(Keep(), submit_timeout=30.0)
    try:
        x = np.arange(64, dtype=np.float32).reshape(8, 8)
        np.testing.assert_array_equal(b.submit(x), 2.0 * x)
        assert seen[-1] is x  # the zero-copy lane: the caller's array itself
        np.testing.assert_array_equal(b.submit(x[:5]), 2.0 * x[:5])
        assert seen[-1] is not x and len(seen[-1]) == 8 and (seen[-1][5:] == 0).all()
        wm = server.decode_matrix_lazy(encode_matrix(x), dtype=np.float32)
        np.testing.assert_array_equal(b.submit(wm), 2.0 * x)
        assert isinstance(seen[-1], np.ndarray) and seen[-1].dtype == np.float32
    finally:
        b.close()


# ------------------------------------------------- sched core, resilience


def test_sched_core_admits_sheds_and_expires_like_jax():
    def run(mod):
        core = mod.SchedCore("Process", max_pending_rows=10, submit_timeout=5.0,
                             class_watermarks={"best_effort": 0.5})
        log = []
        def item(n, cls, timeout=None):
            it = {"x": np.zeros((n, 2)), "done": threading.Event(), "err": None,
                  "abandoned": False, "t_submit": time.monotonic(), "slo_class": cls}
            try:
                core.admit(it, timeout)
                log.append(("admit", n, cls))
            except Exception as e:  # noqa: BLE001 — recorded for the comparison
                log.append((type(e).__name__, str(e).split(";")[0],
                            getattr(e, "retry_after_ms", None)))
            return it
        item(20, "standard")  # oversized against an empty queue: admitted
        item(1, "best_effort")
        item(3, "critical")
        expired = item(2, "standard", timeout=0.0)
        with core.cond:
            batch, rows = core.pop_group(100)
        log.append(("pop", [len(it["x"]) for it in batch], rows, expired["err"] is not None))
        item(4, "best_effort")
        item(6, "best_effort")
        item(5, "standard")
        item(7, "standard")
        item(1, "Critical ")
        with core.cond:
            log.append(("order", [(len(it["x"]), it["slo_class"])
                                  for it in core.pending_items()]))
        core.close_begin()
        core.sweep_leftovers()
        item(1, "standard")
        return log

    assert run(sched_core) == run(jax_sched)
    for value in (None, "", "CRITICAL", "nope", 3):
        assert sched_core.normalize_class(value) == jax_sched.normalize_class(value)
    with pytest.raises(ValueError, match="unknown SLO class"):
        sched_core.validate_class_watermarks({"gold": 1.0})
    with pytest.raises(ValueError, match=r"in \[0, 1\]"):
        sched_core.validate_class_watermarks({"critical": 2.0})


def test_retry_policy_and_breaker_behave_like_jax():
    mine = resilience.RetryPolicy(seed=7)
    theirs = jax_resilience.RetryPolicy(seed=7)
    assert [mine.backoff(a, floor=f) for a in (1, 2, 3, 9) for f in (None, 0.2)] == \
        [theirs.backoff(a, floor=f) for a in (1, 2, 3, 9) for f in (None, 0.2)]
    for code in ("UNAVAILABLE", "DEADLINE_EXCEEDED", "INTERNAL", grpc.StatusCode.UNAVAILABLE,
                 errors.UnavailableError("x"), "RESOURCE_EXHAUSTED"):
        assert mine.retryable(code) == theirs.retryable(code)
    with pytest.raises(ValueError):
        resilience.RetryPolicy(max_attempts=0)

    now = [0.0]
    trail = []
    for mod in (resilience, jax_resilience):
        br = mod.CircuitBreaker(f"t-{mod.__name__}", failure_threshold=2,
                                cooldown_seconds=1.0, clock=lambda: now[0])
        now[0] = 0.0
        steps = []
        for op in ("f", "a", "f", "a", "t+2", "a", "a", "f", "a", "t+2", "a", "s", "a"):
            if op == "f":
                br.record_failure()
            elif op == "s":
                br.record_success()
            elif op.startswith("t+"):
                now[0] += float(op[2:])
            else:
                steps.append(br.allow())
            steps.append(br.state)
        trail.append(steps)
    assert trail[0] == trail[1]


def test_graceful_drain_stops_servers_with_grace_and_sets_drained():
    class Srv:
        def __init__(self):
            self.graces = []
            self.ev = threading.Event()

        def stop(self, grace=None):
            self.graces.append(grace)
            return self.ev

    d = resilience.GracefulDrain(grace_seconds=1.5)
    s = Srv()
    d.add_server(s)
    ev = d.begin()
    assert d.begin() is ev and s.graces == [1.5] and d.draining.is_set()
    assert not d.wait(0.05)
    s.ev.set()
    assert d.wait(5.0)
    assert resilience.GracefulDrain().begin().is_set()  # no server: drained at once


def test_client_retries_transient_statuses_and_honours_the_breaker():
    calls = []

    class Down(_GatedEngine):
        def infer(self, x):
            x = np.asarray(x)
            if x.shape[1] != 8:
                raise ValueError("bad width")
            calls.append(len(x))
            if len(calls) < 3:
                raise errors.UnavailableError("warming up")
            return np.asarray(x) * 2.0

    srv, port = server.serve_engine(Down(), 0, host="127.0.0.1", coalesce=False)
    try:
        sleeps = []
        c = server.GrpcClient(f"127.0.0.1:{port}", breaker=None,
                              retry=resilience.RetryPolicy(seed=1, sleep=sleeps.append))
        out = c.process(np.ones((2, 8)))
        assert out.tolist() == [[2.0] * 8] * 2 and len(calls) == 3 and len(sleeps) == 2
        c.close()
        br = resilience.CircuitBreaker("open-target", failure_threshold=1,
                                       cooldown_seconds=60.0)
        br.record_failure()
        c = server.GrpcClient(f"127.0.0.1:{port}", breaker=br)
        with pytest.raises(errors.UnavailableError, match="circuit breaker open"):
            c.process(np.ones((1, 8)))
        c.close()
        c = server.GrpcClient(f"127.0.0.1:{port}", retry=None, breaker=None,
                              session_key="s1", slo_class="critical")
        with pytest.raises(grpc.RpcError) as e:
            c.process(np.ones((1, 5)))
        assert e.value.code() == grpc.StatusCode.INTERNAL
        assert e.value.details() == "inference failed: bad width"
        assert e.value.server_trace_id
        c.close()
    finally:
        srv.stop(0)
    with pytest.raises(errors.UnavailableError, match="not ready"):
        server.GrpcClient("127.0.0.1:1", wait_for_ready=True, ready_timeout=0.2)


_BLOCKED_RUN = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "tpu_dist_nn", "grpc")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import threading
import numpy as np
import torch
import tpu_dist_nn_torch
for m in pkgutil.walk_packages(tpu_dist_nn_torch.__path__, "tpu_dist_nn_torch."):
    importlib.import_module(m.name)
from tpu_dist_nn_torch.api.engine import Engine
from tpu_dist_nn_torch.models.fcnn import init_fcnn, spec_from_params
from tpu_dist_nn_torch.serving import (
    Batcher, GrpcClient, RpcAbort, decode_matrix, encode_matrix, make_process_handler,
    serve_engine)
from tpu_dist_nn_torch.testing.oracle import oracle_forward_batch
params = init_fcnn(torch.Generator().manual_seed(0), [12, 8, 3], device="cpu")
model = spec_from_params(params, ["relu", "softmax"])
for q in (None, "int8"):
    eng = Engine.up(model, device="cpu", quantize=q)
    for depth in (1, 2):
        b = Batcher(eng, pipeline_depth=depth)
        handle = make_process_handler(eng, b)
        rows = np.random.default_rng(0).uniform(size=(40, 12)).astype(np.float32)
        outs = [None] * 8
        def go(i):
            outs[i] = decode_matrix(handle(encode_matrix(rows[5 * i:5 * i + 5]))[0])
        ts = [threading.Thread(target=go, args=(i,)) for i in range(8)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        got = np.concatenate(outs)
        assert got.shape == (40, 3)
        if q is None:
            assert np.abs(got - oracle_forward_batch(model, rows)).max() < 1e-5
        try:
            handle(encode_matrix(np.zeros((2, 11))))
            raise SystemExit("no abort")
        except RpcAbort as e:
            assert e.code == "INVALID_ARGUMENT", e.code
        b.close()
for fn in (lambda: serve_engine(eng, 0), lambda: GrpcClient("127.0.0.1:1")):
    try:
        fn()
        raise SystemExit("no ImportError")
    except ImportError as e:
        assert "grpcio" in str(e), e
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("served without jax and grpc")
"""


def test_handler_and_batcher_run_with_jax_and_grpc_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "served without jax and grpc" in proc.stdout
