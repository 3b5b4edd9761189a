"""The port's integrity plane against the JAX package's, on the CPU.

Checksums, fingerprints and mismatch reports equal to JAX's on the same
numpy trees (and on torch trees of the same values, bfloat16 included);
the numeric guard's row mask and its disarm switch equal to JAX's; the
canary inputs and reply digests equal. F8 (the guard the port's Process
serving lacked): the port's ``Engine.infer`` raises ``IntegrityError``
on a non-finite row where JAX's does, ``Engine.fetch`` stashes the row
mask and raises on an all-bad launch, and a coalesced ``Batcher``
launch with one poisoned request fails that request alone with
``DATA_LOSS`` while its neighbours ship their slices of the same launch
bit-identical, in process and over loopback gRPC. The continuous
scheduler's decode-step guard fails the bad slot alone, on the
cost-model scheduler (JAX's test) and on the real step with a NaN
forced into one slot's cache through ``fetch_hook``.
"""

import threading
import time

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist_nn.api.engine import Engine as JaxEngine
from tpu_dist_nn.core.schema import save_model
from tpu_dist_nn.models import transformer as jt
from tpu_dist_nn.serving import integrity as jint
from tpu_dist_nn.testing.factories import random_model
from tpu_dist_nn.utils import errors as jax_errors
from tpu_dist_nn_torch.api.engine import Engine
from tpu_dist_nn_torch.models.transformer import TransformerConfig, transformer_params_from_jax
from tpu_dist_nn_torch.serving import integrity as pint
from tpu_dist_nn_torch.serving.continuous import ContinuousScheduler
from tpu_dist_nn_torch.serving.server import (
    Batcher,
    GrpcClient,
    RpcAbort,
    make_process_handler,
    serve_engine,
)
from tpu_dist_nn_torch.serving.wire import decode_matrix, encode_matrix
from tpu_dist_nn_torch.utils.errors import IntegrityError

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _armed_guard():
    """Every test assumes the guard is armed, in both packages."""
    saved = pint.GUARD.enabled, jint.GUARD.enabled
    pint.GUARD.enabled = jint.GUARD.enabled = True
    yield
    pint.GUARD.enabled, jint.GUARD.enabled = saved


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"blocks": {"w_qkv": rng.normal(size=(2, 4, 12)).astype(np.float32),
                       "b": rng.normal(size=(2, 12))},
            "tok_embed": rng.integers(0, 9, (5, 4)).astype(np.int32),
            "layers": [rng.normal(size=3).astype(np.float32), np.float64(2.5)]}


# ------------------------------------------------------- fingerprints


def test_checksums_and_fingerprints_equal_jax():
    tree = _tree()
    assert pint.fingerprint_tree(tree) == jint.fingerprint_tree(tree)
    flat = {"w": tree["blocks"]["w_qkv"], "b": tree["blocks"]["b"]}
    assert pint.fingerprint_tree(flat) == jint.fingerprint_tree(flat)
    for leaf in (tree["blocks"]["b"], tree["tok_embed"], np.zeros((0, 3)), np.float32(1.0)):
        assert pint.array_checksum(leaf) == jint.array_checksum(leaf)
    # A non-contiguous view hashes as its contiguous copy, in both.
    view = tree["blocks"]["w_qkv"][:, ::2]
    assert pint.array_checksum(view) == jint.array_checksum(view)


def test_torch_trees_fingerprint_like_their_jax_arrays():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5)).astype(np.float32)
    jtree = {"a": {"x": jnp.asarray(x), "h": jnp.asarray(x, jnp.bfloat16)}}
    ptree = {"a": {"x": torch.from_numpy(x), "h": torch.from_numpy(x).bfloat16()}}
    assert pint.fingerprint_tree(ptree) == jint.fingerprint_tree(jtree)


def test_params_fingerprint_equal_through_the_weight_carrier():
    cfg = dict(vocab_size=16, d_model=8, n_heads=2, n_layers=2, d_ff=16, max_seq_len=8)
    jparams = jax.tree.map(np.asarray, jt.init_transformer(jax.random.key(0),
                                                           jt.TransformerConfig(**cfg)))
    params = transformer_params_from_jax(jparams, device="cpu")
    assert pint.fingerprint_tree(params) == jint.fingerprint_tree(jparams)


def test_verify_tree_reports_equal_to_jax():
    tree = _tree()
    saved = jint.fingerprint_tree(tree)
    assert pint.verify_tree(tree, saved) == [] == jint.verify_tree(tree, saved)
    flipped = _tree()
    flipped["blocks"]["b"][0, 0] += 1e-9
    assert pint.verify_tree(flipped, saved) == jint.verify_tree(flipped, saved)
    assert len(pint.verify_tree(flipped, saved)) == 1
    dropped = _tree()
    del dropped["tok_embed"]
    dropped["extra"] = np.ones(2)
    assert pint.verify_tree(dropped, saved) == jint.verify_tree(dropped, saved)
    assert len(pint.verify_tree(dropped, saved)) == 2
    tampered = dict(saved, model="0" * 64)
    assert pint.verify_tree(tree, tampered) == jint.verify_tree(tree, tampered)


def test_canary_inputs_and_reply_digest_equal_jax():
    np.testing.assert_array_equal(pint.canary_rows(12, rows=3), jint.canary_rows(12, rows=3))
    np.testing.assert_array_equal(pint.canary_prompts(8, 64, rows=2),
                                  jint.canary_prompts(8, 64, rows=2))
    assert pint.reply_digest(b"\x0a\x01") == jint.reply_digest(b"\x0a\x01")
    assert set(pint.overhead_snapshot()) == set(jint.overhead_snapshot())


# ------------------------------------------------------- numeric guard


def test_guard_mask_semantics_equal_jax_and_disarm_switches(monkeypatch):
    outs = [np.array([[1.0, 2.0], [np.nan, 0.0], [np.inf, 1.0], [2e8, 0.0], [-1e8, 0.0]]),
            np.ones((3, 2, 2), np.float32), np.array([1.0, np.nan]), np.arange(4),
            np.zeros((0, 3)), np.float64(np.nan)]
    outs[1][1, 0, 1] = -np.inf
    for out in outs:
        got, want = pint.GUARD.bad_rows(out), jint.GUARD.bad_rows(out)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pint.GUARD.bad_rows(outs[0]),
                                  [False, True, True, True, False])
    rows0 = pint.overhead_snapshot()["guard_rows_failed"]
    pint.GUARD.bad_rows(outs[0])
    assert pint.overhead_snapshot()["guard_rows_failed"] == rows0 + 3
    assert pint.NumericGuard(abs_limit=0).bad_rows(outs[0]).tolist() == [False, True, True,
                                                                          False, False]
    pint.GUARD.enabled = False
    assert pint.GUARD.bad_rows(outs[0]) is None
    monkeypatch.setenv("TDN_INTEGRITY_GUARD", "0")
    assert not pint.NumericGuard().enabled and not jint.NumericGuard().enabled
    monkeypatch.setenv("TDN_INTEGRITY_GUARD", "1")
    assert pint.NumericGuard().enabled and pint.NumericGuard().abs_limit == 1e8


@pytest.mark.parametrize("shape,dtype,poison", [
    ((8192, 10), np.float32, ()), ((8192, 10), np.float32, ("nan", "big")),
    ((64, 3, 5), np.float64, ("-inf",)), ((7,), np.float32, ("nan",)),
    ((33, 4), np.float16, ("inf",)), ((5, 2), np.float64, ("edge",)),
])
def test_guard_mask_equal_jax_on_clean_and_poisoned_batches(shape, dtype, poison):
    rng = np.random.default_rng(len(shape) * 7 + len(poison))
    out = (rng.standard_normal(shape) * 1e3).astype(dtype)
    values = {"nan": np.nan, "inf": np.inf, "-inf": -np.inf, "big": -2e8, "edge": -1e8}
    for k, what in enumerate(poison):
        out[(rng.integers(0, shape[0]),) + (k % 2,) * (len(shape) - 1)] = values[what]
    got, want = pint.GUARD.bad_rows(out), jint.GUARD.bad_rows(out)
    assert got.shape == (shape[0],) and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert int(got.sum()) == sum(w != "edge" for w in poison)


# ------------------------------------------------- F8: the Process path


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("guard") / "m.json"
    save_model(random_model([12, 16, 8, 4], seed=3), path)
    return path


def _rows(n, seed, poison=()):
    x = np.random.default_rng(seed).uniform(0.0, 1.0, (n, 12)).astype(np.float32)
    for r in poison:
        x[r, 5] = np.nan
    return x


def test_engine_infer_raises_where_jax_engine_does(model_path):
    eng = Engine.up(model_path, device="cpu")
    jeng = JaxEngine.up(model_path)
    x = _rows(3, 13, poison=(1,))
    with pytest.raises(jax_errors.IntegrityError, match="numeric guard"):
        jeng.infer(x)
    with pytest.raises(IntegrityError, match="numeric guard") as ei:
        eng.infer(x)
    assert ei.value.code == "INTEGRITY"
    clean = _rows(3, 14)
    np.testing.assert_allclose(eng.infer(clean), jeng.infer(clean), rtol=1e-5, atol=1e-6)
    # fetch: a partial mask is stashed on the handle; an all-bad launch
    # raises; the disarmed guard ships what the device computed.
    pending = eng.infer_async(x)
    out = eng.fetch(pending)
    assert pending.bad_rows.tolist() == [False, True, False] and np.isnan(out[1]).any()
    with pytest.raises(IntegrityError, match="all 2 rows"):
        eng.fetch(eng.infer_async(_rows(2, 15, poison=(0, 1))))
    pint.GUARD.enabled = False
    assert np.isnan(eng.infer(x)[1]).any()


class _Gated:
    """An engine whose FIRST launch waits at a gate, so the requests
    sent meanwhile queue and coalesce into the next launch."""

    def __init__(self, eng):
        self.eng, self.gate, self.launched = eng, threading.Event(), []
        self.model, self.numpy_dtype, self.fetch = eng.model, eng.numpy_dtype, eng.fetch

    def infer_async(self, x):
        self.gate.wait(30.0)
        self.launched.append(np.array(x))
        return self.eng.infer_async(x)


def _wait_for(cond):
    deadline = time.monotonic() + 30.0
    while not cond():
        assert time.monotonic() < deadline
        time.sleep(1e-3)


def test_batcher_fails_the_poisoned_request_alone_with_data_loss(model_path):
    eng = Engine.up(model_path, device="cpu")
    gated = _Gated(eng)
    batcher = Batcher(gated, pipeline_depth=1)
    handler = make_process_handler(gated, batcher)
    reqs = [_rows(3, 20 + i, poison=(2,) if i == 2 else ()) for i in range(5)]
    replies = [None] * 5

    def send(i):
        try:
            replies[i] = decode_matrix(handler(encode_matrix(reqs[i]))[0])
        except RpcAbort as e:
            replies[i] = e

    try:
        head = threading.Thread(target=handler, args=(encode_matrix(_rows(4, 19)),))
        head.start()
        _wait_for(lambda: batcher.requests_total == 1 and batcher.pending_rows == 0)
        senders = [threading.Thread(target=send, args=(i,)) for i in range(5)]
        for th in senders:
            th.start()
        _wait_for(lambda: batcher.pending_rows == 15)
        gated.gate.set()
        for th in senders + [head]:
            th.join(30)
    finally:
        batcher.close()
    assert batcher.batches_total == 2
    bad = replies[2]
    assert isinstance(bad, RpcAbort) and bad.code == "DATA_LOSS"
    assert "1 of this request's 3 rows" in bad.message
    # The neighbours' replies are their slices of the same launch (the
    # queue's order is the threads' arrival order: found in the launch).
    batch = gated.launched[1]
    launch = eng.fetch(eng.infer_async(batch))
    for i in (0, 1, 3, 4):
        at = next(j for j in range(5) if np.array_equal(batch[3 * j:3 * j + 3], reqs[i]))
        np.testing.assert_array_equal(replies[i], launch[3 * at:3 * at + 3].astype(np.float64))


def test_poisoned_request_is_data_loss_over_grpc_clean_one_ships(model_path):
    eng = Engine.up(model_path, device="cpu")
    srv, port = serve_engine(eng, 0, host="127.0.0.1")
    try:
        c = GrpcClient(f"127.0.0.1:{port}", retry=None)
        with pytest.raises(grpc.RpcError) as ei:
            c.process(_rows(3, 30, poison=(0,)))
        assert ei.value.code() == grpc.StatusCode.DATA_LOSS
        np.testing.assert_allclose(c.process(_rows(3, 31)), eng.infer(_rows(3, 31)),
                                   rtol=1e-6, atol=1e-7)
        c.close()
    finally:
        srv.stop(0)


# --------------------------------------------- the decode-step guard


def test_decode_step_guard_fails_bad_slot_alone():
    # JAX's test on the cost-model scheduler: the internal step returns
    # an ok vector; the injected seam's ok=None leaves the guard off.
    T, N = 4, 40

    def fake_prefill(params, cache, slot, tokens, start, key):
        return np.int32(1), cache

    def fake_step(params, cache, pos, active, tok, key):
        time.sleep(0.005)
        return np.asarray(tok) + 1, cache

    sched = ContinuousScheduler(None, None, prefill_fn=fake_prefill, step_fn=fake_step,
                                slots=2, prompt_len=T, max_new_tokens=N)
    wrapped = sched._step
    try:
        assert sched.submit(np.ones((1, T), np.int32), max_new_tokens=2).shape == (1, T + N)

        def poisoned(params, cache, pos, active, tok, key):
            toks, _ok, cache = wrapped(params, cache, pos, active, tok, key)
            ok = np.ones(2, bool)
            if active[0] and active[1]:
                ok[1] = False
            return toks, ok, cache

        sched._step = poisoned
        outs, errs = [], []

        def caller(seed):
            try:
                outs.append(sched.submit(np.full((1, T), seed, np.int32)))
            except Exception as e:  # noqa: BLE001 — collected
                errs.append(e)

        threads = [threading.Thread(target=caller, args=(s,)) for s in (3, 4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert len(errs) == 1 and isinstance(errs[0], IntegrityError)
        assert "slot 1" in str(errs[0])
        assert len(outs) == 1 and outs[0].shape == (1, T + N)
    finally:
        sched._step = wrapped
        sched.close(timeout=5.0)


def test_real_step_guard_fails_the_nan_slot_alone_through_fetch_hook():
    cfg = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=48)
    jparams = jt.init_transformer(jax.random.key(2), jt.TransformerConfig(**cfg))
    params = transformer_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    T, N = 8, 16
    prompts = np.random.default_rng(2).integers(0, 64, (3, T)).astype(np.int32)
    sched = ContinuousScheduler(params, TransformerConfig(**cfg), slots=3, prompt_len=T,
                                max_new_tokens=N, device="cpu")
    try:
        want = [sched.submit(prompts[i:i + 1])[0] for i in range(3)]
        victim = prompts[1].tobytes()
        hit = []

        def poison(_toks):
            for s, occ in enumerate(sched._occupant):
                if (not hit and occ is not None and sched._active[s] and len(occ["tokens"]) >= 2
                        and occ["item"]["x"][occ["row"]].tobytes() == victim):
                    sched._cache["k"][0, s, 0].fill_(float("nan"))
                    hit.append(s)

        sched.fetch_hook = poison
        got = [None] * 3

        def caller(i):
            try:
                got[i] = sched.submit(prompts[i:i + 1])[0]
            except Exception as e:  # noqa: BLE001 — collected
                got[i] = e

        threads = [threading.Thread(target=caller, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert hit and isinstance(got[1], IntegrityError) and "non-finite" in str(got[1])
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])
        # The slot serves its next occupant cleanly.
        sched.fetch_hook = None
        np.testing.assert_array_equal(sched.submit(prompts[1:2])[0], want[1])
    finally:
        sched.close()
