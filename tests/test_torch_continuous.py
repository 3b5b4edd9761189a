"""The port's continuous decode scheduler against the JAX package's, on
the CPU.

Mirrors ``tests/test_continuous.py`` with its small config (vocab 64,
d 32, 4 heads, 3 layers, ``max_seq_len`` 48, prompts of 8, 10 new
tokens); the port gets the JAX weights through
``transformer_params_from_jax`` and the same numpy-made prompts. Greedy
tokens are held EQUAL to JAX's ``ContinuousScheduler`` and JAX's
``generate``; prefix-cache, chunked-prefill and preempted runs
bit-equal to the port's plain runs; refusals carry JAX's texts; the
admission, close, shed and prefix-pool lifecycles run on the
cost-model scheduler (injected ``prefill_fn`` / ``step_fn``, no device
work), as JAX's do.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from tpu_dist_nn.models import generate as jg
from tpu_dist_nn.models import transformer as jt
from tpu_dist_nn.serving import continuous as jc
from tpu_dist_nn_torch.models.generate import generate
from tpu_dist_nn_torch.models.transformer import TransformerConfig, transformer_params_from_jax
from tpu_dist_nn_torch.serving.continuous import ContinuousScheduler, PrefixCachePool
from tpu_dist_nn_torch.utils.errors import (
    InternalError,
    ResourceExhaustedError,
    UnavailableError,
)

torch.set_num_threads(1)
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=3, d_ff=64, max_seq_len=48)
JCFG, PCFG = jt.TransformerConfig(**CFG), TransformerConfig(**CFG)
JPARAMS = jt.init_transformer(jax.random.key(11), JCFG)
PARAMS = transformer_params_from_jax(jax.tree.map(np.asarray, JPARAMS), device="cpu")
T, N = 8, 10


def _prompts(n, seed=0):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], (n, T)).astype(np.int32)


def _shared_prefix_prompts(n, header_len, seed=20):
    rng = np.random.default_rng(seed)
    header = rng.integers(0, CFG["vocab_size"], header_len)
    return np.stack([
        np.concatenate([header, rng.integers(0, CFG["vocab_size"], T - header_len)])
        for _ in range(n)
    ]).astype(np.int32)


def _jax_generate(prompts, n=N, **kw):
    return np.asarray(jg.generate(JPARAMS, JCFG, prompts, n, **kw))


def _sched(**kw):
    kw.setdefault("slots", 4)
    kw.setdefault("prompt_len", T)
    kw.setdefault("max_new_tokens", N)
    return ContinuousScheduler(PARAMS, PCFG, device="cpu", **kw)


def _jax_sched(**kw):
    kw.setdefault("slots", 4)
    kw.setdefault("prompt_len", T)
    kw.setdefault("max_new_tokens", N)
    return jc.ContinuousScheduler(JPARAMS, JCFG, **kw)


def _fake_sched(step_cost=0.0, chunk_cost=0.0, **kw):
    """The cost-model scheduler of the JAX tests (no device work)."""

    def fake_prefill(params, cache, slot, tokens, start, key):
        if chunk_cost:
            time.sleep(chunk_cost * tokens.shape[1])
        return np.int32(1), cache

    def fake_step(params, cache, pos, active, tok, key):
        if step_cost:
            time.sleep(step_cost)
        return np.asarray(tok) + 1, cache

    kw.setdefault("slots", 2)
    kw.setdefault("prompt_len", T)
    kw.setdefault("max_new_tokens", N)
    return ContinuousScheduler(None, None, prefill_fn=fake_prefill, step_fn=fake_step, **kw)


def _error_text(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    return str(ei.value)


# ------------------------------------------------------------ parity


def test_greedy_tokens_equal_jax_scheduler_and_jax_generate():
    # More rows than slots (queueing and slot reuse on the path), eos
    # early retirement and pads, one multi-row submit and concurrent
    # single rows: every row equals JAX's generate and JAX's scheduler.
    prompts = _prompts(6, seed=1)
    eos = int(_jax_generate(prompts)[0, N // 2])
    want = np.concatenate([prompts, _jax_generate(prompts, eos_id=eos)], axis=1)
    js = _jax_sched(slots=4, eos_id=eos)
    sched = _sched(slots=4, eos_id=eos)
    try:
        np.testing.assert_array_equal(js.submit(prompts), want)
        np.testing.assert_array_equal(sched.submit(prompts), want)
        outs = [None] * 6

        def call(i):
            outs[i] = sched.submit(prompts[i:i + 1])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for i in range(6):
            np.testing.assert_array_equal(outs[i][0], want[i])
        assert sched.retired_total == 12 and sched.rows_total == 12
    finally:
        js.close()
        sched.close()


def test_greedy_tokens_equal_the_port_generate():
    prompts = _prompts(5, seed=30)
    want = generate(PARAMS, PCFG, prompts, N).numpy()
    sched = _sched(slots=2)
    try:
        np.testing.assert_array_equal(sched.submit(prompts)[:, T:], want)
    finally:
        sched.close()


def test_slot_reuse_does_not_leak_stale_kv():
    prompts = _prompts(3, seed=2)
    sched = _sched(slots=1)
    try:
        for i in range(3):
            out = sched.submit(prompts[i:i + 1])
            np.testing.assert_array_equal(out[0, T:], _jax_generate(prompts[i:i + 1])[0])
    finally:
        sched.close()


def test_per_request_budget_caps_and_pads_like_jax():
    prompts = _prompts(2, seed=3)
    js = _jax_sched(slots=2)
    sched = _sched(slots=2)
    try:
        out = sched.submit(prompts, max_new_tokens=3)
        np.testing.assert_array_equal(out, js.submit(prompts, max_new_tokens=3))
        np.testing.assert_array_equal(out[:, T:T + 3], _jax_generate(prompts)[:, :3])
        assert (out[:, T + 3:] == 0).all()
        with pytest.raises(ValueError, match="max_new_tokens"):
            sched.submit(prompts, max_new_tokens=N + 1)
        with pytest.raises(ValueError, match="shape"):
            sched.submit(np.zeros((1, T + 2), np.int32))
    finally:
        js.close()
        sched.close()


def test_zero_row_submit_returns_empty_without_touching_the_loop():
    sched = _sched(slots=2)
    try:
        out = sched.submit(np.zeros((0, T), np.int32))
        assert out.shape == (0, T + N)
        assert sched.pending_rows == 0 and sched.requests_total == 0
        np.testing.assert_array_equal(sched.submit(_prompts(1, seed=12))[0, T:],
                                      _jax_generate(_prompts(1, seed=12))[0])
    finally:
        sched.close()


def test_sampled_generation_fresh_and_in_vocab():
    prompts = np.full((2, T), 5, np.int32)
    sched = _sched(slots=2, temperature=1.0, seed=3)
    again = _sched(slots=2, temperature=1.0, seed=3)
    try:
        a = sched.submit(prompts)
        b = sched.submit(prompts)
        assert not np.array_equal(a, b)
        assert (a[:, T:] >= 0).all() and (a[:, T:] < CFG["vocab_size"]).all()
        # The scheduler's generator is seeded: a new scheduler repeats.
        np.testing.assert_array_equal(again.submit(prompts), a)
    finally:
        sched.close()
        again.close()


@pytest.mark.parametrize("kw", [
    dict(slots=0), dict(max_new_tokens=48), dict(temperature=0.0, top_k=5), dict(eos_id=64),
    dict(prefill_chunk=0), dict(prefix_cache_blocks=-1),
    dict(prefix_cache_blocks=1, prefill_chunk=T),
], ids=["slots", "max_seq_len", "top_k", "eos_id", "prefill_chunk", "blocks", "no-tier"])
def test_construction_refusals_carry_jax_texts(kw):
    assert _error_text(lambda: _sched(**kw)) == _error_text(lambda: _jax_sched(**kw))


def test_injection_seam_refusals_carry_jax_texts():
    def seams(mod, params, cfg, **kw):
        return lambda: mod(params, cfg, slots=1, prompt_len=T, max_new_tokens=N, **kw)

    half = dict(prefill_fn=lambda *a: None)
    copy = dict(copy_fn=lambda cache, src, dst: cache)
    assert (_error_text(seams(ContinuousScheduler, None, None, **half))
            == _error_text(seams(jc.ContinuousScheduler, None, None, **half)))
    assert "together" in _error_text(seams(ContinuousScheduler, None, None, **half))
    assert (_error_text(seams(ContinuousScheduler, PARAMS, PCFG, device="cpu", **copy))
            == _error_text(seams(jc.ContinuousScheduler, JPARAMS, JCFG, **copy)))


def test_warm_runs_what_jax_warms_on_the_loop_thread():
    for kw in ({}, dict(prefix_cache_blocks=2, prefill_chunk=3)):
        sched, js = _sched(slots=2, **kw), _jax_sched(slots=2, **kw)
        seen = []
        real = sched._prefill

        def spy(*a, real=real):
            seen.append(threading.current_thread().name)
            return real(*a)

        sched._prefill = spy
        try:
            assert sched.warm() == js.warm()
            assert sched._chunk_lengths() == js._chunk_lengths()
            assert set(seen) == {"tdn-gen-continuous"}
            np.testing.assert_array_equal(sched.submit(_prompts(2, seed=31))[:, T:],
                                          _jax_generate(_prompts(2, seed=31)))
        finally:
            sched.close()
            js.close()


# ------------------------------------------------------------ observability


def _total(name, label=None):
    from tpu_dist_nn_torch.obs.registry import REGISTRY

    m = REGISTRY.get(name)
    if m is None:
        return 0.0
    return float(sum(c.value for k, c in m.samples() if label is None or tuple(k) == (label,)))


def test_ttft_retirement_and_token_counters():
    tok0 = _total("tdn_gen_tokens_total")
    eos0 = _total("tdn_gen_requests_retired_total", "eos")
    prompts = _prompts(4, seed=4)
    eos = int(_jax_generate(prompts)[0, N // 2])
    sched = _sched(slots=2, eos_id=eos)
    try:
        out = sched.submit(prompts)
        assert len(sched.ttft_recent) == 4
        assert _total("tdn_gen_requests_retired_total", "eos") > eos0
        emitted = sum(int(np.argmax(r[T:] == eos)) + 1 if (r[T:] == eos).any() else N
                      for r in out)
        assert _total("tdn_gen_tokens_total") - tok0 == emitted
        assert sched.slot_steps_total <= sched.steps_total * sched.slots
        assert sched.steps_total == sched.batches_total > 0
    finally:
        sched.close()


def test_traced_request_records_prefill_and_decode_spans():
    from tpu_dist_nn_torch.obs.trace import TRACER

    span = TRACER.start("rpc.Generate")
    assert span.ctx.sampled
    sched = _sched(slots=1, prefill_chunk=3)
    try:
        sched.submit(_prompts(1, seed=24), ctx=span.ctx)
    finally:
        span.end()
        sched.close()
    mine = [s for s in TRACER.snapshot() if s.trace_id == span.ctx.trace_id]
    assert {"queue_wait", "prefill", "prefill.chunk", "decode.step", "decode"} <= {
        s.name for s in mine}
    assert sum(1 for s in mine if s.name == "prefill.chunk") == 3  # ceil(8 / 3)


# ------------------------------------------------------------ admission


def test_shed_at_watermark_and_oversized_admitted_when_empty():
    sched = _fake_sched(step_cost=0.05, slots=1, max_pending_rows=2)
    outs, errs = [], []

    def call(rows):
        try:
            outs.append(sched.submit(rows))
        except Exception as e:  # noqa: BLE001 — collected
            errs.append(e)

    try:
        t1 = threading.Thread(target=call, args=(_prompts(1, seed=6),))
        t1.start()
        deadline = time.monotonic() + 5
        while sched.rows_total < 1 and time.monotonic() < deadline:
            time.sleep(0.001)
        t2 = threading.Thread(target=call, args=(_prompts(3, seed=7),))
        t2.start()
        deadline = time.monotonic() + 5
        while sched.pending_rows < 3 and time.monotonic() < deadline:
            time.sleep(0.001)
        with pytest.raises(ResourceExhaustedError, match="watermark"):
            sched.submit(_prompts(1, seed=8))
        assert sched.shed_total == 1
        t1.join(30)
        t2.join(30)
        assert len(outs) == 2 and not errs
    finally:
        sched.close()


def test_close_fails_pending_over_and_post_close_submit_raises():
    sched = _fake_sched(step_cost=0.05, slots=1)
    errs, oks = [], []

    def caller(i):
        try:
            oks.append(sched.submit(_prompts(1, seed=i)))
        except Exception as e:  # noqa: BLE001 — collected
            errs.append(e)

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.08)
    sched.close()
    for t in threads:
        t.join(20)
    assert len(oks) >= 1 and len(errs) >= 1
    assert all(isinstance(e, UnavailableError) for e in errs)
    with pytest.raises(UnavailableError):
        sched.submit(_prompts(1, seed=9))
    assert not sched._thread.is_alive() and sched.join(0.0)


def test_drain_with_half_prefilled_slot_completes():
    sched = _fake_sched(chunk_cost=0.03, slots=1, prefill_chunk=2)
    outs, errs = [], []

    def caller():
        try:
            outs.append(sched.submit(_prompts(1, seed=26)))
        except Exception as e:  # noqa: BLE001 — collected
            errs.append(e)

    t = threading.Thread(target=caller)
    t.start()
    deadline = time.monotonic() + 5
    while sched.inflight_rows < 1 and time.monotonic() < deadline:
        time.sleep(0.002)
    assert sched.inflight_rows == 1
    sched.close(timeout=30.0)
    t.join(30)
    assert not errs and len(outs) == 1 and outs[0].shape == (1, T + N)
    assert sched.retired_total == 1


def test_mid_prefill_fault_frees_slot_and_releases_ref():
    # T=8, chunk=3: request 1 runs chunks 1-3 (tiers 3 and 6); request 2
    # hits tier 6 and its one suffix chunk is call 4, which faults: it
    # alone fails, its slot frees and its block reference is released.
    sched = _fake_sched(slots=1, prefix_cache_blocks=2, prefill_chunk=3)
    calls = [0]

    def hook(tokens):
        calls[0] += 1
        if calls[0] == 4:
            raise InternalError("injected prefill fault")

    sched.prefill_hook = hook
    p = _prompts(1, seed=25)
    try:
        sched.submit(p)
        assert sched.prefix_blocks_used == 2
        with pytest.raises(InternalError):
            sched.submit(p)
        assert sched.prefix_hits_total == 1 and sched.inflight_rows == 0
        assert all(sched._pool.refs(b) == 0 for b in range(sched.prefix_blocks))
        assert sched.submit(p).shape == (1, T + N)
        assert sched.prefix_hits_total == 2
    finally:
        sched.close()


# ------------------------------------------------ prefix cache + chunking


def test_prefix_cache_and_chunks_bit_equal_to_plain_including_eos():
    prompts = _shared_prefix_prompts(6, header_len=4)
    eos = int(_jax_generate(prompts)[0, N // 2])
    want = _jax_generate(prompts, eos_id=eos)
    off = _sched(slots=2, eos_id=eos)
    on = _sched(slots=2, eos_id=eos, prefix_cache_blocks=3, prefill_chunk=4)
    try:
        out_off = off.submit(prompts)
        rows_on = np.stack([on.submit(prompts[i:i + 1])[0] for i in range(6)])
        np.testing.assert_array_equal(rows_on, out_off)
        np.testing.assert_array_equal(out_off[:, T:], want)
        assert on.prefix_hits_total >= 4 and on.prefix_misses_total >= 1
        assert off.prefix_hits_total == 0 and off.prefix_blocks == 0
    finally:
        off.close()
        on.close()


@pytest.mark.parametrize("chunk", [1, 3, T, T + 5])
def test_chunked_prefill_bit_equal_to_monolithic(chunk):
    prompts = _prompts(3, seed=21)
    mono, chunked = _sched(slots=2), _sched(slots=2, prefill_chunk=chunk)
    try:
        out = chunked.submit(prompts)
        np.testing.assert_array_equal(out, mono.submit(prompts))
        np.testing.assert_array_equal(out[:, T:], _jax_generate(prompts))
    finally:
        mono.close()
        chunked.close()


def test_cow_isolation_decode_never_mutates_shared_block():
    prompts = _shared_prefix_prompts(3, header_len=6, seed=22)
    prompts[1:] = prompts[0]  # identical prompts: deepest-tier hits
    ref = _jax_generate(prompts[:1])
    sched = _sched(slots=1, prefix_cache_blocks=1, prefill_chunk=4)
    try:
        np.testing.assert_array_equal(sched.submit(prompts[0:1])[0, T:], ref[0])
        assert sched.prefix_blocks_used == 1
        block = sched.slots  # pool block 0 lives at slot index S
        k_before = sched._cache["k"][:, block].clone()
        v_before = sched._cache["v"][:, block].clone()
        np.testing.assert_array_equal(sched.submit(prompts[1:2])[0, T:], ref[0])
        assert sched.prefix_hits_total == 1
        assert torch.equal(sched._cache["k"][:, block], k_before)
        assert torch.equal(sched._cache["v"][:, block], v_before)
        np.testing.assert_array_equal(sched.submit(prompts[2:3])[0, T:], ref[0])
    finally:
        sched.close()


def test_prefix_pool_lifecycle_equals_jax_pool():
    # One sequence of operations on both pools: every result, refcount,
    # counter and raise equal (the JAX test's lifecycle).
    ops = [("insert", b"aa", 4), ("lookup", [(4, b"aa")]), ("insert", b"bb", 4),
           ("insert", b"cc", 4), ("lookup", [(4, b"bb")]), ("release", 0),
           ("insert", b"dd", 4), ("release", 0), ("lookup", [(4, b"cc")]),
           ("lookup", [(4, b"dd")]), ("insert", b"ee", 4), ("clear",), ("release", 1),
           ("release", 0), ("clear",), ("lookup", [(8, b"zz"), (4, b"aa")])]
    pools = PrefixCachePool(2), jc.PrefixCachePool(2)

    def run(pool, op):
        try:
            r = getattr(pool, op[0])(*op[1:])
        except AssertionError as e:
            r = f"raised {e}"
        return (r, [pool.refs(b) for b in range(2)], pool.used, pool.hits_total,
                pool.misses_total, pool.evictions_total)

    for op in ops:
        assert run(pools[0], op) == run(pools[1], op), op
    assert pools[0].hits_total == 3 and pools[0].used == 0
    with pytest.raises(ValueError, match="block"):
        PrefixCachePool(0)


def test_prefix_counters_on_the_cost_model():
    hits0, miss0 = _total("tdn_prefix_cache_hits_total"), _total("tdn_prefix_cache_misses_total")
    sched = _fake_sched(slots=1, prefix_cache_blocks=1, prefill_chunk=4)
    try:
        p = _prompts(1, seed=23)
        sched.submit(p)  # miss + tier insert
        sched.submit(p)  # deepest-tier hit
        assert sched.prefix_misses_total == 1 and sched.prefix_hits_total == 1
        assert sched.prefix_blocks_used == 1 and 0.0 < sched.prefix_hit_ratio < 1.0
        assert _total("tdn_prefix_cache_hits_total") == hits0 + 1
        assert _total("tdn_prefix_cache_misses_total") == miss0 + 1
    finally:
        sched.close()


# ------------------------------------------------------------ preemption


def _preempt_run(sched, victim_prompt, crit_prompt, victim_tokens=2):
    """Submit the victim (best_effort), hold the loop once it decodes
    with ``victim_tokens`` tokens, queue the critical row, release:
    returns both outputs."""
    outs = {}
    full, release = threading.Event(), threading.Event()

    def hold(_tok):
        occ = sched._occupant[0]
        if (not full.is_set() and occ is not None and sched._active[0]
                and victim_tokens <= len(occ["tokens"]) < N):
            full.set()
            release.wait(30.0)

    def submit(name, prompt, cls):
        outs[name] = sched.submit(prompt, slo_class=cls, timeout=60.0)

    sched.launch_hook = hold
    tv = threading.Thread(target=submit, args=("victim", victim_prompt, "best_effort"))
    tv.start()
    assert full.wait(30.0)
    tc = threading.Thread(target=submit, args=("crit", crit_prompt, "critical"))
    tc.start()
    deadline = time.monotonic() + 30.0
    while sched.pending_rows < 1 and time.monotonic() < deadline:
        time.sleep(0.0005)
    release.set()
    tc.join(60)
    tv.join(60)
    sched.launch_hook = None
    return outs


@pytest.mark.parametrize("victim_tokens", [2, 6])
def test_preempted_greedy_bit_equal_to_the_unpreempted_generate(victim_tokens):
    # Held to the UNPREEMPTED generate output (the port's and JAX's):
    # re-prefill + forced-token replay recomputes the original K/V.
    rng = np.random.default_rng(5)
    victim_prompt = rng.integers(0, CFG["vocab_size"], (1, T)).astype(np.int32)
    crit_prompt = rng.integers(0, CFG["vocab_size"], (1, T)).astype(np.int32)
    sched = _sched(slots=1)
    try:
        outs = _preempt_run(sched, victim_prompt, crit_prompt, victim_tokens)
        assert sched.preempted_total == 1
        np.testing.assert_array_equal(outs["victim"][0, T:],
                                      generate(PARAMS, PCFG, victim_prompt, N).numpy()[0])
        np.testing.assert_array_equal(outs["victim"][0, T:], _jax_generate(victim_prompt)[0])
        np.testing.assert_array_equal(outs["crit"][0, T:], _jax_generate(crit_prompt)[0])
    finally:
        sched.close()


def test_preempted_stream_delivers_each_token_once():
    rng = np.random.default_rng(6)
    victim_prompt = rng.integers(0, CFG["vocab_size"], (1, T)).astype(np.int32)
    crit_prompt = rng.integers(0, CFG["vocab_size"], (1, T)).astype(np.int32)
    sched = _sched(slots=1)
    try:
        full, release = threading.Event(), threading.Event()

        def hold(_tok):
            occ = sched._occupant[0]
            if not full.is_set() and occ is not None and len(occ["tokens"]) >= 3:
                full.set()
                release.wait(30.0)

        sched.launch_hook = hold
        stream = sched.submit_stream(victim_prompt, slo_class="best_effort")
        assert full.wait(30.0)
        crit = threading.Thread(target=sched.submit, args=(crit_prompt,),
                                kwargs=dict(slo_class="critical"))
        crit.start()
        deadline = time.monotonic() + 30.0
        while sched.pending_rows < 1 and time.monotonic() < deadline:
            time.sleep(0.0005)
        release.set()
        toks, end = [], None
        while end is None:
            kind, data = stream.next_event(30.0)
            toks.extend(data) if kind == "tokens" else None
            end = data if kind == "end" else None
        crit.join(30)
        assert sched.preempted_total == 1
        assert toks == _jax_generate(victim_prompt)[0].tolist()
        assert end["reason"] == "max_tokens"
    finally:
        sched.close()


def test_preemption_never_evicts_critical_for_critical():
    sched = _fake_sched(step_cost=0.01, slots=1)
    outs = []

    def submit(cls):
        outs.append(sched.submit(np.zeros((1, T), np.int32), slo_class=cls, timeout=30.0))

    try:
        t1 = threading.Thread(target=submit, args=("critical",))
        t1.start()
        deadline = time.monotonic() + 5.0
        while sched._occupant[0] is None and time.monotonic() < deadline:
            time.sleep(0.001)
        t2 = threading.Thread(target=submit, args=("critical",))
        t2.start()
        t1.join(30)
        t2.join(30)
        assert sched.preempted_total == 0 and len(outs) == 2
    finally:
        sched.close()


def test_device_fault_fails_residents_and_keeps_serving():
    sched = _sched(slots=2, prefix_cache_blocks=1, prefill_chunk=4)
    real = sched._step
    calls = [0]

    def broken(*a):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("step raised")
        return real(*a)

    sched._step = broken
    try:
        with pytest.raises(RuntimeError, match="step raised"):
            sched.submit(_prompts(2, seed=40))
        # The waiters wake at the fan-out; the loop then zeroes the cache
        # and drops the pool.
        deadline = time.monotonic() + 10.0
        while sched.prefix_blocks_used and time.monotonic() < deadline:
            time.sleep(0.001)
        assert sched.inflight_rows == 0 and sched.prefix_blocks_used == 0
        assert all(float(v.abs().sum()) == 0.0 for v in sched._cache.values())
        np.testing.assert_array_equal(sched.submit(_prompts(2, seed=41))[:, T:],
                                      _jax_generate(_prompts(2, seed=41)))
    finally:
        sched._step = real
        sched.close()
