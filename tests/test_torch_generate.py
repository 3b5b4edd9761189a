"""The port's LM generation against the JAX package, on the CPU.

Mirrors the single-chip tests of ``tests/test_generate.py`` with JAX's
small config (vocab 64, d 32, 4 heads, 3 layers, ``max_seq_len`` 48);
the port gets the JAX weights through ``transformer_params_from_jax``
and the same numpy-made prompts. Tolerances are JAX's: prefill and
decode logits within rtol/atol 2e-5 of the JAX functions and of the
full forward; greedy tokens equal to JAX's ``generate`` and to the
teacher-forced argmax; ``_truncate_logits`` equal to JAX's on the same
float32 logits; ``decode_step_slots`` at uniform positions and the chunk
prefill (whole, and split 3 + 5) bit-equal to their single-path twins.
Sampled tokens cannot match JAX's PRNG: they are held to their
properties (a seed repeats, another seed differs, ``top_k=1`` is greedy,
every draw lies in the truncated set, the sampler's frequencies follow
the truncated softmax) and eos rows freeze exactly as JAX's do.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist_nn.models import generate as jg
from tpu_dist_nn.models import transformer as jt
from tpu_dist_nn_torch.models.generate import (
    _sample,
    _truncate_logits,
    copy_cache_slot,
    decode_step,
    decode_step_slots,
    generate,
    init_slot_cache,
    prefill,
    prefill_chunk_into_cache,
    prefill_into_cache,
)
from tpu_dist_nn_torch.models.transformer import (
    TransformerConfig,
    forward,
    transformer_params_from_jax,
)

torch.set_num_threads(1)
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=3, d_ff=64, max_seq_len=48)
TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_generate.py's
JCFG, PCFG = jt.TransformerConfig(**CFG), TransformerConfig(**CFG)


def _both(seed=0):
    jparams = jt.init_transformer(jax.random.key(seed), JCFG)
    return jparams, transformer_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _prompt(batch, t, seed=0):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], (batch, t)).astype(np.int32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _jax_generate(jparams, prompt, n, **kw):
    return np.asarray(jg.generate(jparams, JCFG, jnp.asarray(prompt), n, **kw))


def _gumbel(shape, seed):
    u = torch.rand(shape, generator=_gen(seed)).clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _teacher_forced(params, seq, cfg=PCFG):
    return forward(params, torch.as_tensor(seq).long(), cfg).numpy()


def test_prefill_logits_match_forward_and_jax():
    jparams, params = _both(0)
    tokens = _prompt(2, 12)
    logits, cache = prefill(params, tokens, PCFG, max_len=20)
    np.testing.assert_allclose(logits.numpy(), _teacher_forced(params, tokens), **TOL)
    jlogits, jcache = jg.prefill(jparams, jnp.asarray(tokens), JCFG, max_len=20)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert cache["k"].shape == (3, 2, 20, 4, 8)
    for part in ("k", "v"):
        np.testing.assert_allclose(cache[part].numpy(), np.asarray(jcache[part]), **TOL)
        assert not cache[part][:, :, 12:].any()  # zero-padded to max_len
    with pytest.raises(ValueError, match="prompt length 12 exceeds cache length 10"):
        prefill(params, tokens, PCFG, max_len=10)


def test_greedy_generation_matches_jax_and_the_teacher_forced_oracle():
    jparams, params = _both(1)
    prompt = _prompt(2, 8, seed=2)
    got = generate(params, PCFG, prompt, 10).numpy()
    np.testing.assert_array_equal(got, _jax_generate(jparams, prompt, 10))
    seq = prompt.astype(np.int64)
    for i in range(10):
        nxt = _teacher_forced(params, seq)[:, -1].argmax(-1)
        np.testing.assert_array_equal(got[:, i], nxt)
        seq = np.concatenate([seq, nxt[:, None]], axis=1)


def test_decode_step_matches_jax_and_writes_only_its_position():
    jparams, params = _both(0)
    tokens = _prompt(1, 4)
    _, cache = prefill(params, tokens, PCFG, max_len=10)
    before = {k: v.clone() for k, v in cache.items()}
    assert not cache["k"][:, :, 4].any()  # position 4 still empty
    logits, cache = decode_step(params, cache, torch.tensor(4), tokens[:, 0], PCFG)
    _, jcache = jg.prefill(jparams, jnp.asarray(tokens), JCFG, max_len=10)
    jlogits, jcache = jg.decode_step(jparams, jcache, jnp.int32(4), jnp.asarray(tokens[:, 0]), JCFG)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), **TOL)
    assert cache["k"][:, :, 4].any()  # now written
    for part in ("k", "v"):  # every other position untouched
        keep = torch.ones(10, dtype=torch.bool)
        keep[4] = False
        assert torch.equal(cache[part][:, :, keep], before[part][:, :, keep])


def test_sampling_repeats_with_the_seed_and_varies_with_it():
    _, params = _both(3)
    prompt = _prompt(2, 6, seed=4)
    a, b, c = (generate(params, PCFG, prompt, 8, temperature=1.0, generator=_gen(s)).numpy()
               for s in (7, 7, 8))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < CFG["vocab_size"]


def test_generate_boundary_total_fits_positional_table():
    jparams, params = _both(0)
    n = CFG["max_seq_len"] + 1 - 40
    out = generate(params, PCFG, _prompt(1, 40), n).numpy()
    np.testing.assert_array_equal(out, _jax_generate(jparams, _prompt(1, 40), n))


@pytest.mark.parametrize("t,n,kw", [
    (40, 20, {}),
    (4, 4, dict(temperature=0.5)),
    (4, 4, dict(temperature=-0.5)),
    (4, 0, {}),
    (4, 4, dict(noncausal=True)),
    (1, 2, dict(temperature=1.0, top_k=0, key=True)),
    (1, 2, dict(temperature=1.0, top_p=1.5, key=True)),
    (1, 2, dict(temperature=0.0, top_k=5)),
    (4, 4, dict(eos_id=64)),
    (4, 4, dict(eos_id=-1)),
], ids=["max-seq-len", "prng-key", "temperature", "max-new-tokens", "causal", "top-k",
        "top-p", "greedy", "eos-high", "eos-negative"])
def test_generate_refuses_what_jax_refuses_with_its_text(t, n, kw):
    kw = dict(kw)
    key = kw.pop("key", False)
    jcfg, pcfg = JCFG, PCFG
    if kw.pop("noncausal", False):
        jcfg, pcfg = (dataclasses.replace(c, causal=False) for c in (JCFG, PCFG))
    jparams, params = _both(0)
    prompt = _prompt(1, t)
    with pytest.raises(ValueError) as jerr:
        jg.generate(jparams, jcfg, jnp.asarray(prompt), n,
                    key=jax.random.key(0) if key else None, **kw)
    with pytest.raises(ValueError) as err:
        generate(params, pcfg, prompt, n, generator=_gen(0) if key else None, **kw)
    assert str(err.value).startswith(str(jerr.value))


def test_generate_single_token():
    jparams, params = _both(1)
    prompt = _prompt(2, 8, seed=2)
    got = generate(params, PCFG, prompt, 1).numpy()
    assert got.shape == (2, 1)
    np.testing.assert_array_equal(got[:, 0], _teacher_forced(params, prompt)[:, -1].argmax(-1))
    np.testing.assert_array_equal(got, _jax_generate(jparams, prompt, 1))


@pytest.mark.parametrize("top_k,top_p",
                         [(2, None), (None, 0.85), (5, 0.6), (None, 1.0), (64, None)],
                         ids=["k2", "p0.85", "k5-p0.6", "p1", "k-all"])
def test_truncate_logits_equals_jax(top_k, top_p):
    logits = np.random.default_rng(5).normal(0, 2, (6, 64)).astype(np.float32)
    got = _truncate_logits(torch.from_numpy(logits), top_k, top_p).numpy()
    want = jg._truncate_logits(jnp.asarray(logits), top_k, top_p)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_truncate_logits_examples():
    neg = np.finfo(np.float32).min
    out = _truncate_logits(torch.tensor([[1.0, 5.0, 3.0, 4.0, 2.0]]), 2, None).numpy()
    np.testing.assert_array_equal(out[0] > neg, [False, True, False, True, False])
    logits = torch.log(torch.tensor([[1.0, 4.0, 5.0, 1e-3]]))
    out = _truncate_logits(logits, None, 0.85).numpy()
    np.testing.assert_array_equal(out[0] > neg, [False, True, True, False])
    assert (_truncate_logits(logits, None, 1.0).numpy()[0] > neg).all()


def test_top_k_one_is_greedy():
    _, params = _both(0)
    prompt = np.array([[1, 2, 3]], np.int32)
    greedy = generate(params, PCFG, prompt, 8).numpy()
    topk1 = generate(params, PCFG, prompt, 8, temperature=1.0, top_k=1, generator=_gen(7)).numpy()
    np.testing.assert_array_equal(greedy, topk1)


@pytest.mark.parametrize("kw", [dict(top_k=2), dict(top_p=0.5), dict(top_k=4, top_p=0.7)],
                         ids=["k2", "p0.5", "k4-p0.7"])
def test_every_draw_lies_in_the_truncated_set(kw):
    _, params = _both(0)
    prompt = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    out = generate(params, PCFG, prompt, 8, temperature=4.0, generator=_gen(3), **kw).numpy()
    logits = _teacher_forced(params, np.concatenate([prompt, out], axis=1))
    for i in range(out.shape[1]):
        allowed = _truncate_logits(torch.from_numpy(logits[:, 2 + i]), kw.get("top_k"),
                                   kw.get("top_p")).numpy() > np.finfo(np.float32).min
        assert allowed[np.arange(2), out[:, i]].all(), i


def test_sampler_frequencies_follow_the_truncated_softmax():
    # 40,000 Gumbel-max draws from one generator on fixed logits: each
    # token's frequency within 5 binomial standard deviations (plus 1e-3)
    # of softmax(truncated logits / T); tokens outside the set never drawn.
    n, temperature = 40_000, 0.8
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0, -4.0])
    draws = _sample(logits.expand(n, 8), _gumbel((n, 8), 11), temperature, 5, 0.95)
    want = torch.softmax(_truncate_logits(logits[None], 5, 0.95)[0] / temperature, -1).numpy()
    freq = np.bincount(draws.numpy(), minlength=8) / n
    bound = 5 * np.sqrt(want * (1 - want) / n) + 1e-3
    assert (np.abs(freq - want) <= bound).all(), (freq, want)
    assert (freq[want == 0] == 0).all()


def test_generate_eos_freezes_rows_like_jax():
    jparams, params = _both(1)
    prompt = _prompt(2, 8, seed=2)
    base = generate(params, PCFG, prompt, 10).numpy()
    eos = int(base[0, 3])
    out = generate(params, PCFG, prompt, 10, eos_id=eos).numpy()
    np.testing.assert_array_equal(out, _jax_generate(jparams, prompt, 10, eos_id=eos))
    np.testing.assert_array_equal(out[0, :4], base[0, :4])
    assert (out[0, 4:] == eos).all()
    first = np.flatnonzero(base[1] == eos)
    if first.size == 0:
        np.testing.assert_array_equal(out[1], base[1])
    else:
        np.testing.assert_array_equal(out[1, :first[0] + 1], base[1, :first[0] + 1])
        assert (out[1, first[0]:] == eos).all()


def test_generate_is_the_plain_step_loop():
    # The cached program (static buffers; a CUDA graph on a card) against
    # prefill + decode_step + the sampler in a Python loop, with the same
    # noise: equal tokens, greedy and sampled, on a repeat of the program.
    _, params = _both(2)
    prompt = _prompt(3, 5, seed=1)
    for kw in (dict(), dict(temperature=0.7, top_k=10, top_p=0.9, eos_id=9)):
        t = kw.get("temperature", 0.0)
        noise = _gumbel((6, 3, 64), 4)
        logits, cache = prefill(params, prompt, PCFG, max_len=5 + 6 - 1)
        tok = _sample(logits[:, -1], noise[0], t, kw.get("top_k"), kw.get("top_p"))
        done = torch.zeros(3, dtype=torch.bool)
        want = []
        for i in range(6):
            if "eos_id" in kw:
                tok = torch.where(done, kw["eos_id"], tok)
                done |= tok == kw["eos_id"]
            want.append(tok)
            if i < 5:
                logits, cache = decode_step(params, cache, 5 + i, tok, PCFG)
                tok = _sample(logits, noise[i + 1], t, kw.get("top_k"), kw.get("top_p"))
        for _ in range(2):
            got = generate(params, PCFG, prompt, 6, generator=_gen(4), **kw)
            assert torch.equal(got, torch.stack(want, 1))


# ---------------------------------------------------------------------------
# The slot cache
# ---------------------------------------------------------------------------


def test_decode_step_slots_is_bit_equal_to_decode_step():
    _, params = _both(0)
    prompts = _prompt(4, 8, seed=3)
    _, cache = prefill(params, prompts, PCFG, max_len=13)
    ref_cache = {k: v.clone() for k, v in cache.items()}
    tok = torch.from_numpy(prompts[:, 0])
    ref_logits, ref_cache = decode_step(params, ref_cache, 8, tok, PCFG)
    got_logits, got_cache = decode_step_slots(params, cache, torch.full((4,), 8), tok, PCFG)
    assert torch.equal(ref_logits, got_logits)
    assert all(torch.equal(ref_cache[p], got_cache[p]) for p in ("k", "v"))


def test_decode_step_slots_staggered_positions_match_jax_and_the_oracle():
    jparams, params = _both(5)
    T, S = 6, 2
    prompts = _prompt(S, T, seed=6)
    cache = init_slot_cache(PCFG, S, 16, device="cpu")
    logits0, cache = prefill_into_cache(params, PCFG, cache, 0, prompts[:1])
    jlogits0, _ = jg.prefill_into_cache(jparams, JCFG, jg.init_slot_cache(JCFG, S, 16), 0,
                                        jnp.asarray(prompts[:1]))
    np.testing.assert_allclose(logits0.numpy(), np.asarray(jlogits0), **TOL)
    seq0 = list(prompts[0]) + [int(logits0[0].argmax())]
    pos = torch.tensor([T, 0])
    active = torch.tensor([True, False])
    for _ in range(3):  # slot 0 alone, slot 1 retired (and never written)
        logits, cache = decode_step_slots(params, cache, pos, torch.tensor([seq0[-1], 0]), PCFG,
                                          active=active)
        seq0.append(int(logits[0].argmax()))
        pos = pos + torch.tensor([1, 0])
    assert not cache["k"][:, 1].any() and not cache["v"][:, 1].any()
    logits1, cache = prefill_into_cache(params, PCFG, cache, 1, prompts[1:])
    seq1 = list(prompts[1]) + [int(logits1[0].argmax())]
    logits, cache = decode_step_slots(params, cache, torch.tensor([T + 3, T]),
                                      torch.tensor([seq0[-1], seq1[-1]]), PCFG)
    for s, seq in ((0, seq0), (1, seq1)):
        ref = _teacher_forced(params, np.array([seq]))[0, -1]
        np.testing.assert_allclose(logits[s].numpy(), ref, **TOL)
        jref = np.asarray(jt.forward(jparams, jnp.asarray([seq], jnp.int32), JCFG))[0, -1]
        np.testing.assert_allclose(logits[s].numpy(), jref, **TOL)


def test_prefill_into_cache_lands_its_slot_and_clears_stale():
    jparams, params = _both(0)
    prompts = _prompt(3, 8, seed=7)
    cache = init_slot_cache(PCFG, 3, 12, device="cpu")
    cache = {k: v + 7.5 for k, v in cache.items()}  # stale garbage
    before = {k: v.clone() for k, v in cache.items()}
    logits, cache = prefill_into_cache(params, PCFG, cache, torch.tensor(1), prompts[1:2])
    jcache = {k: v + 7.5 for k, v in jg.init_slot_cache(JCFG, 3, 12).items()}
    jlogits, jcache = jg.prefill_into_cache(jparams, JCFG, jcache, 1, jnp.asarray(prompts[1:2]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for part in ("k", "v"):
        np.testing.assert_allclose(cache[part][:, 1].numpy(), np.asarray(jcache[part][:, 1]), **TOL)
        assert not cache[part][:, 1, 8:].any()
        for s in (0, 2):
            assert torch.equal(cache[part][:, s], before[part][:, s])
    want = _jax_generate(jparams, prompts[1:2], 1)[0, 0]
    assert int(logits[0].argmax()) == want


def test_slot_cache_bounds_validated():
    with pytest.raises(ValueError, match="slots must be >= 1, got 0"):
        init_slot_cache(PCFG, 0, 8, device="cpu")
    with pytest.raises(ValueError, match=r"max_len must be in \[1, 48\], got 49"):
        init_slot_cache(PCFG, 2, CFG["max_seq_len"] + 1, device="cpu")
    assert init_slot_cache(PCFG, 2, 8, device="cpu")["k"].shape == (3, 2, 8, 4, 8)


def test_prefill_chunk_into_cache_is_bit_equal_to_the_monolithic_prefill():
    jparams, params = _both(0)
    T = 8
    prompts = _prompt(1, T, seed=8)
    cache0 = init_slot_cache(PCFG, 3, 12, device="cpu")
    ref_logits, ref = prefill_into_cache(params, PCFG, {k: v.clone() for k, v in cache0.items()},
                                         1, prompts)
    jlogits, _ = jg.prefill_chunk_into_cache(jparams, JCFG, jg.init_slot_cache(JCFG, 3, 12), 1,
                                             jnp.asarray(prompts), 0)
    np.testing.assert_allclose(ref_logits.numpy(), np.asarray(jlogits), **TOL)
    whole_logits, whole = prefill_chunk_into_cache(
        params, PCFG, {k: v.clone() for k, v in cache0.items()}, 1, prompts, 0)
    c = {k: v.clone() for k, v in cache0.items()}
    _, c = prefill_chunk_into_cache(params, PCFG, c, 1, prompts[:, :3], 0)
    split_logits, c = prefill_chunk_into_cache(params, PCFG, c, 1, prompts[:, 3:], torch.tensor(3))
    for logits, got in ((whole_logits, whole), (split_logits, c)):
        assert torch.equal(logits, ref_logits)
        for part in ("k", "v"):
            assert torch.equal(got[part], ref[part])


def test_copy_cache_slot_full_extent_and_isolation():
    _, params = _both(1)
    cache = {k: v + 2.5 for k, v in init_slot_cache(PCFG, 3, 12, device="cpu").items()}
    _, cache = prefill_chunk_into_cache(params, PCFG, cache, 2, _prompt(1, 8, seed=9), 0)
    before = {k: v.clone() for k, v in cache.items()}
    out = copy_cache_slot(cache, torch.tensor(2), 0)
    for part in ("k", "v"):
        assert torch.equal(out[part][:, 0], before[part][:, 2])
        assert torch.equal(out[part][:, 1:], before[part][:, 1:])


def test_prefill_chunk_after_copied_prefix_is_bit_equal_to_the_monolithic_prefill():
    _, params = _both(2)
    T, pool_slot, req_slot = 8, 2, 0
    prompts = _prompt(1, T, seed=10)
    cache0 = init_slot_cache(PCFG, 3, 12, device="cpu")
    ref_logits, ref = prefill_into_cache(params, PCFG, {k: v.clone() for k, v in cache0.items()},
                                         req_slot, prompts)
    _, c = prefill_chunk_into_cache(params, PCFG, cache0, pool_slot, prompts[:, :4], 0)
    c = copy_cache_slot(c, pool_slot, req_slot)
    logits, c = prefill_chunk_into_cache(params, PCFG, c, req_slot, prompts[:, 4:], 4)
    assert torch.equal(logits, ref_logits)
    for part in ("k", "v"):
        assert torch.equal(c[part][:, req_slot, :T], ref[part][:, req_slot, :T])
