"""The sm90 flash-attention route of the port, on the CPU.

The tensor-core kernels (``csrc/flash_attention_sm90.cu``) run only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``). Here:

(a) ``flash_bwd_plain``, the fused backward's plain version, against
    the JAX package's flash-attention VJP (its Pallas kernels in
    interpret mode, 16-row blocks, as ``tests/test_flash_attention.py``
    runs them) and against the two plain versions it is composed of;
(b) a blockwise torch emulation of the two kernels' schedule (128-row
    query tiles and 128-key tiles in the forward, 128-key blocks over
    64-row query tiles in the backward, each split between two 64-row
    warpgroups; the causal start and stop tiles; element masks only on
    the diagonal and ``seq_len`` tiles; exp2 with the scale folded in;
    dq summed per key block; P and dS rounded to bf16) against the plain
    versions, at T 1, 17, 127, 128, 129, 200 and 1000 with ``seq_len``
    < T. The tiles come from ``SM90_TILES``, the constant the wrappers
    pass to every launch;
(c) the routing by dtype as a pure function.

Tolerances: the float32 ones of ``tests/test_flash_attention.py`` (2e-5
forward, 2e-4 gradients) where nothing is rounded; where P and dS are
rounded to bf16, those plus ``bf16_rounding_bounds`` (each rounded term
moves by at most 2**-8 of its size).
"""

import functools
import math

import jax
import numpy as np
import pytest
import torch

from tpu_dist_nn.kernels.flash_attention import _flash_bwd as jax_flash_bwd
from tpu_dist_nn.kernels.flash_attention import _flash_fwd as jax_flash_fwd
from tpu_dist_nn.kernels.flash_attention import flash_attention as jax_flash
from tpu_dist_nn_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
from tpu_dist_nn_torch.kernels.flash_attention import (
    NEG_INF,
    SM90_HEAD_DIMS,
    SM90_TILES,
    _sm90_params,
    _tma_strides,
    bf16_rounding_bounds,
    flash_bwd,
    flash_bwd_dkv_plain,
    flash_bwd_dq_plain,
    flash_bwd_plain,
    flash_fwd,
    flash_fwd_plain,
    flash_route,
)
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

torch.set_num_threads(1)
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
LOG2E = math.log2(math.e)


def _bf16_inputs(B, T, H, Dh, seed):
    """q, k, v, dO: float32 tensors holding bf16 values, as the kernels
    read them."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, T, H, Dh)).astype(np.float32))
            .to(torch.bfloat16).float() for _ in range(4)]


def _within(got, want, bound, atol, rtol):
    """|got - want| <= atol + rtol |want| + bound, element by element."""
    excess = (got - want).abs() - (atol + rtol * want.abs() + bound)
    assert float(excess.max()) <= 0.0, f"over the tolerance by {float(excess.max()):.3e}"


# ---------------------------------------------------------------------------
# (a) the fused backward's plain version
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_vjp(causal):
    def fn(q, k, v, g):
        _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=causal, block_q=16,
                                                   block_k=16), q, k, v)
        return vjp(g)
    return jax.jit(fn)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_flash_bwd_plain_matches_jax_vjp_and_the_two_plain_versions(causal):
    B, T, H, Dh = 2, 40, 2, 16  # T 40: ragged for the JAX kernels' 16-row blocks
    q, k, v, g = _bf16_inputs(B, T, H, Dh, seed=11)
    want = _jax_vjp(causal)(*(t.numpy() for t in (q, k, v, g)))
    scale = 1.0 / math.sqrt(Dh)
    o, lse = flash_fwd_plain(q, k, v, scale=scale, causal=causal)
    delta = (g * o).sum(-1).transpose(1, 2).contiguous()
    got = flash_bwd_plain(q, k, v, g, lse, delta, scale=scale, causal=causal)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **GRAD_TOL)
    kw = dict(scale=scale, causal=causal)
    composed = (flash_bwd_dq_plain(q, k, v, g, lse, delta, **kw),
                *flash_bwd_dkv_plain(q, k, v, g, lse, delta, **kw))
    for a, b in zip(got, composed):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_flash_bwd_plain_matches_jax_kernels_with_seq_len(causal):
    # The JAX kernels on padded (BH, Tp, Dh) arrays with seq_len 40 of
    # Tp 48; the port's plain backward on (BH, Tp, 1, Dh) with seq_len 40.
    BH, Tp, T, Dh = 3, 48, 40, 16
    rng = np.random.default_rng(12)
    q, k, v, g = (rng.standard_normal((BH, Tp, Dh)).astype(np.float32) for _ in range(4))
    kw = dict(scale=1.0 / np.sqrt(Dh), causal=causal, block_q=16, block_k=16, seq_len=T)
    o, lse = jax.jit(functools.partial(jax_flash_fwd, **kw))(q, k, v)
    want = jax.jit(functools.partial(jax_flash_bwd, **kw))((q, k, v, o, lse), g)

    def port(a):
        return torch.from_numpy(np.array(a))[:, :, None, :]

    tq, tk, tv, tg, to = map(port, (q, k, v, g, o))
    lse_t = torch.from_numpy(np.asarray(lse))[..., 0][:, None, :].contiguous()
    delta = (tg * to).sum(-1).transpose(1, 2).contiguous()
    got = flash_bwd_plain(tq, tk, tv, tg, lse_t, delta, scale=kw["scale"], causal=causal,
                          seq_len=T)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a[:, :, 0].numpy(), np.asarray(w), **GRAD_TOL)
    assert not got[1][:, T:].any() and not got[2][:, T:].any()


def test_rounded_plain_backward_stays_within_the_rounding_bound():
    q, k, v, g = _bf16_inputs(1, 70, 2, 32, seed=13)
    scale = 1.0 / math.sqrt(32)
    o, lse = flash_fwd_plain(q, k, v, scale=scale, causal=True)
    delta = (g * o).sum(-1).transpose(1, 2).contiguous()
    exact = flash_bwd_plain(q, k, v, g, lse, delta, scale=scale, causal=True)
    rounded = flash_bwd_plain(q, k, v, g, lse, delta, scale=scale, causal=True,
                              round_bf16=True)
    bounds = bf16_rounding_bounds(q, k, v, g, lse, delta, scale=scale, causal=True)[1:]
    for a, b, bound in zip(rounded, exact, bounds):
        assert not torch.equal(a, b)  # the option rounds
        _within(a, b, bound, **GRAD_TOL)


# ---------------------------------------------------------------------------
# (b) the kernels' schedule, emulated blockwise
# ---------------------------------------------------------------------------

def _pad_rows(t, rows):
    """Rows past T read as zeros, as TMA's out-of-bounds fill gives them."""
    return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, rows - t.shape[1]))


def _emulate_fwd(q, k, v, *, causal, seq_len, round_p):
    """``tdn_flash_fwd_sm90``'s loops: one CTA per 128 query rows, two
    64-row warpgroups, 128-key tiles up to the causal stop, the online
    softmax in the log2 domain."""
    B, T, H, Dh = q.shape
    blk, wg = SM90_TILES
    c = LOG2E / math.sqrt(Dh)
    n_keys = min(T, seq_len)
    n_qb = -(-T // blk)
    qp, kp, vp = (_pad_rows(t, n_qb * blk) for t in (q, k, v))
    o = torch.zeros(B, T, H, Dh)
    lse = torch.zeros(B, H, T)
    for qb in range(n_qb):
        q0 = qb * blk
        k_end = min(n_keys, q0 + blk) if causal else n_keys
        for w in range(blk // wg):
            qw0 = q0 + wg * w
            rows = qw0 + torch.arange(wg)
            m = torch.full((B, H, wg), NEG_INF)
            l = torch.zeros(B, H, wg)
            acc = torch.zeros(B, H, wg, Dh)
            for k0 in range(0, k_end, blk):
                s = torch.einsum("bqhd,bkhd->bhqk", qp[:, qw0:qw0 + wg], kp[:, k0:k0 + blk]) * c
                if k0 + blk > n_keys or (causal and k0 + blk - 1 > qw0):
                    keys = k0 + torch.arange(blk)
                    ok = (keys[None, :] < n_keys) & (~torch.tensor(causal)
                                                     | (keys[None, :] <= rows[:, None]))
                    s = torch.where(ok, s, NEG_INF)
                mx = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2(m - mx)
                p = torch.where(s == NEG_INF, 0.0, torch.exp2(s - mx[..., None]))
                l = l * alpha + p.sum(-1)
                if round_p:
                    p = p.to(torch.bfloat16).float()
                acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                            vp[:, k0:k0 + blk])
                m = mx
            l_safe = torch.where(l == 0.0, 1.0, l)
            keep = rows < T
            r = rows[keep]
            o[:, r] = (acc / l_safe[..., None])[:, :, keep].transpose(1, 2)
            lse[:, :, r] = torch.where(m == NEG_INF, NEG_INF,
                                       (m + torch.log2(l_safe)) / LOG2E)[:, :, keep]
    return o, lse


def _emulate_bwd(q, k, v, do, lse, delta, *, causal, seq_len, round_bf16):
    """``tdn_flash_bwd_sm90``'s loops: one CTA per 128 keys, two 64-key
    warpgroups, 64-row query tiles from the causal start; a tile's dq is
    warpgroup 0's partial plus warpgroup 1's, added into the float32
    workspace in key-block order (the kernel's turn counters)."""
    B, T, H, Dh = q.shape
    blk, wg = SM90_TILES
    scale = 1.0 / math.sqrt(Dh)
    c = scale * LOG2E
    n_keys = min(T, seq_len)
    n_kb = -(-T // blk)
    n_qt = -(-T // wg)
    rows_p = max(n_kb * blk, n_qt * wg)
    qp, kp, vp, dop = (_pad_rows(t, rows_p) for t in (q, k, v, do))
    lse2 = torch.nn.functional.pad(lse * LOG2E, (0, rows_p - T))
    dl = torch.nn.functional.pad(delta, (0, rows_p - T))
    dq = torch.zeros(B, T, H, Dh)
    dk = torch.zeros(B, T, H, Dh)
    dv = torch.zeros(B, T, H, Dh)
    rnd = (lambda t: t.to(torch.bfloat16).float()) if round_bf16 else (lambda t: t)
    for kb in range(n_kb):  # the order the turn counters impose on each tile
        k0 = kb * blk
        i_begin = n_qt if k0 >= n_keys else (k0 // wg if causal else 0)
        parts = {}  # query tile -> the CTA's dq partial, warpgroup 0's first
        for w in range(blk // wg):
            key_lo = k0 + wg * w
            keys = key_lo + torch.arange(wg)
            kw_, vw = kp[:, key_lo:key_lo + wg], vp[:, key_lo:key_lo + wg]
            dk_acc = torch.zeros(B, H, wg, Dh)
            dv_acc = torch.zeros(B, H, wg, Dh)
            for i in range(i_begin, n_qt):
                q0 = i * wg
                if key_lo >= n_keys or (causal and q0 + wg - 1 < key_lo):
                    continue
                qs = q0 + torch.arange(wg)
                qt, dot = qp[:, q0:q0 + wg], dop[:, q0:q0 + wg]
                s_t = torch.einsum("bkhd,bqhd->bhkq", kw_, qt)
                dp_t = torch.einsum("bkhd,bqhd->bhkq", vw, dot)
                p = torch.exp2(s_t * c - lse2[:, :, None, q0:q0 + wg])
                if key_lo + wg > n_keys or q0 + wg > T or (causal and key_lo + wg - 1 > q0):
                    ok = ((keys[:, None] < n_keys) & (qs[None, :] < T)
                          & (~torch.tensor(causal) | (keys[:, None] <= qs[None, :])))
                    p = torch.where(ok, p, 0.0)
                ds = p * (dp_t - dl[:, :, None, q0:q0 + wg])
                p, ds = rnd(p), rnd(ds)
                dv_acc += torch.einsum("bhkq,bqhd->bhkd", p, dot)
                dk_acc += torch.einsum("bhkq,bqhd->bhkd", ds, qt)
                part = torch.einsum("bhkq,bkhd->bqhd", ds, kw_)
                parts[i] = part if i not in parts else parts[i] + part
            keep = keys < T
            dk[:, keys[keep]] = (dk_acc * scale)[:, :, keep].transpose(1, 2)
            dv[:, keys[keep]] = dv_acc[:, :, keep].transpose(1, 2)
        for i, part in sorted(parts.items()):
            qs = i * wg + torch.arange(wg)
            keep = qs < T
            dq[:, qs[keep]] += (part * scale)[:, keep]
    return dq, dk, dv


@pytest.mark.parametrize("short", [False, True], ids=["seq_len=T", "seq_len<T"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
@pytest.mark.parametrize("T", [1, 17, 127, 128, 129, 200, 1000])
def test_emulated_sm90_schedule_matches_the_plain_versions(T, causal, short):
    B, H, Dh = 1, 2, 32
    seq_len = max(1, T - T // 5) if short else T
    q, k, v, do = _bf16_inputs(B, T, H, Dh, seed=T)
    scale = 1.0 / math.sqrt(Dh)
    kw = dict(causal=causal, seq_len=seq_len)
    o_ref, lse_ref = flash_fwd_plain(q, k, v, scale=scale, **kw)
    delta = (do * o_ref).sum(-1).transpose(1, 2).contiguous()
    refs = flash_bwd_plain(q, k, v, do, lse_ref, delta, scale=scale, **kw)
    bounds = bf16_rounding_bounds(q, k, v, do, lse_ref, delta, scale=scale, **kw)
    # Unrounded, the schedule is the plain function: the tiles, stops and
    # masks lose nothing and add nothing.
    o, lse = _emulate_fwd(q, k, v, round_p=False, **kw)
    torch.testing.assert_close(o, o_ref, **FWD_TOL)
    torch.testing.assert_close(lse, lse_ref, **FWD_TOL)
    for got, want in zip(_emulate_bwd(q, k, v, do, lse_ref, delta, round_bf16=False, **kw),
                         refs):
        torch.testing.assert_close(got, want, **GRAD_TOL)
    # With the kernels' bf16 rounding of P and dS: within the bound.
    o, lse = _emulate_fwd(q, k, v, round_p=True, **kw)
    _within(o, o_ref, bounds[0], **FWD_TOL)
    torch.testing.assert_close(lse, lse_ref, **FWD_TOL)
    got = _emulate_bwd(q, k, v, do, lse_ref, delta, round_bf16=True, **kw)
    for g, want, bound in zip(got, refs, bounds[1:]):
        _within(g, want, bound, **GRAD_TOL)
    if seq_len < T:  # keys past seq_len get no gradient
        assert not got[1][:, seq_len:].any() and not got[2][:, seq_len:].any()


# ---------------------------------------------------------------------------
# (c) routing
# ---------------------------------------------------------------------------

def test_route_is_by_dtype():
    assert flash_route("cpu", torch.bfloat16, 48) == "plain"
    assert flash_route("cpu", torch.float32, 64) == "plain"
    assert flash_route("cuda", torch.float32, 48, [6], [8]) == "f32"
    for dh in SM90_HEAD_DIMS:
        assert flash_route("cuda", torch.bfloat16, dh, [2 * dh, 4608, 4608 * 1024],
                           [0x7F0000001000, 0x7F0000001600]) == "sm90"


@pytest.mark.parametrize(
    "head_dim,strides,addresses,match",
    [(48, [96], [0], "head dims"), (16, [32], [0], "head dims"),
     (64, [128, 264], [0], "multiples of 16"), (64, [128], [0x1008], "aligned")],
    ids=["Dh48", "Dh16", "stride264", "address8"])
def test_route_raises_for_bf16_on_the_card_that_sm90_does_not_take(head_dim, strides,
                                                                     addresses, match):
    with pytest.raises(InvalidArgumentError, match=match):
        flash_route("cuda", torch.bfloat16, head_dim, strides, addresses)


def test_route_raises_for_other_dtypes():
    with pytest.raises(InvalidArgumentError, match="takes"):
        flash_route("cuda", torch.float16, 64)


def test_launch_parameters_carry_the_tiles_and_tma_strides():
    # The three views of a fused (B, T, 3H, Dh) projection, as the
    # transformer passes them: token stride 3 H Dh, head stride Dh.
    qkv = torch.zeros(2, 10, 3 * 4, 64, dtype=torch.bfloat16)
    q, k, v = qkv.split(4, dim=2)
    params = list(_sm90_params(q, 7, True, q, k, v))
    assert params[:8] == [2, 4, 10, 64, 7, 1, *SM90_TILES]
    assert params[8:] == [10 * 12 * 64, 12 * 64, 64] * 3
    # A dimension of size 1 is never stepped: it gets the packed stride.
    one = torch.zeros(3, 48, 16)[:, :, None, :].expand(3, 48, 1, 16)
    assert _tma_strides(one) == (48 * 16, 16, 16)


def test_routed_entries_run_the_plain_versions_on_the_cpu():
    q, k, v, do = (t.to(torch.bfloat16) for t in _bf16_inputs(1, 20, 2, 48, seed=3))
    reset_launch_counts()
    o, lse = flash_fwd(q, k, v, causal=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = flash_bwd(q, k, v, do, lse, delta, causal=True)
    assert o.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert all(fn.launches == 0 for fn in KERNEL_WRAPPERS)
