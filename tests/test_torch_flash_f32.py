"""The float32 flash-attention route of the port, on the CPU.

The TF32 tensor-core kernels (``csrc/flash_attention_f32.cu``) run only
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``). Here:

(a) a numpy emulation of their arithmetic: the 3xTF32 split (hi =
    round-to-nearest, ties away, to TF32's 10 mantissa bits, as
    ``cvt.rna.tf32.f32``; lo = the same of the remainder) and one
    ``mma.sync.m16n8k8`` tile product through the PTX fragment layouts
    of A, B and C, with the kernels' own fragment loads: S = X Y^T, the
    C fragments of S taken as A fragments of S V (the permuted reduction
    order that makes that move a register renaming), and dQ = dS K
    through the backward's dS tile in shared memory. Each is held
    against float64 within 2^-20 of the product over absolute values:
    the three dropped terms (lo lo and each operand's lo rounding) are
    each at most 2^-22 of |a b|. A load that takes a neighbouring lane's
    element fails the same check;
(b) a blockwise torch emulation of the two kernels' schedule (the
    ``f32_tiles`` query blocks and key tiles in the forward, 64-key
    blocks over query tiles in the backward, the causal start and stop,
    element masks only on edge tiles, exp2 with the scale folded in, dq
    summed per key block, every product in 3xTF32) against the plain
    versions;
(c) the float32 wrappers, their launch parameters and routing.

Tolerances: the float32 ones of ``tests/test_flash_attention.py`` (2e-5
forward, 2e-4 gradients).
"""

import math

import numpy as np
import pytest
import torch

from tpu_dist_nn_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
from tpu_dist_nn_torch.kernels.flash_attention import (
    F32_TILES,
    MAX_HEAD_DIM,
    NEG_INF,
    _f32_params,
    f32_tiles,
    flash_bwd,
    flash_bwd_f32,
    flash_bwd_plain,
    flash_fwd,
    flash_fwd_f32,
    flash_fwd_plain,
    flash_route,
)
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

torch.set_num_threads(1)
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
LOG2E = math.log2(math.e)
#: The 3xTF32 product's error bound, relative to the product over
#: absolute values: three dropped terms of at most 2^-22 each.
SPLIT_BOUND = 2.0**-20
BWD_KEYS = F32_TILES[64].bwd_keys  # keys of a backward CTA, at every width
DS_PITCH = BWD_KEYS + 8  # the backward's dS tile in shared memory

# ---------------------------------------------------------------------------
# (a) the 3xTF32 split and the m16n8k8 fragments
# ---------------------------------------------------------------------------


def tf32_rna(x):
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, ties
    away from zero (the low 13 bits of the result are 0)."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """The kernels' split: ``hi = tf32(x)``, ``lo = tf32(x - hi)``."""
    x = np.asarray(x, dtype=np.float32)
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


# The PTX ISA's fragment layouts of mma.m16n8k8 with .tf32 operands:
# (row, column) of register i of a lane (g = lane / 4, t = lane % 4).
def ptx_a(lane, i):
    return lane // 4 + 8 * (i % 2), lane % 4 + 4 * (i // 2)


def ptx_b(lane, i):
    return lane % 4 + 4 * i, lane // 4  # (k, n)


def ptx_c(lane, i):
    return lane // 4 + 8 * (i // 2), 2 * (lane % 4) + i % 2


def mma(a, b, c):
    """One warp's ``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32``:
    a (32, 4), b (32, 2), c (32, 4) registers per lane; products exact,
    sums in float64."""
    A, B, C = np.zeros((16, 8)), np.zeros((8, 8)), np.zeros((16, 8))
    for lane in range(32):
        for i in range(4):
            A[ptx_a(lane, i)] = a[lane, i]
            C[ptx_c(lane, i)] = c[lane, i]
        for i in range(2):
            B[ptx_b(lane, i)] = b[lane, i]
    D = A @ B + C
    return np.array([[D[ptx_c(lane, i)] for i in range(4)] for lane in range(32)])


def mma3(a, b, c):
    """The kernels' 3xTF32 step: ``c + a_lo b_hi + a_hi b_lo + a_hi b_hi``."""
    (ah, al), (bh, bl) = split(a), split(b)
    return mma(ah, bh, mma(ah, bl, mma(al, bh, c)))


def lanes():
    return [(lane // 4, lane % 4) for lane in range(32)]


# The kernels' fragment loads (csrc/flash_attention_f32.cu), lane by lane.
def load_a(tile, r, c):
    """``load_a``: rows r + g, r + g + 8; columns c + t, c + t + 4."""
    return np.array([[tile[r + g, c + t], tile[r + g + 8, c + t], tile[r + g, c + t + 4],
                      tile[r + g + 8, c + t + 4]] for g, t in lanes()])


def load_b_rows(tile, n0, c):
    """``load_b_rows``: B(k, n) = tile[n0 + n, c + k], k in t, t + 4."""
    return np.array([[tile[n0 + g, c + t], tile[n0 + g, c + t + 4]] for g, t in lanes()])


def load_b_perm(tile, k0, n0):
    """``load_b_perm``: B(k, n) = tile[k0 + key(k), n0 + n], the reduction
    permuted: fragment k = t <-> key 2t, k = t + 4 <-> key 2t + 1."""
    return np.array([[tile[k0 + 2 * t, n0 + g], tile[k0 + 2 * t + 1, n0 + g]]
                     for g, t in lanes()])


def c_as_a(c):
    """``c_as_a``: the C fragment as an A fragment over the same 8
    columns in the permuted order; each lane keeps its own values."""
    return c[:, [0, 2, 1, 3]]


def from_c(frags):
    """A (16, 8 n) matrix from C fragments, by the PTX layout."""
    out = np.zeros((16, 8 * len(frags)))
    for n, c in enumerate(frags):
        for lane in range(32):
            for i in range(4):
                r, col = ptx_c(lane, i)
                out[r, 8 * n + col] = c[lane, i]
    return out


def within_split_bound(got, want, abs_product):
    assert got.shape == want.shape
    excess = np.abs(got - want) - SPLIT_BOUND * abs_product
    assert excess.max() <= 0.0, f"over 2^-20 of |a||b| by {excess.max():.3e}"


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_split_is_tf32_and_its_remainder():
    x = _f32(np.random.default_rng(0), 4096) * np.float32(1e3)
    hi, lo = split(x)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert not (lo.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert (np.abs(x.astype(np.float64) - hi) <= 2.0**-11 * np.abs(x)).all()
    assert (np.abs(x.astype(np.float64) - hi - lo) <= 2.0**-22 * np.abs(x)).all()
    # ties go away from zero: 1 + 2^-11 is halfway between two TF32 values
    tie = np.array([1 + 2.0**-11, -(1 + 2.0**-11)], dtype=np.float32)
    np.testing.assert_array_equal(tf32_rna(tie), [1 + 2.0**-10, -(1 + 2.0**-10)])


def _scores(X, Y, load_b=load_b_rows):
    """S = X Y^T (16 rows, 8 n columns) as the forward's S loop builds it."""
    n_tiles, n_ks = Y.shape[0] // 8, X.shape[1] // 8
    frags = []
    for n in range(n_tiles):
        c = np.zeros((32, 4))
        for ks in range(n_ks):
            c = mma3(load_a(X, 0, 8 * ks), load_b(Y, 8 * n, 8 * ks), c)
        frags.append(c)
    return frags


def test_tile_product_through_the_fragments_matches_float64():
    rng = np.random.default_rng(1)
    X, Y = _f32(rng, 16, 32), _f32(rng, 16, 32)  # 4 k-steps, 2 n-tiles
    got = from_c(_scores(X, Y))
    within_split_bound(got, X.astype(np.float64) @ Y.T.astype(np.float64), np.abs(X) @ np.abs(Y).T)
    # Plain TF32 (one product) is far outside the bound: the split is what
    # keeps float32 accuracy.
    one = X.astype(np.float64) @ Y.T.astype(np.float64)
    tf32 = tf32_rna(X).astype(np.float64) @ tf32_rna(Y).T.astype(np.float64)
    assert (np.abs(tf32 - one) > SPLIT_BOUND * (np.abs(X) @ np.abs(Y).T)).any()


def test_p_moves_from_the_c_to_the_a_layout_without_leaving_its_lane():
    # O = S V over 16 keys: the C fragments of S (two n-tiles) are the A
    # fragments of the PV product, with V's B fragments in the permuted
    # key order.
    rng = np.random.default_rng(2)
    X, Y, V = _f32(rng, 16, 16), _f32(rng, 16, 16), _f32(rng, 16, 24)
    s_frags = [c.astype(np.float32) for c in _scores(X, Y)]
    S = from_c(s_frags)
    out = []
    for n in range(V.shape[1] // 8):
        c = np.zeros((32, 4))
        for j, s in enumerate(s_frags):
            c = mma3(c_as_a(s), load_b_perm(V, 8 * j, 8 * n), c)
        out.append(c)
    within_split_bound(from_c(out), S @ V.astype(np.float64), np.abs(S) @ np.abs(V))


def test_dq_through_the_shared_ds_tile_matches_float64():
    # The backward: each warp's dS^T C fragments (16 keys x BQ queries)
    # stored as dS[query][key] (pitch 72), read back by query rows as A
    # fragments (two float2 reads a lane) against K's permuted B
    # fragments over the block's 64 keys.
    rng = np.random.default_rng(3)
    BQ, Dh = 32, 16
    dS_T = _f32(rng, BWD_KEYS, BQ)  # [key][query]
    K = _f32(rng, BWD_KEYS, Dh)
    smem = np.full((BQ, DS_PITCH), np.nan, dtype=np.float32)
    for w in range(4):
        frags = [np.array([[dS_T[16 * w + g + 8 * (i // 2), 8 * j + 2 * t + i % 2]
                            for i in range(4)] for g, t in lanes()]) for j in range(BQ // 8)]
        for j, c in enumerate(frags):
            for (g, t), regs in zip(lanes(), c):
                for e in range(4):
                    smem[8 * j + 2 * t + (e & 1), 16 * w + g + 8 * (e >> 1)] = regs[e]
    assert not np.isnan(smem[:, :BWD_KEYS]).any()
    got = np.zeros((BQ, Dh))
    for mt in range(BQ // 16):
        for n in range(Dh // 8):
            c = np.zeros((32, 4))
            for kk in range(BWD_KEYS // 8):
                a = np.array([[smem[16 * mt + g, 8 * kk + 2 * t], smem[16 * mt + g + 8, 8 * kk + 2 * t],
                               smem[16 * mt + g, 8 * kk + 2 * t + 1],
                               smem[16 * mt + g + 8, 8 * kk + 2 * t + 1]] for g, t in lanes()])
                c = mma3(a, load_b_perm(K, 8 * kk, 8 * n), c)
            got[16 * mt:16 * mt + 16, 8 * n:8 * n + 8] = from_c([c])
    dS = dS_T.T.astype(np.float64)
    within_split_bound(got, dS @ K.astype(np.float64), np.abs(dS) @ np.abs(K))


@pytest.mark.parametrize("fault", ["a_from_next_lane", "b_from_next_lane", "c_as_a_unpermuted"])
def test_a_lane_reading_its_neighbours_element_fails_the_check(fault):
    rng = np.random.default_rng(4)
    X, Y, V = _f32(rng, 16, 8), _f32(rng, 8, 8), _f32(rng, 8, 8)
    shift = np.roll(np.arange(32), -1)
    a, b = load_a(X, 0, 0), load_b_rows(Y, 0, 0)
    if fault == "a_from_next_lane":
        a = a[shift]
    if fault == "b_from_next_lane":
        b = b[shift]
    s = mma3(a, b, np.zeros((32, 4)))
    if fault == "c_as_a_unpermuted":
        S = from_c([s])
        o = from_c([mma3(s, load_b_perm(V, 0, 0), np.zeros((32, 4)))])
        with pytest.raises(AssertionError):
            within_split_bound(o, S @ V.astype(np.float64), np.abs(S) @ np.abs(V))
        return
    with pytest.raises(AssertionError):
        within_split_bound(from_c([s]), X.astype(np.float64) @ Y.T.astype(np.float64),
                           np.abs(X) @ np.abs(Y).T)


# ---------------------------------------------------------------------------
# (b) the kernels' schedule, emulated blockwise
# ---------------------------------------------------------------------------

def _t_split(x):
    hi, lo = split(x.numpy())
    return torch.from_numpy(hi).double(), torch.from_numpy(lo).double()


def mm3(spec, a, b):
    """``einsum(spec, a, b)`` with every product in 3xTF32, summed in
    float64 and rounded to float32."""
    (ah, al), (bh, bl) = _t_split(a), _t_split(b)
    return (torch.einsum(spec, al, bh) + torch.einsum(spec, ah, bl)
            + torch.einsum(spec, ah, bh)).float()


def _pad_rows(t, rows):
    """Rows past T read as zeros, as the kernels' zero-filled copies give them."""
    return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, rows - t.shape[1]))


def _emulate_fwd(q, k, v, *, causal, seq_len):
    """``tdn_flash_fwd_f32``'s loops: one CTA per ``f32_tiles(Dh).fwd_rows``
    query rows, key tiles of ``fwd_keys`` up to the causal stop, the
    online softmax in the log2 domain."""
    B, T, H, Dh = q.shape
    qb_rows, kb = f32_tiles(Dh).fwd_rows, f32_tiles(Dh).fwd_keys
    c = LOG2E / math.sqrt(Dh)
    n_keys = min(T, seq_len)
    n_qb = -(-T // qb_rows)
    rows_p = max(n_qb * qb_rows, -(-T // kb) * kb)
    qp, kp, vp = (_pad_rows(t, rows_p) for t in (q, k, v))
    o = torch.zeros(B, T, H, Dh)
    lse = torch.zeros(B, H, T)
    for qb in range(n_qb):
        q0 = qb * qb_rows
        rows = q0 + torch.arange(qb_rows)
        k_end = min(n_keys, q0 + qb_rows) if causal else n_keys
        qs = qp[:, q0:q0 + qb_rows] * c
        m = torch.full((B, H, qb_rows), NEG_INF)
        l = torch.zeros(B, H, qb_rows)
        acc = torch.zeros(B, H, qb_rows, Dh)
        for k0 in range(0, k_end, kb):
            s = mm3("bqhd,bkhd->bhqk", qs, kp[:, k0:k0 + kb])
            edge = (causal and k0 + kb - 1 > q0) or k0 + kb > n_keys
            if edge:
                keys = k0 + torch.arange(kb)
                ok = (keys[None, :] < n_keys) & (~torch.tensor(causal)
                                                 | (keys[None, :] <= rows[:, None]))
                s = torch.where(ok, s, NEG_INF)
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(s - mx[..., None])
            if edge:
                p = torch.where(s == NEG_INF, 0.0, p)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + mm3("bhqk,bkhd->bhqd", p, vp[:, k0:k0 + kb])
            m = mx
        l_safe = torch.where(l == 0.0, 1.0, l)
        keep = rows < T
        r = rows[keep]
        o[:, r] = (acc / l_safe[..., None])[:, :, keep].transpose(1, 2)
        lse[:, :, r] = torch.where(m == NEG_INF, NEG_INF,
                                   (m + torch.log2(l_safe)) / LOG2E)[:, :, keep]
    return o, lse


def _emulate_bwd(q, k, v, do, lse, delta, *, causal, seq_len):
    """``tdn_flash_bwd_f32``'s loops: one CTA per ``f32_tiles(Dh).bwd_keys``
    keys, query tiles of ``bwd_rows`` from the causal start; dq summed
    one key block's partial at a time."""
    B, T, H, Dh = q.shape
    blk, bq = f32_tiles(Dh).bwd_keys, f32_tiles(Dh).bwd_rows
    scale = 1.0 / math.sqrt(Dh)
    c = scale * LOG2E
    n_keys = min(T, seq_len)
    n_kb = -(-T // blk)
    rows_p = n_kb * blk + bq
    qp, kp, vp, dop = (_pad_rows(t, rows_p) for t in (q, k, v, do))
    lse2 = torch.nn.functional.pad(lse, (0, rows_p - T)) * LOG2E
    dl = torch.nn.functional.pad(delta, (0, rows_p - T))
    dq = torch.zeros(B, T, H, Dh)
    dk = torch.zeros(B, T, H, Dh)
    dv = torch.zeros(B, T, H, Dh)
    for kb in range(n_kb):
        k0 = kb * blk
        keys = k0 + torch.arange(blk)
        kw, vw = kp[:, k0:k0 + blk], vp[:, k0:k0 + blk]
        dk_acc = torch.zeros(B, H, blk, Dh)
        dv_acc = torch.zeros(B, H, blk, Dh)
        q_begin = T if k0 >= n_keys else (k0 if causal else 0)
        for q0 in range(q_begin, T, bq):
            qs = q0 + torch.arange(bq)
            qt, dot = qp[:, q0:q0 + bq], dop[:, q0:q0 + bq]
            s_t = mm3("bkhd,bqhd->bhkq", kw, qt)
            dp_t = mm3("bkhd,bqhd->bhkq", vw, dot)
            p = torch.exp2(s_t * c - lse2[:, :, None, q0:q0 + bq])
            if (causal and k0 + blk - 1 > q0) or k0 + blk > n_keys or q0 + bq > T:
                ok = ((keys[:, None] < n_keys) & (qs[None, :] < T)
                      & (~torch.tensor(causal) | (keys[:, None] <= qs[None, :])))
                p = torch.where(ok, p, 0.0)
            ds = p * (dp_t - dl[:, :, None, q0:q0 + bq])
            dv_acc += mm3("bhkq,bqhd->bhkd", p, dot)
            dk_acc += mm3("bhkq,bqhd->bhkd", ds, qt)
            part = mm3("bhkq,bkhd->bqhd", ds, kw) * scale
            keep = qs < T
            dq[:, qs[keep]] += part[:, keep]
        keep = keys < T
        dk[:, keys[keep]] = (dk_acc * scale)[:, :, keep].transpose(1, 2)
        dv[:, keys[keep]] = dv_acc[:, :, keep].transpose(1, 2)
    return dq, dk, dv


def _inputs(B, T, H, Dh, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, T, H, Dh)).astype(np.float32))
            for _ in range(4)]


@pytest.mark.parametrize("short", [False, True], ids=["seq_len=T", "seq_len<T"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
@pytest.mark.parametrize("T,Dh", [(1, 8), (17, 16), (63, 32), (64, 64), (65, 32), (130, 64),
                                  (200, 128)])
def test_emulated_f32_schedule_matches_the_plain_versions(T, Dh, causal, short):
    B, H = 1, 2
    seq_len = max(1, T - T // 5) if short else T
    q, k, v, do = _inputs(B, T, H, Dh, seed=T + Dh)
    scale = 1.0 / math.sqrt(Dh)
    kw = dict(causal=causal, seq_len=seq_len)
    o_ref, lse_ref = flash_fwd_plain(q, k, v, scale=scale, **kw)
    o, lse = _emulate_fwd(q, k, v, **kw)
    torch.testing.assert_close(o, o_ref, **FWD_TOL)
    torch.testing.assert_close(lse, lse_ref, **FWD_TOL)
    delta = (do * o_ref).sum(-1).transpose(1, 2).contiguous()
    got = _emulate_bwd(q, k, v, do, lse_ref, delta, **kw)
    for g, want in zip(got, flash_bwd_plain(q, k, v, do, lse_ref, delta, scale=scale, **kw)):
        torch.testing.assert_close(g, want, **GRAD_TOL)
    if seq_len < T:  # keys past seq_len get no gradient
        assert not got[1][:, seq_len:].any() and not got[2][:, seq_len:].any()


# ---------------------------------------------------------------------------
# (c) the wrappers, their parameters and the route
# ---------------------------------------------------------------------------

def test_float32_on_the_card_routes_to_the_f32_kernels():
    assert flash_route("cuda", torch.float32, 48, [6], [8]) == "f32"
    for dh in (1, 8, 32, 33, 64, 100, MAX_HEAD_DIM):
        assert flash_route("cuda", torch.float32, dh) == "f32"
    assert flash_route("cpu", torch.float32, 64) == "plain"


def test_tiles_cover_every_head_dim_up_to_the_maximum():
    assert [f32_tiles(d).width for d in (1, 8, 32, 33, 64, 65, 128)] == [32, 32, 32, 64, 64,
                                                                         128, 128]
    for width, tiles in F32_TILES.items():
        assert tiles.width == width
        # 4 warps of 16 or 32 query rows; 4 warps of 16 keys
        assert tiles.fwd_rows in (64, 128) and tiles.bwd_keys == BWD_KEYS == 64
        assert tiles.fwd_keys % 8 == 0 and tiles.bwd_rows % 8 == 0
        assert 4 % (tiles.bwd_rows // 16) == 0  # dQ: whole 16-row m-tiles over the 4 warps


def test_launch_parameters_carry_strides_width_and_tile():
    # The three views of a fused (B, T, 3H, Dh) projection: token stride
    # 3 H Dh, head stride Dh.
    qkv = torch.zeros(2, 10, 3 * 4, 64)
    q, k, v = qkv.split(4, dim=2)
    fwd = list(_f32_params(q, k, v, 7, True, backward=False))
    bwd = list(_f32_params(q, k, v, 7, True, backward=True))
    assert fwd[:6] == bwd[:6] == [2, 4, 10, 64, 7, 1]
    assert fwd[6:15] == bwd[6:15] == [10 * 12 * 64, 12 * 64, 64] * 3
    assert fwd[15:] == [64, F32_TILES[64].fwd_rows, F32_TILES[64].fwd_keys]
    assert bwd[15:] == [64, F32_TILES[64].bwd_keys, F32_TILES[64].bwd_rows]
    with pytest.raises(InvalidArgumentError, match="32-bit"):
        big = torch.zeros(1, 2, 1, 8).as_strided((1, 2, 1, 8), (2**31, 8, 8, 1))
        _f32_params(big, big, big, 2, False, backward=False)


def test_f32_wrappers_run_the_plain_versions_on_the_cpu():
    q, k, v, do = _inputs(2, 20, 2, 24, seed=5)
    scale = 1.0 / math.sqrt(24)
    reset_launch_counts()
    o, lse = flash_fwd_f32(q, k, v, causal=True)
    o_ref, lse_ref = flash_fwd_plain(q, k, v, scale=scale, causal=True)
    torch.testing.assert_close(o, o_ref, atol=0, rtol=0)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    for a, b in zip(flash_bwd_f32(q, k, v, do, lse, delta, causal=True),
                    flash_bwd(q, k, v, do, lse, delta, causal=True)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert flash_fwd(q, k, v, causal=True)[0].equal(o)
    assert all(fn.launches == 0 for fn in KERNEL_WRAPPERS)


def test_f32_wrappers_check_their_inputs_before_any_launch():
    q, k, v, do = _inputs(1, 16, 2, 8, seed=6)
    o, lse = flash_fwd_f32(q, k, v, causal=True)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    with pytest.raises(InvalidArgumentError, match="contiguous float32"):
        flash_bwd_f32(q, k, v, do, lse[:, :, :8], delta, causal=True)
    with pytest.raises(InvalidArgumentError, match="do must be contiguous"):
        flash_bwd_f32(q, k, v, do.transpose(1, 2).contiguous().transpose(1, 2), lse, delta,
                      causal=True)
    with pytest.raises(InvalidArgumentError, match="seq_len"):
        flash_bwd_f32(q, k, v, do, lse, delta, causal=True, seq_len=17)
    with pytest.raises(InvalidArgumentError, match="expected torch.float32"):
        flash_fwd_f32(q, k.double(), v, causal=False)
