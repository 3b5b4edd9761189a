"""The port's dense-layer kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX kernels
run in Pallas interpret mode, as the JAX package's own tests run them
(``tests/test_kernels.py``, ``tests/test_quantized.py``), at those
tests' tolerances. The kernels themselves run only on the card:
``tests/test_torch_cuda.py`` and ``python3 chip_smoke.py`` hold them
against their plain versions there. The f32 chain kernel's schedule
(its planner's row tile and split-K, each cluster rank's K slices, the
rank-order reduction and the column passes) is written out in torch
here and held against both, and so is the int8 chain's tensor-core
schedule (its packed weights, each lane's MMA fragments, the codes'
chunks past the resident width) in integer arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist_nn.core.activations import apply_activation as jax_apply_activation
from tpu_dist_nn.kernels import fcnn_fused_forward as jax_fcnn_fused_forward
from tpu_dist_nn.kernels import fused_dense as jax_fused_dense
from tpu_dist_nn.kernels import quantized as jax_q
from tpu_dist_nn.models.fcnn import init_fcnn as jax_init_fcnn
from tpu_dist_nn_torch.core.activations import apply_activation_by_id
from tpu_dist_nn_torch.kernels import (
    KERNEL_WRAPPERS,
    fcnn_fused_forward,
    fcnn_fused_forward_plain,
    fcnn_quantized_forward,
    forward_quantized,
    fused_dense,
    quantize_fcnn,
    reset_launch_counts,
)
from tpu_dist_nn_torch.kernels.fused_dense import (
    H100_SMS,
    SMEM_LIMIT_BYTES,
    activation_ids,
    chain_plan,
    column_passes,
    dense_plan,
    int8_plan,
    k_ranges,
)
from tpu_dist_nn_torch.kernels.quantized import pack_wq, unpack_wq
from tpu_dist_nn_torch.models.fcnn import forward, params_from_jax
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

torch.set_num_threads(1)

ACTIVATIONS = ["linear", "relu", "sigmoid", "tanh", "gelu", "softmax"]


def _xwb(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(m, k)).astype(np.float32),
        (rng.normal(size=(k, n)) * 0.1).astype(np.float32),
        (rng.normal(size=(n,)) * 0.1).astype(np.float32),
    )


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_params(sizes, acts, seed=0):
    return jax_init_fcnn(jax.random.key(seed), list(sizes), activations=acts)


# ------------------------------------------------------------- fused_dense

@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_fused_dense_matches_jax_kernel(activation):
    x, w, b = _xwb(32, 24, 16)
    want = np.asarray(jax_fused_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                      activation=activation))
    got = fused_dense(*_t(x, w, b), activation=activation).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    ref = np.asarray(jax_apply_activation(jnp.asarray(x) @ w + b, activation))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_fused_dense_tiled_grid_matches_jax():
    x, w, b = _xwb(300, 64, 200, seed=1)
    want = np.asarray(jax_fused_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                      activation="relu", block_m=128, block_n=128))
    got = fused_dense(*_t(x, w, b), activation="relu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_fused_dense_rejects_bad_inputs():
    x, w, b = _t(*_xwb(8, 12, 6))
    with pytest.raises(InvalidArgumentError, match="shape mismatch"):
        fused_dense(x, w, torch.zeros(7))
    with pytest.raises(InvalidArgumentError, match="dtype"):
        fused_dense(x.double(), w, b)
    with pytest.raises(InvalidArgumentError, match="contiguous"):
        fused_dense(x, w.t().contiguous().t(), b)
    with pytest.raises(InvalidArgumentError, match="unknown activation"):
        fused_dense(x, w, b, activation="swish")
    with pytest.raises(InvalidArgumentError, match="torch.Tensor"):
        fused_dense(x.numpy(), w, b)


# ------------------------------------------------------ fcnn_fused_forward

@pytest.mark.parametrize(
    "sizes,acts",
    [((24, 32, 16, 4), ["relu", "relu", "softmax"]),
     ((10, 8, 6), ["tanh", "sigmoid"]),
     ((12, 8, 4), ["gelu", "linear"])],
    ids=["relu-softmax", "tanh-sigmoid", "gelu-linear"],
)
def test_fused_chain_matches_jax_kernel(sizes, acts):
    jparams = _jax_params(sizes, acts)
    x = np.random.default_rng(1).normal(size=(100, sizes[0])).astype(np.float32)
    want = np.asarray(jax_fcnn_fused_forward(jparams, jnp.asarray(x), block_b=32,
                                             activations=acts))
    params = params_from_jax(jparams, device="cpu")
    got = fcnn_fused_forward(params, torch.from_numpy(x), activations=acts).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, forward(params, torch.from_numpy(x)).numpy(),
                               atol=2e-5, rtol=1e-4)


def test_fused_chain_uint8_input_scale_matches_jax_kernel():
    jparams = _jax_params((24, 16, 4), ["relu", "softmax"], seed=2)
    x = np.random.default_rng(2).integers(0, 256, (40, 24)).astype(np.uint8)
    want = np.asarray(jax_fcnn_fused_forward(jparams, jnp.asarray(x), block_b=16,
                                             input_scale=1.0 / 255.0))
    got = fcnn_fused_forward(params_from_jax(jparams, device="cpu"), torch.from_numpy(x),
                             input_scale=1.0 / 255.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


def test_chain_tile_rows_from_the_widest_boundaries():
    # The int8 chain keeps the widest interior row resident (f32 and its
    # codes) and the input's codes up to 1024 columns: 32-row tiles at
    # the flagship (256 tiles: two CTAs an SM), 16 rows when a 2000-wide
    # interior leaves room for no more; a 60000-wide input is quantised
    # in 1024-column chunks.
    plan = int8_plan([784, 128, 64, 10], 8192)
    assert (plan.tm, plan.ldh, plan.kc) == (32, 132, 832) and plan.ldq % 128 == 16
    assert int8_plan([1024, 1024, 1024, 10], 8192).tm == 32
    wide = int8_plan([3000, 2000, 10], 8192)
    assert (wide.tm, wide.kc) == (16, 2048) and wide.smem_bytes <= SMEM_LIMIT_BYTES
    assert int8_plan([60000, 16, 10], 5)[:4] == (16, 16, 1040, 1024)
    with pytest.raises(InvalidArgumentError, match=str(SMEM_LIMIT_BYTES)):
        int8_plan([64, 60000, 10], 5)
    # The f32 chain streams the input: only the interior widths (128,
    # 64) stay resident, so the flagship takes 64-row tiles, one CTA
    # each (the old kernel staged the 784-wide input and took 32).
    plan = chain_plan([784, 128, 64, 10], activation_ids(["relu", "relu", "softmax"]), 8192)
    assert (plan.tm, plan.split, plan.ld0, plan.ld1) == (64, 1, 132, 68)
    assert plan.smem_bytes <= SMEM_LIMIT_BYTES


def test_fused_chain_past_shared_memory_raises_naming_the_limit():
    wide = 60000  # 8 interior rows of 60000 floats are 1.9 MB > 227 KB
    with pytest.raises(InvalidArgumentError, match=str(SMEM_LIMIT_BYTES)):
        chain_plan([4, wide, 4], (0, 0), 2)
    # The wrapper plans only for a tensor off the CPU (on the card it
    # launches or raises; a meta tensor shows the raise without one),
    # and computes the plain version for CPU tensors.
    params = [{"w": torch.zeros(4, wide, device="meta"), "b": torch.zeros(wide, device="meta"),
               "act": 0},
              {"w": torch.zeros(wide, 4, device="meta"), "b": torch.zeros(4, device="meta"),
               "act": 0}]
    with pytest.raises(InvalidArgumentError, match=str(SMEM_LIMIT_BYTES)):
        fcnn_fused_forward(params, torch.zeros(2, 4, device="meta"))
    cpu = [{k: torch.zeros_like(v, device="cpu") if k != "act" else v for k, v in p.items()}
           for p in params]
    assert fcnn_fused_forward(cpu, torch.zeros(2, 4)).shape == (2, 4)


def test_fused_chain_takes_a_60000_wide_input():
    # The input streams through the K-slice ring, so its width is not
    # limited by shared memory (the old kernel staged it and raised).
    rng = np.random.default_rng(7)
    wide = 60000
    params = [{"w": torch.from_numpy((rng.normal(size=(wide, 4)) * 0.01).astype(np.float32)),
               "b": torch.from_numpy(rng.normal(size=4).astype(np.float32)), "act": 1}]
    x = torch.from_numpy(rng.uniform(0, 1, (3, wide)).astype(np.float32))
    got = fcnn_fused_forward(params, x)
    torch.testing.assert_close(got, fcnn_fused_forward_plain(params, x), atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(got, _emulate_chain(params, x, None)[0], atol=2e-5, rtol=1e-4)


# ------------------------------------ the f32 chain kernel's schedule, emulated

BK = 64  # csrc/f32_tile.cuh kBK


def _softmax_rows(z):
    # The kernel's row softmax: exp(z - max) / sum, whether it runs in
    # registers (one pass) or over the resident row (wider rows).
    e = torch.exp(z - z.max(dim=1, keepdim=True).values)
    return e / e.sum(dim=1, keepdim=True)


def _act(z, act):
    return _softmax_rows(z) if act == 3 else apply_activation_by_id(z, act)


def _pass_sums(a, w, kb, ke, c0, width):
    """One column pass over K slices [kb, ke): the register tile's sums,
    slice after slice."""
    cols = slice(c0, min(c0 + width, w.shape[1]))
    acc = torch.zeros((a.shape[0], cols.stop - cols.start), dtype=torch.float32)
    for k0 in range(kb, ke, BK):
        k1 = min(k0 + BK, ke)
        acc = acc + a[:, k0:k1] @ w[k0:k1, cols]
    return cols, acc


def _emulate_chain(params, x, activations, input_scale=None, sm_count=H100_SMS):
    """``csrc/fcnn_chain.cu``'s loop in torch: the planner's row tile and
    split, layer 0's K ranges (one a cluster rank, or all on one CTA),
    their sums added in range order, then bias, activation and the later
    layers' column passes on the leader."""
    acts = (activation_ids(activations) if activations is not None
            else tuple(int(p["act"]) for p in params))
    dims = [int(x.shape[1])] + [int(p["w"].shape[1]) for p in params]
    M = int(x.shape[0])
    plan = chain_plan(dims, acts, M, sm_count)
    h_all = x.to(torch.float32)
    if input_scale is not None:
        h_all = h_all * input_scale
    out = torch.empty((M, dims[-1]), dtype=torch.float32)
    for row0 in range(0, M, plan.tm):
        rows = min(plan.tm, M - row0)
        a = torch.zeros((plan.tm, dims[0]), dtype=torch.float32)
        a[:rows] = h_all[row0:row0 + rows]  # rows past M copy as zeros
        partials = []
        for kb, ke in k_ranges(dims[0]):
            part = torch.zeros((plan.tm, dims[1]), dtype=torch.float32)
            for c0, width in column_passes(dims[1]):
                cols, acc = _pass_sums(a, params[0]["w"], kb, ke, c0, width)
                part[:, cols] = acc
            partials.append(part)
        z = partials[0]
        for part in partials[1:]:  # range order, no atomics
            z = z + part
        h = _act(z + params[0]["b"], acts[0])
        for p, act in zip(params[1:], acts[1:]):
            z = torch.empty((plan.tm, p["w"].shape[1]), dtype=torch.float32)
            for c0, width in column_passes(p["w"].shape[1], first_layer=False):
                cols, acc = _pass_sums(h, p["w"], 0, h.shape[1], c0, width)
                z[:, cols] = acc + p["b"][cols]
            h = _act(z, act)
        out[row0:row0 + rows] = h[:rows]
    return out, plan


@pytest.mark.parametrize(
    "sizes,acts,rows,sm_count,split,u8",
    [
        # split 8: K 2100 (33 slices, 8 ranges, ragged), 70 rows (a
        # ragged second tile), a 150-wide softmax head: past one 64-column
        # pass of a later layer.
        ((2100, 40, 24, 150), ["relu", "tanh", "softmax"], 70, H100_SMS, 8, False),
        # split 2: K 1100 (18 slices, 2 ranges), softmax head of 10 in the epilogue.
        ((1100, 33, 10), ["gelu", "softmax"], 37, H100_SMS, 2, False),
        # split 1, one range: 2 SMs, filled by 2 row tiles; ragged N.
        ((24, 32, 16, 4), ["relu", "relu", "softmax"], 100, 2, 1, False),
        # split 1 over 2 ranges (K 1100): the lone CTA adds them in order.
        ((1100, 32, 4), ["relu", "softmax"], 100, 2, 1, False),
        # uint8 pixels scaled on read; split 2 (K 1100: 18 slices, 2 ranges).
        ((1100, 20, 5), ["sigmoid", "softmax"], 45, H100_SMS, 2, True),
        # split 8 on a one-layer chain: the leader's reduction is the output.
        ((2100, 130), ["softmax"], 9, H100_SMS, 8, False),
    ],
    ids=["split8-wide-softmax", "split2-softmax-epilogue", "split1", "split1-two-ranges",
         "uint8-split2", "split8-one-layer"],
)
def test_chain_schedule_emulated_matches_plain_and_jax(sizes, acts, rows, sm_count, split, u8):
    jparams = _jax_params(sizes, acts, seed=len(sizes) + rows)
    rng = np.random.default_rng(rows)
    if u8:
        x = rng.integers(0, 256, (rows, sizes[0])).astype(np.uint8)
        scale = 1.0 / 255.0
    else:
        x = rng.normal(size=(rows, sizes[0])).astype(np.float32)
        scale = None
    params = params_from_jax(jparams, device="cpu")
    got, plan = _emulate_chain(params, torch.from_numpy(x), acts, scale, sm_count)
    assert plan.split == split
    assert plan.split in (1, len(k_ranges(sizes[0])))
    want = fcnn_fused_forward_plain(params, torch.from_numpy(x), activations=acts,
                                    input_scale=scale)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=1e-4)
    jax_out = np.asarray(jax_fcnn_fused_forward(jparams, jnp.asarray(x), block_b=16,
                                                activations=acts, input_scale=scale))
    np.testing.assert_allclose(got.numpy(), jax_out, atol=2e-5, rtol=1e-4)


def test_k_ranges_cover_k_once_in_whole_slices():
    for K, n in ((1, 1), (31, 1), (784, 1), (960, 1), (961, 2), (1984, 2), (1985, 8),
                 (2048, 8), (60000, 8)):
        ranges = k_ranges(K)
        assert len(ranges) == n
        assert ranges[0][0] == 0 and ranges[-1][1] == K
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(kb % BK == 0 or kb == ke == K for kb, ke in ranges)
    assert [w for _, w in column_passes(10)] == [16]
    assert [w for _, w in column_passes(64)] == [64]
    assert column_passes(130) == [(0, 128), (128, 16)]
    assert column_passes(130, first_layer=False) == [(0, 64), (64, 64), (128, 16)]


@pytest.mark.parametrize(
    "dims,acts,M",
    [([784, 128, 64, 10], ["relu", "relu", "softmax"], 8192),   # the flagship
     ([2048, 64, 10], ["relu", "softmax"], 1024)],              # the conv tail
    ids=["flagship", "conv-tail"],
)
def test_chain_plan_fills_the_sms(dims, acts, M):
    plan = chain_plan(dims, activation_ids(acts), M, H100_SMS)
    ctas = -(-M // plan.tm) * plan.split
    assert 120 <= ctas <= H100_SMS
    assert plan.split in (1, 2, 4, 8)
    assert plan.smem_bytes <= SMEM_LIMIT_BYTES


def test_chain_plan_split_never_exceeds_eight():
    for M in (1, 7, 100, 1000, 8192):
        for K in (32, 1000, 100000):
            plan = chain_plan([K, 16, 4], (1, 0), M, H100_SMS)
            assert plan.split <= 8
            assert plan.split in (1, len(k_ranges(K)))  # one CTA a K range


def test_dense_plan_one_wave_at_the_flagship():
    tm, tn = dense_plan(8192, 128, H100_SMS)
    assert (tm, 16 * tn) == (64, 128)  # 128 CTAs of 64 x 128
    assert dense_plan(8192, 10, H100_SMS)[1] == 1  # a 16-column tile for 10 columns


def test_fused_chain_rejects_bad_inputs():
    params = params_from_jax(_jax_params((6, 4, 2), ["relu", "softmax"]), device="cpu")
    with pytest.raises(InvalidArgumentError, match="dtype"):
        fcnn_fused_forward(params, torch.zeros(3, 6, dtype=torch.float64))
    with pytest.raises(InvalidArgumentError, match="shape mismatch"):
        fcnn_fused_forward(params, torch.zeros(3, 5))
    with pytest.raises(InvalidArgumentError, match="need 2 activations"):
        fcnn_fused_forward(params, torch.zeros(3, 6), activations=["relu"])
    with pytest.raises(InvalidArgumentError, match="layers"):
        fcnn_fused_forward([], torch.zeros(3, 6))


# ------------------------------------------------------------- int8 chain

def test_quantize_fcnn_codes_and_scales_bit_equal_to_jax():
    jparams = _jax_params((24, 32, 16, 4), None)
    jq = jax_q.quantize_fcnn(jparams)
    q = quantize_fcnn(params_from_jax(jparams, device="cpu"))
    for p, jp in zip(q, jq):
        assert p["wq"].dtype == torch.int8
        np.testing.assert_array_equal(p["wq"].numpy(), np.asarray(jp["wq"]))
        np.testing.assert_array_equal(p["scale"].numpy(), np.asarray(jp["scale"]))
        np.testing.assert_array_equal(p["b"].numpy(), np.asarray(jp["b"]))
        assert p["act"] == int(jp["act"])


@pytest.mark.parametrize(
    "acts,atol,rtol",
    [
        # Exact arithmetic on both sides (relu/linear interiors): the
        # tolerance of tests/test_quantized.py's kernel-vs-jnp check.
        (["relu", "relu", "softmax"], 1e-7, 1e-6),
        (["linear", "relu", "softmax"], 1e-7, 1e-6),
        (["relu", "linear", "linear"], 1e-7, 1e-6),
        # sigmoid/tanh/gelu differ between torch and XLA by ulps; one ulp
        # can move the next layer's int8 code by one step.
        (["sigmoid", "tanh", "softmax"], 1e-2, 0.0),
        (["gelu", "gelu", "softmax"], 1e-2, 0.0),
    ],
    ids=["relu", "linear-first", "linear-head", "sigmoid-tanh", "gelu"],
)
def test_forward_quantized_matches_jax_pallas_chain(acts, atol, rtol):
    jparams = _jax_params((24, 32, 16, 4), acts)
    x = np.random.default_rng(0).uniform(0, 1, (100, 24)).astype(np.float32)
    # prefer_kernel=True: the Pallas chain (interpret mode here), not the
    # JAX package's width-gated jnp path.
    want = np.asarray(jax_q.fcnn_quantized_forward(
        jax_q.quantize_fcnn(jparams), jnp.asarray(x), block_b=32, prefer_kernel=True))
    q = quantize_fcnn(params_from_jax(jparams, device="cpu"))
    got = forward_quantized(q, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    wrapped = fcnn_quantized_forward(q, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(wrapped, got)


def test_quantized_forward_close_to_f32_and_prefer_kernel_false():
    jparams = _jax_params((24, 32, 16, 4), None, seed=5)
    params = params_from_jax(jparams, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (64, 24)).astype(np.float32))
    q = quantize_fcnn(params)
    got = fcnn_quantized_forward(q, x, prefer_kernel=False)
    ref = forward(params, x)
    assert float((got - ref).abs().max()) < 2e-2
    assert torch.equal(got.argmax(-1), ref.argmax(-1))


def test_quantized_chain_rejects_bad_inputs():
    q = quantize_fcnn(params_from_jax(_jax_params((6, 4, 2), None), device="cpu"))
    with pytest.raises(InvalidArgumentError, match="dtype"):
        fcnn_quantized_forward(q, torch.zeros(3, 6, dtype=torch.float64))
    with pytest.raises(InvalidArgumentError, match="shape mismatch"):
        fcnn_quantized_forward(q, torch.zeros(3, 7))
    bad = [dict(q[0], wq=q[0]["wq"].to(torch.int32)), q[1]]
    with pytest.raises(InvalidArgumentError, match="dtype"):
        fcnn_quantized_forward(bad, torch.zeros(3, 6))


def test_cpu_tensors_never_count_a_launch():
    reset_launch_counts()
    params = params_from_jax(_jax_params((6, 4, 2), None), device="cpu")
    x = torch.rand(5, 6)
    fused_dense(x, params[0]["w"], params[0]["b"], activation="relu")
    fcnn_fused_forward(params, x)
    fcnn_quantized_forward(quantize_fcnn(params), x)
    assert [fn.launches for fn in KERNEL_WRAPPERS] == [0] * len(KERNEL_WRAPPERS)



# ------------------------------------- the int8 chain's tensor-core schedule

def _mma_m16n8k32(a_regs, b_regs):
    """One ``mma.sync.m16n8k32.row.col.s32.s8.s8.s32`` as the PTX ISA
    defines its fragments: lane 4g + t holds A bytes (row g, 8 more for
    registers 1 and 3; k 4t + q, 16 more for registers 2 and 3), B bytes
    (k 4t + q, 16 more for register 1; column g) and returns C elements
    (row g, 8 more for e >= 2; column 2t + e % 2). a_regs (32, 4, 4),
    b_regs (32, 2, 4) int64 -> (32, 4) int64."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for reg in range(4):
        for q in range(4):
            A[g + 8 * (reg & 1), 4 * t + q + 16 * (reg >> 1)] = a_regs[:, reg, q]
    for reg in range(2):
        for q in range(4):
            B[4 * t + q + 16 * reg, g] = b_regs[:, reg, q]
    D = A @ B
    return np.stack([D[g + 8 * (e >> 1), 2 * t + (e & 1)] for e in range(4)], axis=1)


def _quantize_rows_f32(h):
    s = torch.clamp_min(h.abs().amax(dim=1, keepdim=True), 1e-8)
    s = s / torch.full_like(s, 127.0)
    return torch.clamp(torch.round(h / s), -127, 127).to(torch.int64), s


def _emulate_int8_chain(qparams, x, sm_count=H100_SMS, lane_perturb=0):
    """``csrc/int8_chain.cu``'s loop in integer arithmetic: the planner's
    row tile, each layer's row scales and codes (layer 0 in ``kc``-wide
    chunks past the resident width), per 64-deep slice and 128-column
    pass each warp's A fragments read from the codes at the kernel's
    offsets and its B fragments from ``wq_packed`` at ``8 * lane``
    (``lane_perturb`` moves that by whole lanes), the MMA, and the
    epilogue's rescale at each C element's row and column."""
    dims = [int(x.shape[1])] + [int(p["wq"].shape[1]) for p in qparams]
    M = int(x.shape[0])
    plan = int8_plan(dims, M, sm_count)
    tm, kc = plan.tm, plan.kc
    wm_count = tm // 16
    wn_count = 8 // wm_count
    nt_warp = 16 // wn_count
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    out = torch.empty((M, dims[-1]), dtype=torch.float32)
    for row0 in range(0, M, tm):
        rows = min(tm, M - row0)
        h = x[row0:row0 + rows].to(torch.float32)
        for layer, p in enumerate(qparams):
            din, dout = dims[layer], dims[layer + 1]
            q, s = _quantize_rows_f32(h)
            codes_all = np.zeros((tm, -(-din // 64) * 64), np.int64)
            codes_all[:rows, :din] = q.numpy()
            span = kc if layer == 0 and din > kc else din
            packed = p["wq_packed"].numpy().astype(np.int64)
            n8 = -(-dout // 8)
            z = np.zeros((tm, n8 * 8), np.int64)
            for j0 in range(0, n8, 16):
                nt = min(16, n8 - j0)
                for kb in range(0, din, span):
                    ke = min(din, kb + span)
                    codes = codes_all[:, kb:kb + -(-span // 64) * 64]  # the chunk's codes
                    for k in range(kb, -(-ke // 64) * 64, 32):
                        step = k // 32
                        col = k - kb + 4 * t
                        for w in range(8):
                            m0, wn = 16 * (w % wm_count), w // wm_count
                            a = np.zeros((32, 4, 4), np.int64)
                            for r in range(4):
                                for qq in range(4):
                                    a[:, r, qq] = codes[m0 + g + 8 * (r & 1),
                                                        col + 16 * (r >> 1) + qq]
                            for i in range(nt_warp):
                                jl = wn * nt_warp + i
                                if jl >= nt:
                                    continue
                                base = (step * n8 + j0 + jl) * 256
                                src = 8 * ((lane + lane_perturb) % 32)
                                b = np.stack([packed[base + src[:, None] + 4 * r + np.arange(4)]
                                              for r in range(2)], axis=1)
                                c = _mma_m16n8k32(a, b)
                                for e in range(4):
                                    z[m0 + g + 8 * (e >> 1), 8 * (j0 + jl) + 2 * t + (e & 1)] += c[:, e]
            zf = torch.from_numpy(z[:rows, :dout]).to(torch.float32)
            y = zf * (s * p["scale"][None, :]) + p["b"]
            h = _act(y, p["act"]) if p["act"] != 3 else torch.softmax(y, dim=-1)
        out[row0:row0 + rows] = h
    return out, plan


@pytest.mark.parametrize(
    "sizes,acts,rows",
    [((784, 128, 64, 10), ["relu", "relu", "softmax"], 40),   # the flagship, 3 tiles
     ((200, 300, 33, 5), ["relu", "linear", "linear"], 17),   # 3 column passes, ragged K and N
     ((1100, 20, 5), ["relu", "linear"], 9)],                 # input read twice, 2 chunks
    ids=["flagship", "passes", "two-pass-input"],
)
def test_int8_schedule_emulated_matches_plain_and_jax_bit_for_bit(sizes, acts, rows):
    jparams = _jax_params(sizes, acts, seed=rows)
    x = np.random.default_rng(rows).uniform(0, 1, (rows, sizes[0])).astype(np.float32)
    q = quantize_fcnn(params_from_jax(jparams, device="cpu"))
    for p in q:
        assert torch.equal(unpack_wq(p["wq_packed"], *p["wq"].shape), p["wq"])
    got, plan = _emulate_int8_chain(q, torch.from_numpy(x), sm_count=2)
    want = forward_quantized(q, torch.from_numpy(x))
    assert torch.equal(got, want)
    jax_out = np.asarray(jax_q.fcnn_quantized_forward(
        jax_q.quantize_fcnn(jparams), jnp.asarray(x), block_b=32, prefer_kernel=True))
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=1e-6, atol=1e-7)
    # A lane reading its neighbour's 8 bytes of B is caught.
    bad, _ = _emulate_int8_chain(q, torch.from_numpy(x), sm_count=2, lane_perturb=1)
    assert not torch.equal(bad, want)


def test_int8_schedule_chunks_a_wide_input():
    # 2500 columns > kc = 1024: layer 0's codes are made and multiplied
    # 1024 columns at a time, the row scale from the whole row.
    rng = np.random.default_rng(11)
    params = [{"w": torch.from_numpy((rng.normal(size=(2500, 12)) * 0.05).astype(np.float32)),
               "b": torch.from_numpy(rng.normal(size=12).astype(np.float32)), "act": 1},
              {"w": torch.from_numpy((rng.normal(size=(12, 3)) * 0.3).astype(np.float32)),
               "b": torch.zeros(3), "act": 0}]
    q = quantize_fcnn(params)
    x = torch.from_numpy(rng.uniform(0, 1, (5, 2500)).astype(np.float32))
    got, plan = _emulate_int8_chain(q, x)
    assert plan.kc == 1024
    assert torch.equal(got, forward_quantized(q, x))
    assert torch.equal(fcnn_quantized_forward(q, x), got)
