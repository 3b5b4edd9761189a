"""The port's CUDA kernels on the card, against their plain versions.

Every test takes the ``cuda`` fixture and skips without a GPU. The
module imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them::

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: ``tests/conftest.py`` configures JAX.) Shapes here
are odd on purpose: ragged tiles, widths that are not multiples of 4,
more than one 128-column pass, split-K clusters, and convs
with 1, 3 or 5 input channels, 1 or 33 filters, ragged row bands and a
batch of one; attention at T of 1, 17, 77, 130 and 1000 (ragged 64-row
blocks), head dims 8 to 128, keys past a ``seq_len``, and q, k, v read
as strided views of one fused projection, on both routes: float32
through the 3xTF32 kernels called by name, bfloat16 through the routed
entries onto the sm90 tensor-core kernels (head dims 32, 64 and 128,
ragged 128-row tiles); and the float32 LM, 3 steps with the kernels
against the materialised attention on the card; the Process handler and batcher
in front of the card's engines (coalesced replies bit-equal to each
request alone), and uint8 rows through the dense engine; training's
eval through the chain kernel, and the int8 warm-up gate's launches.
``chip_smoke.py`` covers the main path's shapes.
"""

import numpy as np
import pytest
import torch

from tpu_dist_nn_torch.api.engine import Engine
from tpu_dist_nn_torch.core.schema import LayerSpec, ModelSpec
from tpu_dist_nn_torch.kernels import (
    KERNEL_WRAPPERS,
    fused_conv2d,
    fused_conv2d_plain,
    fcnn_fused_forward,
    fcnn_fused_forward_plain,
    fcnn_quantized_forward,
    forward_quantized,
    flash_bwd,
    flash_bwd_f32,
    flash_bwd_plain,
    flash_bwd_sm90,
    flash_fwd,
    flash_fwd_f32,
    flash_fwd_plain,
    flash_fwd_sm90,
    fused_dense,
    fused_dense_plain,
    quantize_fcnn,
    reset_launch_counts,
)
from tpu_dist_nn_torch.kernels.conv2d import conv_plan
from tpu_dist_nn_torch.kernels.flash_attention import bf16_rounding_bounds
from tpu_dist_nn_torch.models.fcnn import params_from_spec
from tpu_dist_nn_torch.models.network import init_conv_mlp
from tpu_dist_nn_torch.kernels.flash_attention import flash_attention
from tpu_dist_nn_torch.models.transformer import (
    TransformerConfig,
    dot_product_attention,
    init_transformer,
    tree_map,
)
from tpu_dist_nn_torch.train.lm_trainer import LMTrainConfig, train_lm
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

ACTIVATIONS = ["linear", "relu", "sigmoid", "tanh", "gelu", "softmax"]


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    # The int8 warm-up gate measures and warns only: the int8 engine
    # tests hold the int8 kernel itself (the gate has its own test).
    monkeypatch.setenv("TDN_INT8_AUTO", "0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(sizes, acts, seed=0):
    rng = np.random.default_rng(seed)
    return ModelSpec([
        LayerSpec(rng.normal(0, (2.0 / sizes[i]) ** 0.5, (sizes[i], sizes[i + 1])),
                  rng.normal(0, 0.05, (sizes[i + 1],)), act)
        for i, act in enumerate(acts)
    ])


def _rows(n, d, device, seed=1):
    return torch.from_numpy(
        np.random.default_rng(seed).uniform(0, 1, (n, d)).astype(np.float32)).to(device)


def test_fused_dense_matches_plain_on_the_card(cuda):
    reset_launch_counts()
    rng = np.random.default_rng(3)
    x, w, b = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
        rng.normal(size=(300, 70)), rng.normal(size=(70, 130)) * 0.1, rng.normal(size=130)))
    for act in ACTIVATIONS:
        torch.testing.assert_close(fused_dense(x, w, b, activation=act),
                                   fused_dense_plain(x, w, b, act), atol=1e-5, rtol=1e-5)
    assert fused_dense.launches == len(ACTIVATIONS)


@pytest.mark.parametrize(
    "sizes,acts",
    [([70, 300, 33, 5], ["relu", "gelu", "softmax"]),   # 3 column passes, ragged K
     ([3000, 3000, 10], ["tanh", "softmax"]),           # 8-row tiles
     ([20000, 8, 4], ["sigmoid", "linear"])],           # 2-row tiles
    ids=["passes", "tm8", "tm2"],
)
def test_fused_chain_matches_plain_on_the_card(cuda, sizes, acts):
    params = params_from_spec(_model(sizes, acts), device=cuda)
    x = _rows(37, sizes[0], cuda)
    torch.testing.assert_close(fcnn_fused_forward(params, x),
                               fcnn_fused_forward_plain(params, x), atol=2e-5, rtol=1e-4)
    xu8 = (x * 255).to(torch.uint8)
    torch.testing.assert_close(
        fcnn_fused_forward(params, xu8, input_scale=1 / 255),
        fcnn_fused_forward_plain(params, xu8, input_scale=1 / 255), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("M,K,N", [(1000, 300, 128), (8191, 784, 128), (77, 33, 300)],
                         ids=["full-tile", "flagship-ragged-M", "softmax-past-the-tile"])
def test_fused_dense_tiles_match_plain_on_the_card(cuda, M, K, N):
    # A full 128-column tile (softmax in registers), and N = 300 wider
    # than one tile (softmax as a second pass over the stored rows).
    rng = np.random.default_rng(M)
    x, w, b = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
        rng.normal(size=(M, K)), rng.normal(size=(K, N)) * 0.1, rng.normal(size=N)))
    for act in ACTIVATIONS:
        torch.testing.assert_close(fused_dense(x, w, b, activation=act),
                                   fused_dense_plain(x, w, b, act), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "sizes,acts,M",
    [([2048, 64, 10], ["relu", "softmax"], 37),       # split 8, one row tile
     ([2048, 64, 10], ["relu", "softmax"], 1024),     # the conv tail: 16 tiles x 8
     ([300, 200, 150], ["tanh", "softmax"], 70)],     # split 8, ragged K, wide softmax
    ids=["split-37", "conv-tail", "split-wide-softmax"],
)
def test_fused_chain_split_k_matches_plain_and_repeats_bit_for_bit(cuda, sizes, acts, M):
    params = params_from_spec(_model(sizes, acts), device=cuda)
    x = _rows(M, sizes[0], cuda)
    got = fcnn_fused_forward(params, x)
    torch.testing.assert_close(got, fcnn_fused_forward_plain(params, x), atol=2e-5, rtol=1e-4)
    assert torch.equal(got, fcnn_fused_forward(params, x))  # fixed-order reduction
    # A row's bits do not depend on its batch: 5 rows alone (another
    # plan) give the rows of the whole batch.
    assert torch.equal(fcnn_fused_forward(params, x[:5].contiguous()), got[:5])
    xu8 = (x * 255).to(torch.uint8)
    torch.testing.assert_close(
        fcnn_fused_forward(params, xu8, input_scale=1 / 255),
        fcnn_fused_forward_plain(params, xu8, input_scale=1 / 255), atol=2e-5, rtol=1e-4)


def test_fused_chain_takes_a_60000_wide_input_on_the_card(cuda):
    params = params_from_spec(_model([60000, 16, 4], ["relu", "softmax"]), device=cuda)
    x = _rows(5, 60000, cuda)
    torch.testing.assert_close(fcnn_fused_forward(params, x),
                               fcnn_fused_forward_plain(params, x), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize(
    "sizes,acts",
    [([70, 300, 33, 5], ["relu", "linear", "softmax"]),
     ([3000, 2000, 10], ["relu", "softmax"]),
     ([1023, 1], ["linear"])],
    ids=["passes", "wide", "one-column"],
)
def test_int8_chain_matches_plain_bit_for_bit_on_the_card(cuda, sizes, acts):
    q = quantize_fcnn(params_from_spec(_model(sizes, acts), device=cuda))
    x = _rows(45, sizes[0], cuda)
    got, want = fcnn_quantized_forward(q, x), forward_quantized(q, x)
    torch.testing.assert_close(got, want, atol=1e-7, rtol=1e-6)
    if acts[-1] != "softmax":
        assert torch.equal(got, want)


@pytest.mark.parametrize("quantize,atol,rtol", [(None, 1e-5, 1e-5), ("int8", 1e-7, 1e-6)])
def test_engine_on_the_card_matches_the_cpu_engine(cuda, quantize, atol, rtol):
    model = _model([784, 128, 64, 10], ["relu", "relu", "softmax"])
    x = np.random.default_rng(2).uniform(0, 1, (1000, 784))
    reset_launch_counts()
    gpu = Engine.up(model, [1, 1, 1], quantize=quantize)
    got = gpu.run_inference(x, batch_size=256).outputs
    want = Engine.up(model, device="cpu", quantize=quantize).run_inference(x).outputs
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    chain = "fcnn_quantized_forward" if quantize else "fcnn_fused_forward"
    # warm-up, the int8 gate's int8 arm at warm-up (one warm call and
    # best of 3) on a quantized engine, 4 batches
    assert counts[chain] == 1 + (4 if quantize else 0) + 4
    a, b = gpu.infer_async(x[:3]), gpu.infer_async(x[3:10])
    np.testing.assert_array_equal(gpu.fetch(b), got[3:10])
    np.testing.assert_array_equal(gpu.fetch(a), got[:3])


def test_kernels_raise_on_mixed_devices(cuda):
    x = torch.zeros(8, 12, device=cuda)
    with pytest.raises(InvalidArgumentError, match="is on"):
        fused_dense(x, torch.zeros(12, 6), torch.zeros(6, device=cuda))
    params = params_from_spec(_model([12, 4], ["relu"]), device="cpu")
    with pytest.raises(InvalidArgumentError, match="is on"):
        fcnn_fused_forward(params, x)


@pytest.mark.parametrize(
    "B,H,W,cin,k,cout,kw",
    [(1, 13, 11, 1, 3, 1, dict(padding="same", pool_window=(2, 2))),
     (3, 17, 19, 3, 3, 33, dict(padding="same", pool_window=(2, 2))),
     (2, 15, 9, 5, 4, 33, dict(padding="same", activation="softmax")),
     (4, 21, 23, 5, 3, 8, dict(padding="valid", pool_window=(3, 3), pool_stride=(2, 2))),
     (1, 31, 29, 3, 2, 1, dict(padding="same", stride=(2, 2), activation="gelu")),
     (2, 62, 61, 3, 3, 16, dict(padding="same", activation="sigmoid", pool_window=(2, 2)))],
    ids=["cin1-cout1-b1", "cout33", "k4-softmax", "pool3s2", "stride2-b1", "ragged-bands"],
)
def test_fused_conv2d_matches_plain_on_the_card(cuda, B, H, W, cin, k, cout, kw):
    rng = np.random.default_rng(4)
    imgs, w, b = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
        rng.uniform(0, 1, (B, H, W, cin)), rng.normal(0, (2 / (k * k * cin)) ** 0.5,
                                                      (k, k, cin, cout)),
        rng.normal(0, 0.05, cout)))
    kw = {"activation": "relu", **kw}
    plan = conv_plan(imgs.shape, w.shape, kw.get("stride", (1, 1)), kw["padding"],
                     kw.get("pool_window"), kw.get("pool_stride"))
    if H == 62:
        assert plan.out_shape[1] % plan.tile[0] != 0  # the last row tile is ragged
    reset_launch_counts()
    got = fused_conv2d(imgs, w, b, **kw)
    torch.testing.assert_close(got, fused_conv2d_plain(imgs, w, b, **kw), atol=1e-5, rtol=2e-5)
    assert fused_conv2d.launches == 1


def test_conv_engine_on_the_card_matches_the_cpu_engine(cuda):
    model = init_conv_mlp(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    for layer in model.layers:
        if layer.kind != "maxpool2d":
            layer.biases = rng.normal(0, 0.05, layer.biases.shape)
    x = rng.uniform(0, 1, (700, model.input_dim))
    reset_launch_counts()
    gpu = Engine.up(model, [2, 2, 2])
    got = gpu.run_inference(x, batch_size=256).outputs
    want = Engine.up(model, device="cpu").run_inference(x).outputs
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    assert counts["fused_conv2d"] == 2 * (1 + 3)  # warm-up + 3 batches, 2 convs each
    assert counts["fcnn_fused_forward"] == 1 + 3
    with pytest.raises(InvalidArgumentError, match="is on"):
        fused_conv2d(torch.zeros(1, 4, 4, 1, device=cuda), torch.zeros(3, 3, 1, 2),
                     torch.zeros(2, device=cuda))


@pytest.mark.parametrize(
    "shape,w_shape,kw",
    [((1, 64, 64, 256), (3, 3, 256, 256), dict(padding="same")),
     ((1, 3, 32, 1024), (3, 3, 1024, 1), dict(padding="same")),
     ((1023, 32, 32, 3), (3, 3, 3, 16), dict(padding="same", pool_window=(2, 2))),
     ((3, 31, 29, 3), (3, 3, 3, 16), dict(padding="same", pool_window=(3, 3), pool_stride=(2, 2))),
     ((5, 16, 16, 16), (3, 3, 16, 32), dict(padding="valid", stride=(2, 2))),
     ((7, 16, 16, 16), (3, 3, 16, 32), dict(padding="same", activation="softmax",
                                            pool_window=(2, 2)))],
    ids=["wide-cin256-cout256", "cin1024-cout1", "batch1023", "odd-overlapping-pool",
         "stride2-valid", "softmax-32"],
)
def test_fused_conv2d_implicit_gemm_matches_plain_on_the_card(cuda, shape, w_shape, kw):
    # The first two the band planner refused (one band row over 227 KB).
    rng = np.random.default_rng(6)
    k = w_shape[0] * w_shape[1] * w_shape[2]
    imgs, w, b = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
        rng.uniform(0, 1, shape), rng.normal(0, (2 / k) ** 0.5, w_shape),
        rng.normal(0, 0.05, w_shape[3])))
    kw = {"activation": "relu", **kw}
    reset_launch_counts()
    got = fused_conv2d(imgs, w, b, **kw)
    torch.testing.assert_close(got, fused_conv2d_plain(imgs, w, b, **kw), atol=1e-5, rtol=2e-5)
    assert fused_conv2d.launches == 1
    assert torch.equal(got, fused_conv2d(imgs, w, b, **kw))


@pytest.mark.parametrize(
    "sizes,acts,M",
    [([784, 128, 64, 10], ["relu", "relu", "softmax"], 8191),   # 32-row tiles, ragged
     ([784, 128, 64, 10], ["relu", "relu", "softmax"], 37),     # 16-row tiles
     ([784, 128, 64, 10], ["relu", "linear", "linear"], 20000),  # 64-row tiles, persistent
     ([2500, 40, 3], ["relu", "linear"], 70),                   # input in 1024-column chunks
     ([60000, 16, 10], ["relu", "softmax"], 9),                 # a 60000-wide input
     ([64, 300, 1000], ["linear", "softmax"], 33)],             # softmax over device memory
    ids=["8191", "37", "20000-tm64", "chunks", "60000-input", "wide-softmax"],
)
def test_int8_tensor_core_chain_bit_equal_on_the_card(cuda, sizes, acts, M):
    q = quantize_fcnn(params_from_spec(_model(sizes, acts), device=cuda))
    x = _rows(M, sizes[0], cuda)
    got, want = fcnn_quantized_forward(q, x), forward_quantized(q, x)
    torch.testing.assert_close(got, want, atol=1e-7, rtol=1e-6)
    if acts[-1] != "softmax":
        assert torch.equal(got, want)
    assert torch.equal(got, fcnn_quantized_forward(q, x))


@pytest.mark.parametrize(
    "sizes,quantize,chain_launches",
    [([16] * 35, None, 2), ([16] * 35, "int8", 2),
     ([784, 4000, 10], None, 2), ([64, 8192, 10], None, 2),
     ([60000, 16, 10], "int8", 1), ([64, 60000, 10], "int8", 2)],
    ids=["34-layers-f32", "34-layers-int8", "784-4000-10", "64-8192-10", "60000-16-10-int8",
         "64-60000-10-int8"],
)
def test_engine_serves_past_one_chain_on_the_card(cuda, sizes, quantize, chain_launches):
    model = _model(sizes, ["relu"] * (len(sizes) - 2) + ["softmax"])
    x = np.random.default_rng(7).uniform(0, 1, (40, sizes[0]))
    gpu = Engine.up(model, quantize=quantize)
    reset_launch_counts()
    got = gpu.run_inference(x, batch_size=20).outputs
    want = Engine.up(model, device="cpu", quantize=quantize).run_inference(x).outputs
    if quantize:
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-6)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    chain = "fcnn_quantized_forward" if quantize else "fcnn_fused_forward"
    assert counts[chain] == 2 * chain_launches  # 2 batches


# bf16 outputs round to nearest even: at most 2**-8 of the value away
# from the float32 plain version run on the same bf16 inputs, on top of
# the float32 tolerance (the JAX package's: 2e-5 forward, 2e-4 grads).
BF16_RTOL = 2.0**-8


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
@pytest.mark.parametrize(
    "T,Dh,seq_len",
    [(1, 8, None), (17, 16, None), (130, 64, 100), (1000, 32, None), (17, 64, None),
     (1000, 128, 999), (77, 33, 70)],
    ids=["T1-Dh8", "T17-Dh16", "T130-Dh64-seq100", "T1000-Dh32", "T17-Dh64", "T1000-Dh128",
         "T77-Dh33-seq70"],
)
def test_flash_kernels_match_plain_on_the_card(cuda, T, Dh, seq_len, causal):
    # float32 through the 3xTF32 kernels, called by name (Dh 33: rows
    # not 16-byte aligned, so the 4-byte copies, and an odd dq row for
    # the scalar atomics). Tolerances: the
    # float32 ones of tests/test_flash_attention.py (2e-5 forward, 2e-4
    # gradients); dq is summed with atomics, so it is not compared bit for
    # bit with a second call.
    B, H = 2, 3
    rng = np.random.default_rng(T + Dh)
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * H, Dh)).astype(np.float32)).to(cuda)
    q, k, v = qkv.split(H, dim=2)  # strided views, as the transformer passes them
    do = torch.from_numpy(rng.standard_normal((B, T, H, Dh)).astype(np.float32)).to(cuda)
    scale = 1.0 / np.sqrt(Dh)
    kw = dict(causal=causal, seq_len=seq_len)
    reset_launch_counts()
    o, lse = flash_fwd_f32(q, k, v, **kw)
    o_ref, lse_ref = flash_fwd_plain(q, k, v, scale=scale, **kw)
    assert o.dtype == torch.float32 and o.is_contiguous()
    torch.testing.assert_close(o, o_ref, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=2e-5)
    delta = (do * o_ref).sum(-1).transpose(1, 2).contiguous()
    grads = flash_bwd_f32(q, k, v, do, lse_ref, delta, **kw)
    refs = flash_bwd_plain(q, k, v, do, lse_ref, delta, scale=scale, **kw)
    for got, want in zip(grads, refs):
        assert got.dtype == torch.float32 and got.is_contiguous()
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
    assert (flash_fwd_f32.launches, flash_bwd_f32.launches) == (1, 1)
    assert flash_fwd_sm90.launches == flash_bwd_sm90.launches == 0


def _assert_within(got, want, bound, atol, rtol):
    """|got - want| <= atol + rtol |want| + bound, element by element."""
    err = (got.float() - want).abs() - (atol + rtol * want.abs() + bound)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float(err.max()) <= 0.0, f"over the stated tolerance by {float(err.max()):.3e}"


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
@pytest.mark.parametrize(
    "T,Dh,seq_len",
    [(1, 64, None), (17, 32, None), (130, 64, 100), (129, 128, None), (1000, 32, None),
     (1000, 64, 999), (1000, 128, None)],
    ids=["T1-Dh64", "T17-Dh32", "T130-Dh64-seq100", "T129-Dh128", "T1000-Dh32",
         "T1000-Dh64-seq999", "T1000-Dh128"],
)
def test_sm90_flash_kernels_match_plain_on_the_card(cuda, T, Dh, seq_len, causal):
    # bf16 through the routed entries: the sm90 forward and the fused
    # backward, never the f32 kernels. Tolerance: the float32 one plus
    # 2**-8 for the output's rounding, plus the bound on the kernels'
    # bf16 rounding of P and dS (bf16_rounding_bounds).
    B, H = 2, 3
    rng = np.random.default_rng(T + Dh + 1)
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * H, Dh)).astype(np.float32))
    q, k, v = qkv.to(cuda, torch.bfloat16).split(H, dim=2)
    do = torch.from_numpy(rng.standard_normal((B, T, H, Dh)).astype(np.float32))
    do = do.to(cuda, torch.bfloat16)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    scale = 1.0 / np.sqrt(Dh)
    kw = dict(causal=causal, seq_len=seq_len)
    reset_launch_counts()
    o, lse = flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = flash_fwd_plain(qf, kf, vf, scale=scale, **kw)
    delta = (dof * o_ref).sum(-1).transpose(1, 2).contiguous()
    b_o, b_dq, b_dk, b_dv = bf16_rounding_bounds(qf, kf, vf, dof, lse_ref, delta, scale=scale,
                                                 **kw)
    assert o.dtype == torch.bfloat16 and o.is_contiguous()
    _assert_within(o, o_ref, b_o, 2e-5, 2e-5 + BF16_RTOL)
    torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=2e-5)
    dq, dk, dv = flash_bwd(q, k, v, do, lse_ref, delta, **kw)
    refs = flash_bwd_plain(qf, kf, vf, dof, lse_ref, delta, scale=scale, **kw)
    for got, want, bound in zip((dq, dk, dv), refs, (b_dq, b_dk, b_dv)):
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        _assert_within(got, want, bound, 2e-4, 2e-4 + BF16_RTOL)
    launches = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    assert launches["flash_fwd_sm90"] == 1 and launches["flash_bwd_sm90"] == 1
    assert launches["flash_fwd_f32"] == launches["flash_bwd_f32"] == 0


def test_sm90_route_raises_on_what_it_does_not_take(cuda):
    # bf16 with a head dim outside (32, 64, 128), or a view whose token
    # stride is not a multiple of 16 bytes, raises and launches nothing;
    # float32 at the same head dim takes the f32 kernels.
    q = torch.zeros(1, 8, 2, 48, device=cuda, dtype=torch.bfloat16)
    reset_launch_counts()
    with pytest.raises(InvalidArgumentError, match="head dims"):
        flash_fwd(q, q, q, causal=True)
    with pytest.raises(InvalidArgumentError, match="head dims"):
        flash_fwd_sm90(q, q, q, causal=True)
    wide = torch.zeros(1, 8, 2 * 64 + 4, device=cuda, dtype=torch.bfloat16)
    odd = wide[:, :, : 2 * 64].unflatten(-1, (2, 64))  # token stride 264 bytes
    with pytest.raises(InvalidArgumentError, match="multiples of 16"):
        flash_fwd(odd, odd, odd, causal=True)
    o, _ = flash_fwd(q.float(), q.float(), q.float(), causal=True)
    assert o.dtype == torch.float32
    assert [fn.launches for fn in KERNEL_WRAPPERS if fn is not flash_fwd_f32] == [0] * 7
    assert flash_fwd_f32.launches == 1


def test_train_lm_step_on_the_card_matches_the_cpu(cuda):
    cfg = TransformerConfig(vocab_size=64, d_model=64, n_heads=2, n_layers=2, d_ff=128,
                            max_seq_len=80, remat=True)
    params = init_transformer(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = np.random.default_rng(0).integers(0, 64, (3, 81))
    train_cfg = LMTrainConfig(learning_rate=1e-3, steps=1, batch_size=3, seq_len=80)
    reset_launch_counts()
    got_params, got = train_lm(tree_map(lambda a: a.to(cuda), params), cfg, [batch],
                               train_cfg)
    want_params, want = train_lm(params, cfg, [batch], train_cfg)
    assert [h["step"] for h in got] == [1]
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=1e-5)
    # remat: the forward runs again in the backward; float32 takes the f32 route
    assert (flash_fwd_f32.launches, flash_bwd_f32.launches) == (4, 2)
    assert flash_fwd_sm90.launches == flash_bwd_sm90.launches == 0
    torch.testing.assert_close(got_params["tok_embed"].cpu(), want_params["tok_embed"],
                               atol=1e-5, rtol=0)



def test_float32_lm_trains_through_the_f32_kernels_like_the_materialised_attention(cuda):
    # tdn lm's default recipe widths (d 128, 4 heads of 32, T 128) at depth
    # 2 and batch 4: 3 float32 steps with the flash kernels and 3 with
    # dot_product_attention, both on the card, from the same weights and
    # batches. Losses within rtol 1e-5 (first) and 1e-4 (all three), as
    # chip_smoke.py's float32 parity twin.
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_heads=4, n_layers=2, d_ff=512,
                            max_seq_len=128)
    params = init_transformer(torch.Generator().manual_seed(0), cfg, device=cuda)
    batches = [np.random.default_rng(i).integers(0, 256, (4, 129)) for i in range(3)]
    train_cfg = LMTrainConfig(learning_rate=1e-3, steps=3, batch_size=4, seq_len=128,
                              log_every=1)
    reset_launch_counts()
    got = train_lm(params, cfg, batches, train_cfg, attn_fn=flash_attention)[1]
    assert (flash_fwd_f32.launches, flash_bwd_f32.launches) == (6, 6)
    assert flash_fwd_sm90.launches == flash_bwd_sm90.launches == 0
    want = train_lm(params, cfg, batches, train_cfg, attn_fn=dot_product_attention)[1]
    got, want = (np.array([h["loss"] for h in hist]) for hist in (got, want))
    assert len(got) == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["f32", "int8"])
def test_process_replies_are_bit_equal_to_each_request_alone_on_the_card(cuda, quantize):
    # The Process handler body and the batcher (depth 2) in front of the
    # card's engine: requests of 1-4096 rows coalesce into pow2 buckets
    # with zero tails, yet every reply has the bits of Engine.infer on
    # its rows alone (the chain's K ranges are fixed by K; int8 rows are
    # quantised alone). One chain launch per batch.
    import threading

    from tpu_dist_nn_torch.serving import Batcher, decode_matrix, encode_matrix
    from tpu_dist_nn_torch.serving import make_process_handler

    model = _model([784, 128, 64, 10], ["relu", "relu", "softmax"])
    eng = Engine.up(model, quantize=quantize)
    batcher = Batcher(eng, pipeline_depth=2)
    handle = make_process_handler(eng, batcher)
    sizes = [1, 7, 64, 512, 4096, 3, 100] * 2
    starts = np.cumsum([0] + sizes)
    rows = np.random.default_rng(3).uniform(0, 1, (int(starts[-1]), 784)).astype(np.float32)
    replies = [None] * len(sizes)

    def worker(k):
        for i in range(k, len(sizes), 5):
            replies[i] = handle(encode_matrix(rows[starts[i]:starts[i + 1]]))[0]

    reset_launch_counts()
    pool = [threading.Thread(target=worker, args=(k,)) for k in range(5)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(60)
    counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    batcher.close()
    chain = "fcnn_quantized_forward" if quantize else "fcnn_fused_forward"
    assert counts[chain] == batcher.batches_total < len(sizes)
    for i, reply in enumerate(replies):
        alone = eng.infer(rows[starts[i]:starts[i + 1]])
        np.testing.assert_array_equal(decode_matrix(reply), alone.astype(np.float64))


@pytest.mark.parametrize("sizes", [[784, 128, 64, 10], [784, 4000, 10], [16] * 35],
                         ids=["mnist", "784-4000-10", "34-layers"])
def test_engine_uint8_rows_match_float32_rows_on_the_card(cuda, sizes):
    # uint8 rows reach the chain kernel as they are (scale 1); where the
    # first segment is fused_dense they are cast on the card first.
    model = _model(sizes, ["relu"] * (len(sizes) - 2) + ["softmax"])
    eng = Engine.up(model)
    x = np.random.default_rng(8).integers(0, 256, (1000, sizes[0])).astype(np.uint8)
    for n in (1000, 37, 1):
        np.testing.assert_array_equal(eng.infer(x[:n]), eng.infer(x[:n].astype(np.float32)))


def test_trained_engine_evaluates_through_the_chain_kernel(cuda):
    # Engine.train on the card: the steps are plain autograd (no kernel
    # launch), each epoch's eval is one chain launch per 1024-row batch,
    # and its metrics are those of the plain forward's argmax.
    from tpu_dist_nn_torch.data.datasets import synthetic_mnist
    from tpu_dist_nn_torch.models.fcnn import forward
    from tpu_dist_nn_torch.train.metrics import classification_metrics
    from tpu_dist_nn_torch.train.trainer import TrainConfig, evaluate_fcnn

    data = synthetic_mnist(3000, num_classes=10, dim=784, seed=5)
    train, held = data.split(0.5, seed=0)
    eng = Engine.up(_model([784, 128, 64, 10], ["relu", "relu", "softmax"]))
    reset_launch_counts()
    hist = eng.train(train, TrainConfig(epochs=2, batch_size=64), eval_data=held)
    counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    assert counts == {k: (4 if k == "fcnn_fused_forward" else 0) for k in counts}
    assert hist[1]["loss"] < hist[0]["loss"]
    reset_launch_counts()
    got = evaluate_fcnn(eng._params, held)
    assert fcnn_fused_forward.launches == 2
    with torch.no_grad():
        plain = forward(eng._params, torch.from_numpy(held.x).to(cuda)).argmax(-1).cpu().numpy()
    assert got == classification_metrics(plain, held.y, 10) == hist[1]["eval"]


def test_int8_gate_launches_follow_its_decision_on_the_card(cuda, monkeypatch):
    # The gate on: its verdict at 1024 rows picks the chain that serves.
    monkeypatch.setenv("TDN_INT8_AUTO", "1")
    eng = Engine.up(_model([784, 128, 64, 10], ["relu", "relu", "softmax"]),
                    quantize="int8", warm_rows=1024)
    assert eng.int8_speedup_ratio > 0
    assert eng.int8_auto_disabled == (eng.int8_speedup_ratio < 1.0)
    reset_launch_counts()
    eng.run_inference(_rows(3000, 784, cuda).cpu().numpy(), batch_size=1024)
    kept = not eng.int8_auto_disabled
    assert fcnn_quantized_forward.launches == (3 if kept else 0)
    assert fcnn_fused_forward.launches == (0 if kept else 3)


# The layer-distribution pipeline on stage slots of one card:
# (distribution, microbatches, rows, virtual stages). Odd microbatch
# counts, an empty stage, a ragged last microbatch (rows not a multiple
# of the microbatches), fewer rows than microbatches, the interleaved
# table.
PIPELINE_CASES = {
    "odd-microbatches": ([1, 1, 1], 3, 999, 1),
    "empty-stage": ([1, 0, 2], 4, 1000, 1),
    "ragged-last-microbatch": ([2, 1], 4, 1001, 1),
    "fewer-rows-than-microbatches": ([1, 1, 1], 5, 3, 1),
    "interleaved": ([1, 1, 1, 0], 3, 997, 2),
}


@pytest.mark.parametrize("case", PIPELINE_CASES, ids=list(PIPELINE_CASES))
def test_pipeline_on_stage_slots_of_the_card(cuda, case):
    from tpu_dist_nn_torch.parallel.pipeline import split_rows

    dist, micro, rows, virtual = PIPELINE_CASES[case]
    model = _model([784, 128, 64, 10], ["relu", "relu", "softmax"])
    x = np.random.default_rng(9).uniform(0, 1, (rows, 784)).astype(np.float32)
    slots = ["cuda:0"] * (len(dist) // virtual)
    chunks = sum(1 for n in dist if n) * sum(r is not None for row in split_rows(rows, micro, 1)
                                             for r in row)
    for quantize in (None, "int8"):
        one = Engine.up(model, quantize=quantize)
        eng = Engine.up(model, dist, devices=slots, num_microbatches=micro,
                        virtual_stages=virtual, quantize=quantize)
        assert eng.placement()["pipelined"]
        reset_launch_counts()
        got = eng.infer(x)
        kname = "fcnn_quantized_forward" if quantize else "fcnn_fused_forward"
        launched = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
        assert launched[kname] == chunks, launched
        if quantize:
            np.testing.assert_array_equal(got, one.infer(x))
        else:
            np.testing.assert_allclose(got, one.infer(x), rtol=1e-5, atol=1e-6)
        # Several batches in flight at once, fetched after: bit-equal.
        pending = [eng.infer_async(x) for _ in range(4)]
        for p in pending:
            np.testing.assert_array_equal(eng.fetch(p), got)


def test_pipeline_training_schedules_agree_on_the_card(cuda):
    from tpu_dist_nn_torch.core.schema import partition_model
    from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
    from tpu_dist_nn_torch.parallel.pipeline import build_pipeline_params
    from tpu_dist_nn_torch.train.pipeline_trainer import (
        pipeline_loss_and_grad,
        prepare_pipeline_batch,
    )

    model = _model([64, 32, 16, 10], ["relu", "relu", "softmax"])
    rng = np.random.default_rng(10)
    x, y = rng.uniform(0, 1, (48, 64)).astype(np.float32), rng.integers(0, 10, 48)
    results = {}
    for sched, dist, v in (("gpipe", [1, 1, 1], 1), ("1f1b", [1, 1, 1], 1),
                           ("interleaved", [1, 1, 1, 0], 2)):
        pp = build_pipeline_params(partition_model(model, dist))
        stage = len(dist) // v
        mesh = build_mesh(MeshSpec(stage=stage, data=2), ["cuda:0"] * (2 * stage))
        batch = prepare_pipeline_batch(pp.meta, x, y, 3, 2)
        results[sched] = pipeline_loss_and_grad(mesh, pp, *batch, schedule=sched,
                                                num_microbatches=3, num_virtual=v)
        cpu_mesh = build_mesh(MeshSpec(stage=stage, data=2), ["cpu"] * (2 * stage))
        loss_cpu, g_cpu = pipeline_loss_and_grad(cpu_mesh, pp, *batch, schedule=sched,
                                                 num_microbatches=3, num_virtual=v)
        np.testing.assert_allclose(results[sched][0], loss_cpu, rtol=1e-5)
        np.testing.assert_allclose(results[sched][1].w[:3], g_cpu.w[:3], rtol=1e-4, atol=1e-6)
    for sched in ("1f1b",):
        np.testing.assert_allclose(results[sched][0], results["gpipe"][0], rtol=1e-5)
        np.testing.assert_allclose(results[sched][1].w, results["gpipe"][1].w, rtol=1e-4,
                                   atol=1e-6)


def test_pipeline_across_cards(cuda):
    # The default placement: the visible cards, each once. With three or
    # more, [1, 1, 1] pipelines across cards (peer copies at every
    # hand-off, both ways in training); with four, [2, 1] also runs two
    # data replicas on distinct cards.
    n_cards = torch.cuda.device_count()
    if n_cards < 3:
        pytest.skip(f"needs three or more cards, {n_cards} visible")
    from tpu_dist_nn_torch.data.datasets import Dataset
    from tpu_dist_nn_torch.train.trainer import TrainConfig

    model = _model([784, 128, 64, 10], ["relu", "relu", "softmax"])
    x = np.random.default_rng(11).uniform(0, 1, (1001, 784)).astype(np.float32)
    cases = [([1, 1, 1], 1)] + ([([2, 1], 2)] if n_cards >= 4 else [])
    for dist, data_parallel in cases:
        for quantize in (None, "int8"):
            one = Engine.up(model, quantize=quantize).infer(x)
            eng = Engine.up(model, dist, data_parallel=data_parallel, quantize=quantize)
            slots = {d for row in eng.placement()["slots"] for d in row}
            assert eng.placement()["pipelined"] and len(slots) == len(dist) * data_parallel
            pending = [eng.infer_async(x) for _ in range(4)]
            got = [eng.fetch(p) for p in pending]
            for g in got:
                np.testing.assert_array_equal(g, got[0])
            if quantize:
                np.testing.assert_array_equal(got[0], one)
            else:
                np.testing.assert_allclose(got[0], one, rtol=1e-5, atol=1e-6)
    # Training across cards equals training on three slots of one card.
    rng = np.random.default_rng(12)
    data = Dataset(x[:512], rng.integers(0, 10, 512), 10)
    cfg = TrainConfig(epochs=1, batch_size=64, clip_norm=1.0)
    across = Engine.up(model, [1, 1, 1])
    h_across = across.train(data, cfg, schedule="1f1b")
    one_card = Engine.up(model, [1, 1, 1], devices=["cuda:0"] * 3)
    h_one = one_card.train(data, cfg, schedule="1f1b")
    np.testing.assert_allclose(h_across[0]["loss"], h_one[0]["loss"], rtol=1e-6)
    for a, b in zip(across.model.layers, one_card.model.layers):
        np.testing.assert_allclose(a.weights, b.weights, rtol=1e-5, atol=1e-7)
