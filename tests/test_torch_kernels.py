"""The port's dense-layer kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX kernels
run in Pallas interpret mode, as the JAX package's own tests run them
(``tests/test_kernels.py``, ``tests/test_quantized.py``), at those
tests' tolerances. The kernels themselves run only on the card:
``tests/test_torch_cuda.py`` and ``python3 chip_smoke.py`` hold them
against their plain versions there.
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
from tpu_dist_nn_torch.kernels import (
    KERNEL_WRAPPERS,
    fcnn_fused_forward,
    fcnn_quantized_forward,
    forward_quantized,
    fused_dense,
    quantize_fcnn,
    reset_launch_counts,
)
from tpu_dist_nn_torch.kernels.fused_dense import (
    SMEM_LIMIT_BYTES,
    boundary_widths,
    chain_tile_rows,
)
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
    # The flagship: A holds 784 and 64 wide rows, B 128 and 10.
    assert boundary_widths([784, 128, 64, 10]) == (784, 128)
    assert chain_tile_rows(4 * (784 + 128), 32 * 128 * 4, "f32") == 32
    assert chain_tile_rows(4 * (784 + 128) + 784 + 4, 16 * 128 * 4, "int8") == 32
    assert chain_tile_rows(4 * (1024 + 1024) + 1024 + 4, 16 * 128 * 4, "int8") == 16
    assert chain_tile_rows(SMEM_LIMIT_BYTES - 1, 1, "one row") == 1


def test_fused_chain_past_shared_memory_raises_naming_the_limit():
    wide = 60000  # one 60000-float row alone is 240 KB > 227 KB
    params = [{"w": torch.zeros(wide, 4), "b": torch.zeros(4), "act": 0}]
    with pytest.raises(InvalidArgumentError, match=str(SMEM_LIMIT_BYTES)):
        fcnn_fused_forward(params, torch.zeros(2, wide))


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

