"""A NaN input row through the plain versions of the dense, chain, int8 and
conv kernels, against the JAX package's kernels, on the CPU.

``jnp.maximum`` and ``torch.relu`` keep a NaN, so a NaN anywhere in an
input row makes that row's output non-finite on the JAX path; the numeric
guard in front of ``Process`` then fails the request ``DATA_LOSS``. The
kernels on the card must do the same (their relu, pool max and the int8
row maximum keep NaN since the F9 repair); ``python3 chip_smoke.py``
holds each kernel's NaN row against its plain version there. The CPU
cannot show the kernels themselves: this module guards the plain versions
they are held against. Each case checks that the non-finite rows are the
JAX path's, and that the other rows equal a run without the NaN row bit
for bit and the JAX kernel at its usual tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist_nn.kernels import fcnn_fused_forward as jax_fcnn_fused_forward
from tpu_dist_nn.kernels import fused_dense as jax_fused_dense
from tpu_dist_nn.kernels import quantized as jax_q
from tpu_dist_nn.kernels.conv2d import fused_conv2d as jax_fused_conv2d
from tpu_dist_nn.models.fcnn import init_fcnn as jax_init_fcnn
from tpu_dist_nn_torch.kernels import (
    fcnn_fused_forward,
    forward_quantized,
    fused_conv2d,
    fused_dense,
    quantize_fcnn,
)
from tpu_dist_nn_torch.models.fcnn import params_from_jax

torch.set_num_threads(1)

POISONED = (3, 17)  # rows with a NaN


def _poison(x, col=5):
    x = x.copy()
    for r in POISONED:
        x[r, col] = np.nan
    return x


def _rows_nonfinite(a):
    a = np.asarray(a)
    return ~np.isfinite(a.reshape(a.shape[0], -1)).all(axis=1)


def _dense(x):
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(x.shape[1], 16)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(16,)) * 0.1).astype(np.float32)
    want = jax_fused_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), activation="relu")
    got = fused_dense(*(torch.from_numpy(a) for a in (x, w, b)), activation="relu")
    return got.numpy(), np.asarray(want), (1e-5, 1e-5)


def _jparams(acts):
    return jax_init_fcnn(jax.random.key(0), [24, 32, 16, 4], activations=acts)


def _chain(x):
    acts = ["relu", "relu", "softmax"]
    jparams = _jparams(acts)
    want = jax_fcnn_fused_forward(jparams, jnp.asarray(x), block_b=32, activations=acts)
    got = fcnn_fused_forward(params_from_jax(jparams, device="cpu"), torch.from_numpy(x),
                             activations=acts)
    return got.numpy(), np.asarray(want), (2e-5, 1e-4)


def _int8(x):
    jparams = _jparams(["relu", "relu", "softmax"])
    want = jax_q.fcnn_quantized_forward(jax_q.quantize_fcnn(jparams), jnp.asarray(x),
                                        block_b=32, prefer_kernel=True)
    got = forward_quantized(quantize_fcnn(params_from_jax(jparams, device="cpu")),
                            torch.from_numpy(x))
    return got.numpy(), np.asarray(want), (1e-7, 1e-6)


def _conv(imgs):
    rng = np.random.default_rng(2)
    w = (rng.normal(size=(3, 3, 3, 7)) * 0.3).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    kw = dict(padding="valid", activation="relu", pool_window=(2, 2))
    want = jax_fused_conv2d(jnp.asarray(imgs), jnp.asarray(w), jnp.asarray(b), **kw)
    got = fused_conv2d(*(torch.from_numpy(a) for a in (imgs, w, b)), **kw)
    return got.numpy(), np.asarray(want), (1e-5, 2e-5)


CASES = {"fused_dense": _dense, "chain": _chain, "int8_chain": _int8, "conv": _conv}


def _inputs(case):
    rng = np.random.default_rng(0)
    if case == "conv":
        imgs = rng.uniform(0, 1, (24, 9, 9, 3)).astype(np.float32)
        poisoned = imgs.copy()
        for r in POISONED:
            poisoned[r, 4, 4, 1] = np.nan
        return imgs, poisoned
    x = rng.uniform(0, 1, (40, 24)).astype(np.float32)
    return x, _poison(x)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_versions_keep_a_nan_row_as_jax_does(case):
    clean, poisoned = _inputs(case)
    got, want, (atol, rtol) = CASES[case](poisoned)
    base, _, _ = CASES[case](clean)
    bad = _rows_nonfinite(want)
    assert bad.tolist() == [r in POISONED for r in range(len(bad))]
    assert _rows_nonfinite(got).tolist() == bad.tolist()
    ok = ~bad
    np.testing.assert_array_equal(got[ok], base[ok])
    np.testing.assert_allclose(got[ok], want[ok], atol=atol, rtol=rtol)


def test_relu_of_nan_is_nan_in_both_packages():
    z = np.array([np.nan, -1.0, -0.0, 0.0, 2.0], np.float32)
    got = torch.relu(torch.from_numpy(z)).numpy()
    want = np.asarray(jnp.maximum(jnp.asarray(z), 0.0))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[1:], want[1:])
