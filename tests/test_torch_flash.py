"""The port's flash attention against the JAX package's, on the CPU.

On the CPU the port's wrappers run their plain versions (materialised
float32, the kernels' formulas); the JAX kernels run jitted in
interpret mode with 16-row blocks, as ``tests/test_flash_attention.py``
runs them. Inputs are made with numpy and handed to both. Tolerances
are that file's: 2e-5 forward, 2e-4 gradients. The CUDA kernels
themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist_nn.kernels.flash_attention import _flash_bwd as jax_flash_bwd
from tpu_dist_nn.kernels.flash_attention import _flash_fwd as jax_flash_fwd
from tpu_dist_nn.kernels.flash_attention import flash_attention as jax_flash
from tpu_dist_nn.models.transformer import dot_product_attention as jax_dpa
from tpu_dist_nn_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
from tpu_dist_nn_torch.kernels.flash_attention import (
    MAX_HEAD_DIM,
    _flash_bwd,
    default_attn_fn,
    flash_attention,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_fwd,
)
from tpu_dist_nn_torch.models.transformer import (
    TransformerConfig,
    dot_product_attention,
    forward,
    init_transformer,
    lm_loss,
    param_leaves,
    tree_map,
)
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

torch.set_num_threads(1)
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)


def _qkv(B, T, H, Dh, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, Dh)).astype(np.float32) for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _jax_flash(causal):
    def fn(q, k, v):
        return jax_flash(q, k, v, causal=causal, block_q=16, block_k=16)
    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _jax_flash_grad(causal):
    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal, block_q=16, block_k=16) ** 2)
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))


@pytest.mark.parametrize("T", [32, 48, 24, 40])  # 48, 24, 40: ragged for 16-row blocks
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_forward_matches_jax_flash_and_reference(causal, T):
    q, k, v = _qkv(2, T, 2, 16, seed=T)
    want = np.asarray(_jax_flash(causal)(q, k, v))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)
    ref = dot_product_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    np.testing.assert_allclose(got, ref, **FWD_TOL)
    np.testing.assert_allclose(ref, np.asarray(jax_dpa(q, k, v, causal=causal)), **FWD_TOL)


@pytest.mark.parametrize("T", [32, 24])  # 24: padded keys must not leak into the grads
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_grads_through_the_function_match_jax_flash(causal, T):
    q, k, v = _qkv(2, T, 2, 8, seed=1)
    want = _jax_flash_grad(causal)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    (flash_attention(tq, tk, tv, causal=causal) ** 2).sum().backward()
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_plain_kernels_match_the_jax_kernels(causal):
    # The JAX kernels on their own padded (BH, Tp, Dh) arrays, T = 40 real
    # rows of Tp = 48; the port's kernels on the same arrays as
    # (BH, Tp, 1, Dh) with seq_len = 40: o, lse, dq, dk, dv on every row.
    BH, Tp, T, Dh = 3, 48, 40, 16
    rng = np.random.default_rng(7)
    q, k, v, g = (rng.standard_normal((BH, Tp, Dh)).astype(np.float32) for _ in range(4))
    kw = dict(scale=1.0 / np.sqrt(Dh), causal=causal, block_q=16, block_k=16, seq_len=T)
    o, lse = jax.jit(functools.partial(jax_flash_fwd, **kw))(q, k, v)
    dq, dk, dv = jax.jit(functools.partial(jax_flash_bwd, **kw))((q, k, v, o, lse), g)

    def port(a):
        return torch.from_numpy(np.ascontiguousarray(a))[:, :, None, :]

    tq, tk, tv, tg = map(port, (q, k, v, g))
    reset_launch_counts()
    got_o, got_lse = flash_fwd(tq, tk, tv, causal=causal, seq_len=T)
    np.testing.assert_allclose(got_o[:, :, 0].numpy(), np.asarray(o), **FWD_TOL)
    np.testing.assert_allclose(got_lse[:, 0].numpy(), np.asarray(lse)[..., 0], **FWD_TOL)
    got = _flash_bwd(tq, tk, tv, got_o, got_lse, tg, causal=causal, seq_len=T)
    for a, b in zip(got, (dq, dk, dv)):
        np.testing.assert_allclose(a[:, :, 0].numpy(), np.asarray(b), **GRAD_TOL)
    # Keys past seq_len get no gradient, as the padded JAX keys do.
    assert not got[1][:, T:].any() and not got[2][:, T:].any()
    # CPU tensors take the plain versions: no kernel launched.
    assert all(fn.launches == 0 for fn in KERNEL_WRAPPERS)


def test_wrappers_read_strided_views_of_a_fused_projection():
    # q, k, v as the three views of one (B, T, 3H, Dh) tensor, as the
    # transformer hands them in, give what contiguous copies give.
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((2, 20, 6, 8)).astype(np.float32))
    q, k, v = qkv.split(2, dim=2)
    assert not q.is_contiguous()
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    o, lse = flash_fwd(q, k, v, causal=True)
    do = torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    torch.testing.assert_close(flash_bwd_dq(q, k, v, do, lse, delta, causal=True),
                               flash_bwd_dq(q.contiguous(), k, v, do, lse, delta, causal=True))
    assert len(flash_bwd_dkv(q, k, v, do, lse, delta, causal=True)) == 2


def test_rejects_mismatched_shapes_and_what_the_kernels_do_not_take():
    q, k, v = map(torch.from_numpy, _qkv(1, 16, 2, 8))
    with pytest.raises(ValueError, match="must match"):
        flash_attention(q, k[:, :8], v, causal=True)
    with pytest.raises(InvalidArgumentError, match="MAX_HEAD_DIM"):
        big = torch.zeros(1, 4, 1, MAX_HEAD_DIM + 1)
        flash_fwd(big, big, big, causal=True)
    with pytest.raises(InvalidArgumentError, match="expected torch.float32"):
        flash_fwd(q, k.to(torch.bfloat16), v, causal=True)
    with pytest.raises(InvalidArgumentError, match="takes"):
        flash_fwd(q.double(), k.double(), v.double(), causal=True)
    with pytest.raises(InvalidArgumentError, match="seq_len"):
        flash_fwd(q, k, v, causal=True, seq_len=0)
    with pytest.raises(InvalidArgumentError, match="contiguous"):
        flash_fwd(q.transpose(1, 3), k.transpose(1, 3), v.transpose(1, 3), causal=True)


def test_default_attn_fn_is_the_reference_on_the_cpu():
    q, k, v = map(torch.from_numpy, _qkv(2, 12, 2, 8, seed=4))
    attn = default_attn_fn()
    torch.testing.assert_close(attn(q, k, v, causal=True),
                               dot_product_attention(q, k, v, causal=True), atol=0, rtol=0)


def test_swaps_into_transformer_forward_and_loss():
    cfg = TransformerConfig(vocab_size=32, d_model=16, n_heads=2, n_layers=2, d_ff=32,
                            max_seq_len=32)
    params = init_transformer(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 32, (2, 32)))
    torch.testing.assert_close(forward(params, tokens, cfg, flash_attention),
                               forward(params, tokens, cfg), atol=2e-4, rtol=2e-4)
    grads = []
    for attn in (dot_product_attention, flash_attention):
        p = tree_map(lambda a: a.clone().requires_grad_(True), params)
        grads.append(torch.autograd.grad(lm_loss(p, tokens, cfg, attn), param_leaves(p)))
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, atol=5e-4, rtol=5e-4)
