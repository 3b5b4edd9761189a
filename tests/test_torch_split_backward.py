"""The cotangent-stash split backward against JAX's and against autograd.

The same numpy-seeded block leaves, input and cotangent go through the
JAX package's ``split_backward`` and the port's, and through the port's
autograd of ``block_apply``: B (dx, the bias and LayerNorm gradients)
plus W (the four weight GEMMs) must equal both, at
``tests/test_split_backward.py``'s tolerance (rtol 5e-4, atol 1e-5), with
the materialised attention and with the flash attention's autograd
Function (its plain version on the CPU). The W tick's contract, pure
GEMMs, is held by recording the aten ops it dispatches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_dist_nn.models.transformer import TransformerConfig as JaxConfig
from tpu_dist_nn.models.transformer import init_transformer as jax_init
from tpu_dist_nn.parallel import split_backward as jsb
from tpu_dist_nn_torch.kernels.flash_attention import flash_attention
from tpu_dist_nn_torch.models.transformer import (
    TransformerConfig,
    block_apply,
    dot_product_attention,
    transformer_params_from_jax,
    unstack_blocks,
)
from tpu_dist_nn_torch.parallel import split_backward as sb

torch.set_num_threads(1)
SHAPE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_seq_len=32)
TOL = dict(rtol=5e-4, atol=1e-5)
ATTN = {"materialised": dot_product_attention, "flash": flash_attention}


def _setup(seed):
    jparams = jax_init(jax.random.key(seed), JaxConfig(**SHAPE))
    params = transformer_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    dy = rng.normal(size=(2, 16, 32)).astype(np.float32)
    return jparams["blocks"], params["blocks"], x, dy


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=err_msg, **TOL)


def _autograd(fn, leaves: dict, x, dy):
    """``(dx, {key: dleaf})`` of ``fn(leaves, x)`` by autograd."""
    leaves = {k: v.clone().requires_grad_() for k, v in leaves.items()}
    x = torch.from_numpy(x).requires_grad_()
    fn(leaves, x).backward(torch.from_numpy(dy))
    return x.grad, {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("attn", list(ATTN))
def test_block_split_matches_jax_and_autograd(attn):
    cfg = TransformerConfig(**SHAPE)
    jblocks, blocks, x, dy = _setup(3)
    jblock0 = jax.tree.map(lambda a: a[0], jblocks)
    block0 = unstack_blocks(blocks)[0]
    jdx, jsmall, jstash = jsb.block_backward_split(jblock0, jnp.asarray(x), jnp.asarray(dy),
                                                   JaxConfig(**SHAPE))
    jbig = jsb.block_weight_grads(jstash)
    dx, d_small, wstash = sb.block_backward_split(block0, torch.from_numpy(x),
                                                  torch.from_numpy(dy), cfg, ATTN[attn])
    d_big = sb.block_weight_grads(wstash)
    assert set(d_small) | set(d_big) == set(block0) and not set(d_small) & set(d_big)
    assert set(wstash) == set(jstash)
    _close(dx, jdx, "dx")
    for k, v in {**d_small, **d_big}.items():
        _close(v, {**jsmall, **jbig}[k], k)
    for k, v in wstash.items():
        _close(v, jstash[k], k)
    ref_dx, ref = _autograd(lambda b, xx: block_apply(b, xx, cfg, ATTN[attn]), block0, x, dy)
    _close(dx, ref_dx, "dx vs autograd")
    for k, v in {**d_small, **d_big}.items():
        _close(v, ref[k], f"{k} vs autograd")


@pytest.mark.parametrize("attn", list(ATTN))
def test_chunk_split_matches_jax_and_autograd(attn):
    cfg = TransformerConfig(**SHAPE)
    jblocks, blocks, x, dy = _setup(9)
    jdx, jsmalls, jstashes = jsb.chunk_backward_split(jblocks, jnp.asarray(x), jnp.asarray(dy),
                                                      JaxConfig(**SHAPE))
    jbigs = jsb.chunk_weight_grads(jstashes)
    dx, d_smalls, wstashes = sb.chunk_backward_split(blocks, torch.from_numpy(x),
                                                     torch.from_numpy(dy), cfg, ATTN[attn])
    d_bigs = sb.chunk_weight_grads(wstashes)
    _close(dx, jdx, "dx")
    for k, v in {**d_smalls, **d_bigs}.items():
        assert v.shape[0] == SHAPE["n_layers"], k
        _close(v, {**jsmalls, **jbigs}[k], k)
    for j, w in enumerate(wstashes):
        for k, v in w.items():
            _close(v, jstashes[k][j], f"block {j} {k}")

    def chunk(b, xx):
        for block in unstack_blocks(b):
            xx = block_apply(block, xx, cfg, ATTN[attn])
        return xx

    ref_dx, ref = _autograd(chunk, blocks, x, dy)
    _close(dx, ref_dx, "dx vs autograd")
    for k, v in {**d_smalls, **d_bigs}.items():
        _close(v, ref[k], f"{k} vs autograd")


def test_bf16_split_keeps_the_compute_dtype_and_tracks_autograd():
    """Under ``compute_dtype="bfloat16"`` every half comes back in bf16,
    as autograd's gradients of the cast leaves do, and within a bf16
    rounding or two of them (relative L2 2**-7 a leaf)."""
    cfg = TransformerConfig(**SHAPE, compute_dtype="bfloat16")
    _, blocks, x, dy = _setup(5)
    blocks16 = cfg.cast_params(blocks)
    x16, dy16 = (torch.from_numpy(a).bfloat16() for a in (x, dy))
    dx, d_smalls, wstashes = sb.chunk_backward_split(blocks16, x16, dy16, cfg)
    grads = {**d_smalls, **sb.chunk_weight_grads(wstashes)}
    assert dx.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in grads.values())

    def chunk(b, xx):
        for block in unstack_blocks(b):
            xx = block_apply(block, xx, cfg)
        return xx

    leaves = {k: v.clone().requires_grad_() for k, v in blocks16.items()}
    xr = x16.clone().requires_grad_()
    chunk(leaves, xr).backward(dy16)
    for k, g in [("dx", dx)] + list(grads.items()):
        want = (xr if k == "dx" else leaves[k]).grad.float()
        assert float((g.float() - want).norm() / want.norm()) < 2.0**-7, k


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("attn", list(ATTN))
def test_w_tick_dispatches_only_matmuls_transposes_and_reshapes(attn):
    cfg = TransformerConfig(**SHAPE)
    _, blocks, x, dy = _setup(7)
    _, _, wstash = sb.block_backward_split(unstack_blocks(blocks)[0], torch.from_numpy(x),
                                           torch.from_numpy(dy), cfg, ATTN[attn])
    with _Ops() as ops:
        grads = sb.block_weight_grads(wstash)
    assert "mm" in ops.seen and len(grads) == 4
    allowed = {"mm", "matmul", "bmm", "t", "transpose", "permute", "view", "reshape",
               "_unsafe_view", "_reshape_alias"}
    assert ops.seen <= allowed, sorted(ops.seen - allowed)
