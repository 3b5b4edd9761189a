"""Cotangent-stash split backward of the transformer block: a W tick of pure GEMMs.

Port of :mod:`tpu_dist_nn.parallel.split_backward`. A zero-bubble W tick
is only cheap when it is nothing but the weight-gradient GEMMs,
``dW = actᵀ @ cot`` for each weight application. So B, the input-gradient
half, runs the block backward by hand at sub-op granularity and stashes
the (activation, cotangent) pair at each weight application:

* the weight-free sub-ops (LayerNorm, attention, the tanh GELU) are
  differentiated by autograd, each on detached inputs that require grad
  (``torch.autograd.grad``; the flash kernels' ``FlashAttention`` is an
  autograd Function without ``setup_context``, so ``torch.func.vjp``
  cannot go through it): nothing numerical is re-derived by hand;
* only the four weight applications are split: the dx half
  (``cot @ Wᵀ``) runs in B, with the bias and LayerNorm gradients
  (reductions, not GEMMs); the dW half is deferred to W
  (:func:`block_weight_grads`: ``w_qkv``, ``w_o``, ``w_up``,
  ``w_down``).

The forward that B needs runs once and keeps each sub-op's vjp
(:func:`block_forward_collect`), so a block's B is one attention forward
and one attention backward, and its W launches no attention kernel. The
gradients come in the compute dtype (bf16 GEMM outputs under
``compute_dtype="bfloat16"``), as autograd's do; the executor casts them
to the float32 leaves as the backward through ``cfg.cast_params`` does.
Memory: a block's stash is the four pairs, about ``(2F + 8D) / D`` block
inputs (16 at ``F = 4D``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_dist_nn_torch.models.transformer import dot_product_attention, layer_norm, unstack_blocks


def _vjp(fn, *inputs):
    """``fn(*inputs)`` and its vjp: ``(out, vjp)`` with ``vjp(cot) ->
    grads of inputs``, by autograd over detached inputs that require
    grad; ``out`` is detached."""
    ins = [a.detach().requires_grad_() for a in inputs]
    with torch.enable_grad():
        out = fn(*ins)
    return out.detach(), lambda cot: torch.autograd.grad(out, ins, cot)


def block_forward_collect(block: dict, x, cfg, attn_fn=dot_product_attention):
    """One block's forward (unstacked leaves, ``x (B, T, D)``), the same
    ops as :func:`~tpu_dist_nn_torch.models.transformer.block_apply`,
    keeping what :func:`block_backward_from` needs: ``(y, inner)``,
    ``inner`` the sub-op vjps and the inputs of the four weight
    applications."""
    B, T, D = x.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    with torch.no_grad():
        h1, ln1 = _vjp(layer_norm, x, block["ln1_g"], block["ln1_b"])
        qkv = h1 @ block["w_qkv"] + block["b_qkv"]
        q, k, v = qkv.reshape(B, T, 3 * H, Dh).split(H, dim=2)
        o, attn = _vjp(lambda qq, kk, vv: attn_fn(qq, kk, vv, causal=cfg.causal), q, k, v)
        o_flat = o.reshape(B, T, D)
        y1 = x + o_flat @ block["w_o"] + block["b_o"]
        h2, ln2 = _vjp(layer_norm, y1, block["ln2_g"], block["ln2_b"])
        u, gelu = _vjp(lambda p: F.gelu(p, approximate="tanh"),
                       h2 @ block["w_up"] + block["b_up"])
        y = y1 + u @ block["w_down"] + block["b_down"]
    return y, dict(ln1=ln1, attn=attn, ln2=ln2, gelu=gelu, heads=(H, Dh), h1=h1,
                   o_flat=o_flat, h2=h2, u=u)


def block_backward_from(block: dict, inner: dict, dy):
    """B of one block from :func:`block_forward_collect`'s ``inner``:
    ``(dx, d_small, wstash)``. ``d_small``: the bias and LayerNorm
    gradients; ``wstash``: the four (activation, cotangent) pairs that
    :func:`block_weight_grads` turns into the weight gradients. Each vjp
    of ``inner`` runs once, which frees its graph."""
    B, T, D = dy.shape
    with torch.no_grad():
        # FFN sublayer: y = y1 + gelu(LN2(y1) @ w_up + b_up) @ w_down + b_down
        (d_pre,) = inner["gelu"](dy @ block["w_down"].T)            # dx half of w_down
        d_y1_ln, d_g2, d_b2 = inner["ln2"](d_pre @ block["w_up"].T)  # dx half of w_up
        d_y1 = dy + d_y1_ln                                         # + the residual
        # Attention sublayer: y1 = x + attn(LN1(x) @ w_qkv + b_qkv) @ w_o + b_o
        d_o = (d_y1 @ block["w_o"].T).reshape(B, T, *inner["heads"])  # dx half of w_o
        dq, dk, dv = inner["attn"](d_o)
        d_qkv = torch.cat([dq, dk, dv], dim=2).reshape(B, T, 3 * D)
        dx_ln, d_g1, d_b1 = inner["ln1"](d_qkv @ block["w_qkv"].T)  # dx half of w_qkv
        dx = d_y1 + dx_ln                                           # + the residual
        d_small = {"b_qkv": d_qkv.sum((0, 1)), "b_o": d_y1.sum((0, 1)),
                   "b_up": d_pre.sum((0, 1)), "b_down": dy.sum((0, 1)),
                   "ln1_g": d_g1, "ln1_b": d_b1, "ln2_g": d_g2, "ln2_b": d_b2}
    wstash = {"h1": inner["h1"], "d_qkv": d_qkv, "o_flat": inner["o_flat"], "d_y1": d_y1,
              "h2": inner["h2"], "d_pre": d_pre, "u": inner["u"], "dy": dy}
    return dx, d_small, wstash


def block_backward_split(block: dict, x, dy, cfg, attn_fn=dot_product_attention):
    """One block's backward with the four dW GEMMs deferred: ``(dx,
    d_small, wstash)`` (:func:`block_forward_collect` then
    :func:`block_backward_from`)."""
    _, inner = block_forward_collect(block, x, cfg, attn_fn)
    return block_backward_from(block, inner, dy)


def _gemm(act, cot):
    """``actᵀ @ cot`` over every row: ``(..., d), (..., f) -> (d, f)``."""
    return act.reshape(-1, act.shape[-1]).t() @ cot.reshape(-1, cot.shape[-1])


def block_weight_grads(wstash: dict) -> dict:
    """The W tick of one block: four GEMMs and nothing else, from the
    pairs :func:`block_backward_from` stashed."""
    return {"w_qkv": _gemm(wstash["h1"], wstash["d_qkv"]),
            "w_o": _gemm(wstash["o_flat"], wstash["d_y1"]),
            "w_up": _gemm(wstash["h2"], wstash["d_pre"]),
            "w_down": _gemm(wstash["u"], wstash["dy"])}


def chunk_forward_collect(blocks: dict, x, cfg, attn_fn=dot_product_attention):
    """A chunk's forward (stacked ``(L_c, ...)`` leaves), each block's
    ``inner`` kept: ``(y, inners)``."""
    inners = []
    for block in unstack_blocks(blocks):
        x, inner = block_forward_collect(block, x, cfg, attn_fn)
        inners.append(inner)
    return x, inners


def chunk_backward_from(blocks: dict, inners: list, dy):
    """B of a chunk from :func:`chunk_forward_collect`'s ``inners``,
    blocks in reverse: ``(dx, d_small (L_c-stacked), wstashes (a list in
    block order))``. Each ``inner`` is consumed."""
    per_block = unstack_blocks(blocks)
    smalls, wstashes = [None] * len(per_block), [None] * len(per_block)
    for j in reversed(range(len(per_block))):
        dy, smalls[j], wstashes[j] = block_backward_from(per_block[j], inners[j], dy)
        inners[j] = None
    return dy, {k: torch.stack([s[k] for s in smalls]) for k in smalls[0]}, wstashes


def chunk_backward_split(blocks: dict, x, dy, cfg, attn_fn=dot_product_attention):
    """Split backward through a chunk: its forward once from the chunk
    input, then :func:`chunk_backward_from`. ``(dx, d_small, wstashes)``."""
    _, inners = chunk_forward_collect(blocks, x, cfg, attn_fn)
    return chunk_backward_from(blocks, inners, dy)


def chunk_weight_grads(wstashes: list) -> dict:
    """W over a chunk: :func:`block_weight_grads` of each block, stacked
    ``(L_c, ...)``."""
    per_block = [block_weight_grads(w) for w in wstashes]
    return {k: torch.stack([g[k] for g in per_block]) for k in per_block[0]}
