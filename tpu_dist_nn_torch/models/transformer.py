"""Byte-level Transformer LM: the JAX package's Tiny-Transformer family.

Port of :mod:`tpu_dist_nn.models.transformer`, with its layout: params
are a dict of tensors whose block leaves are stacked on a leading
``(n_layers, ...)`` axis, pre-LayerNorm residual blocks (attention then
a tanh-GELU MLP), learned positional embeddings, and an LM head tied to
the token embedding. The block stack is a Python loop over the stacked
leaves, unbound once per forward (``lax.scan``'s counterpart); under
``cfg.remat`` each block runs inside ``torch.utils.checkpoint``.

``compute_dtype="bfloat16"`` casts the float32 master params (and so the
activations) to bf16 for the forward, with LayerNorm statistics,
softmax and the cross-entropy in float32; gradients flow back to the
float32 masters through the cast, as in the JAX package.

Attention is a hook (``attn_fn``): :func:`dot_product_attention` is the
materialised reference, and
:func:`tpu_dist_nn_torch.kernels.flash_attention.flash_attention` the
CUDA kernels.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpu_dist_nn_torch.utils.device import resolve_device
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Static architecture description (hashable). Params stay float32;
    ``compute_dtype`` ("float32" or "bfloat16") is the forward's type."""

    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 512
    max_seq_len: int = 256
    causal: bool = True
    compute_dtype: str = "float32"
    remat: bool = False

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise InvalidArgumentError(
                f"d_model={self.d_model} not divisible by n_heads={self.n_heads}")
        if self.compute_dtype not in _COMPUTE_DTYPES:
            raise InvalidArgumentError(
                f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}, "
                f"got {self.compute_dtype!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def cast_params(self, params: dict) -> dict:
        """Params in the compute dtype (identity for float32)."""
        if self.compute_dtype == "float32":
            return params
        dtype = _COMPUTE_DTYPES[self.compute_dtype]
        return tree_map(lambda a: a.to(dtype), params)


def tree_map(fn, tree):
    """``fn`` over the tensors of a nested dict."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def param_leaves(params: dict) -> list[torch.Tensor]:
    """The tensors of a nested dict in ``jax.tree.leaves`` order (keys
    sorted, depth first)."""
    out = []
    for key in sorted(params):
        v = params[key]
        out.extend(param_leaves(v) if isinstance(v, dict) else [v])
    return out


def init_transformer(gen: torch.Generator, cfg: TransformerConfig, *, device=None) -> dict:
    """Params with the JAX package's distributions: N(0, 1/D) embeddings
    and projections, N(0, 0.01^2) positions, the residual outputs scaled
    by ``1/sqrt(2 n_layers)``, LayerNorm gains 1 and biases 0. Block
    leaves are stacked ``(n_layers, ...)``. Drawn on the CPU from
    ``gen``, then moved to ``device`` (default: cuda)."""
    dev = resolve_device(device)
    D, Fd, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    s_embed = 1.0 / math.sqrt(D)

    def dense(shape, scale):
        return torch.randn(shape, generator=gen, dtype=torch.float32) * scale

    tok = dense((cfg.vocab_size, D), s_embed)
    pos = dense((cfg.max_seq_len, D), 0.01)
    draws = [[dense((D, 3 * D), s_embed), dense((D, D), s_embed / math.sqrt(2 * L)),
              dense((D, Fd), s_embed), dense((Fd, D), (1.0 / math.sqrt(Fd)) / math.sqrt(2 * L))]
             for _ in range(L)]
    w_qkv, w_o, w_up, w_down = (torch.stack(ws) for ws in zip(*draws))

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32)

    blocks = {
        "ln1_g": full((L, D), 1.0), "ln1_b": full((L, D), 0.0),
        "w_qkv": w_qkv, "b_qkv": full((L, 3 * D), 0.0),
        "w_o": w_o, "b_o": full((L, D), 0.0),
        "ln2_g": full((L, D), 1.0), "ln2_b": full((L, D), 0.0),
        "w_up": w_up, "b_up": full((L, Fd), 0.0),
        "w_down": w_down, "b_down": full((L, D), 0.0),
    }
    params = {"tok_embed": tok, "pos_embed": pos, "blocks": blocks,
              "lnf_g": full((D,), 1.0), "lnf_b": full((D,), 0.0)}
    return tree_map(lambda a: a.to(dev), params)


def transformer_params_from_jax(tree: dict, *, device=None) -> dict:
    """The JAX package's params (a nested dict of arrays, e.g. after
    ``jax.tree.map(np.asarray, params)``) as float32 tensors on
    ``device`` (default: cuda)."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=dev), tree)


def layer_norm(x, g, b, eps=1e-5):
    """Statistics in float32 whatever the input type (bf16-safe)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    normed = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * g + b


def dot_product_attention(q, k, v, *, causal: bool):
    """Softmax attention, materialised: ``q, k, v (..., T, H, Dh)`` ->
    ``(..., T, H, Dh)``. Scores and softmax in float32."""
    dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("...qhd,...khd->...hqk", q, k).float() * scale
    if causal:
        t_q, t_k = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((t_q, t_k), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -math.inf)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("...hqk,...khd->...qhd", probs, v)


def attn_sublayer(block: dict, x, cfg: TransformerConfig, attn_fn=dot_product_attention, *,
                  return_kv: bool = False):
    """Pre-LN attention sublayer with residual: ``(B, T, D) -> (B, T, D)``.
    ``return_kv`` also returns the sublayer's ``(B, T, H, Dh)`` k and v,
    the KV-cache fill of :mod:`tpu_dist_nn_torch.models.generate`."""
    B, T, D = x.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    h = layer_norm(x, block["ln1_g"], block["ln1_b"])
    qkv = h @ block["w_qkv"] + block["b_qkv"]
    q, k, v = qkv.reshape(B, T, 3 * H, Dh).split(H, dim=2)
    o = attn_fn(q, k, v, causal=cfg.causal).reshape(B, T, D)
    y = x + o @ block["w_o"] + block["b_o"]
    return (y, k, v) if return_kv else y


def ffn_sublayer(block: dict, x):
    """Pre-LN GELU (tanh form, as ``jax.nn.gelu``) MLP with residual."""
    h = layer_norm(x, block["ln2_g"], block["ln2_b"])
    h = F.gelu(h @ block["w_up"] + block["b_up"], approximate="tanh")
    return x + h @ block["w_down"] + block["b_down"]


def block_apply(block: dict, x, cfg: TransformerConfig, attn_fn=dot_product_attention):
    """One pre-LN residual block on *unstacked* leaves: ``(B, T, D) -> (B, T, D)``."""
    return ffn_sublayer(block, attn_sublayer(block, x, cfg, attn_fn))


def maybe_remat(cfg: TransformerConfig, fn=None):
    """``fn`` (default :func:`block_apply`) under per-block
    rematerialisation when ``cfg.remat``: the block keeps only its inputs
    after the forward and runs again in the backward
    (``torch.utils.checkpoint``, non-reentrant). The block draws no random
    numbers, so the RNG state is not saved and restored around the
    recompute (reading it is refused inside a CUDA graph capture)."""
    fn = block_apply if fn is None else fn
    if not cfg.remat:
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False)


def unstack_blocks(blocks: dict) -> list[dict]:
    """Stacked ``(n_layers, ...)`` leaves -> one dict per layer (views)."""
    keys = list(blocks)
    return [dict(zip(keys, leaves)) for leaves in zip(*(blocks[k].unbind(0) for k in keys))]


def embed(params: dict, tokens):
    """``tokens (batch, T)`` ints -> ``(batch, T, D)`` activations."""
    T = tokens.shape[-1]
    return params["tok_embed"][tokens.long()] + params["pos_embed"][:T]


def unembed(params: dict, x):
    """Final LN + tied LM head: ``(batch, T, D) -> (batch, T, V)``."""
    x = layer_norm(x, params["lnf_g"], params["lnf_b"])
    return x @ params["tok_embed"].T


def forward(params: dict, tokens, cfg: TransformerConfig, attn_fn=dot_product_attention):
    """Full LM forward: ``(batch, T)`` tokens -> ``(batch, T, vocab)``
    logits in ``cfg.compute_dtype``."""
    params = cfg.cast_params(params)
    x = embed(params, tokens)
    apply = maybe_remat(cfg)
    for block in unstack_blocks(params["blocks"]):
        x = apply(block, x, cfg, attn_fn)
    return unembed(params, x)


def next_token_ce(logits, targets):
    """Mean cross-entropy (nats/token) of ``logits (..., T, V)`` against
    ``targets (..., T)``, in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets.long()[..., None])[..., 0]
    return -ll.mean()


def masked_next_token_ce(logits, tokens):
    """Next-token CE on full (input + target) rows: positions ``0..T-2``
    against targets ``1..T-1``."""
    return next_token_ce(logits[:, :-1], tokens[:, 1:])


def lm_loss(params: dict, tokens, cfg: TransformerConfig, attn_fn=dot_product_attention):
    """Next-token cross-entropy (mean nats/token) on ``(batch, T + 1)`` tokens."""
    logits = forward(params, tokens[:, :-1], cfg, attn_fn)
    return next_token_ce(logits, tokens[:, 1:])


def num_params(params: dict) -> int:
    return sum(int(p.numel()) for p in param_leaves(params))
