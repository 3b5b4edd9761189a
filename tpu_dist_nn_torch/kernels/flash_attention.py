"""Flash attention: the forward and both backward kernels, one autograd
Function.

Port of :mod:`tpu_dist_nn.kernels.flash_attention`. Three wrappers
launch the three kernels of ``csrc/flash_attention.cu``:

* :func:`flash_fwd` -> ``(o, lse)`` (replaces the Pallas ``_fwd_kernel``);
* :func:`flash_bwd_dq` -> ``dq`` (``_bwd_dq_kernel``);
* :func:`flash_bwd_dkv` -> ``(dk, dv)`` (``_bwd_dkv_kernel``).

Each has a plain PyTorch version beside it (``*_plain``) that
materialises the scores in float32 and uses the kernels' own formulas:
``p = exp(s - lse)`` masked to 0, ``ds = p * (dp - delta)``. For CPU
tensors a wrapper runs its plain version; for CUDA tensors it launches
its kernel or raises. ``launches`` on each wrapper counts launches.

Tensors are ``(B, T, H, Dh)``, float32 or bfloat16, read with their
strides (the last dimension must be contiguous), so the three views of a
fused ``qkv`` projection go in without a copy. Outputs are contiguous
``(B, T, H, Dh)`` in the input type; ``lse`` and ``delta`` are
``(B, H, T)`` float32. The TPU kernels pad T to a common multiple of
their block sizes and mask keys past ``seq_len``; here the kernels
bound-check ragged blocks instead, so ``seq_len`` (default T) only says
how many keys are real, as it does for the padded JAX arrays. The JAX
``block_q`` / ``block_k`` are TPU tiling knobs and are not carried
over: the CUDA tiles are 64 rows on both sides.

:class:`FlashAttention` (the JAX package's ``_flash_call`` custom VJP)
and :func:`flash_attention` (the ``(..., T, H, Dh)`` drop-in for
``dot_product_attention``) sit on top. :func:`default_attn_fn` takes the
kernel for CUDA tensors at every sequence length — the JAX package's
``FLASH_MIN_SEQ`` was measured on a TPU, and the port's threshold will
come from the card's own timings — and ``dot_product_attention`` on the
CPU, as the JAX package does off the TPU.
"""

from __future__ import annotations

import math

import torch

from tpu_dist_nn_torch.kernels import _build
from tpu_dist_nn_torch.kernels.fused_dense import _ints, _stream
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

#: The kernels stage a head's rows at a width of 64 or 128 floats.
MAX_HEAD_DIM = 128
#: The TPU kernels' finite mask value: exp(m - m_new) of a fully masked
#: tile stays 0 instead of NaN.
NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)


def _key_mask(T: int, seq_len: int, causal: bool, device) -> torch.Tensor:
    """``(T, T)`` bool, ``[query, key]``: the key is real and, when
    causal, not after the query."""
    ids = torch.arange(T, device=device)
    mask = (ids < seq_len)[None, :].expand(T, T)
    if causal:
        mask = mask & (ids[None, :] <= ids[:, None])
    return mask


def _check(tensors: dict, *, causal, seq_len) -> tuple[int, int]:
    """Validate ``(B, T, H, Dh)`` inputs on one device in one type;
    returns ``(T, seq_len)``."""
    ref = next(iter(tensors.values()))
    if not isinstance(ref, torch.Tensor):
        raise InvalidArgumentError(f"expected torch.Tensors, got {type(ref).__name__}")
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise InvalidArgumentError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device != ref.device or t.dtype != ref.dtype:
            raise InvalidArgumentError(
                f"{name} is {t.dtype} on {t.device}; expected {ref.dtype} on {ref.device}")
        if t.shape != ref.shape or t.dim() != 4:
            raise InvalidArgumentError(
                f"{name} has shape {tuple(t.shape)}; expected (B, T, H, Dh) = "
                f"{tuple(ref.shape)}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise InvalidArgumentError(f"{name}: the head dimension must be contiguous")
    if ref.dtype not in _DTYPES:
        raise InvalidArgumentError(
            f"flash attention takes {[str(d) for d in _DTYPES]}, got {ref.dtype}")
    B, T, H, Dh = ref.shape
    if min(B, T, H, Dh) < 1:
        raise InvalidArgumentError(f"flash attention needs a non-empty (B, T, H, Dh), got "
                                   f"{tuple(ref.shape)}")
    if Dh > MAX_HEAD_DIM:
        raise InvalidArgumentError(
            f"head dim {Dh} is over MAX_HEAD_DIM = {MAX_HEAD_DIM}: the kernels stage a "
            "head's rows at a width of at most 128 floats")
    seq_len = T if seq_len is None else int(seq_len)
    if not 1 <= seq_len <= T:
        raise InvalidArgumentError(f"seq_len must be in [1, {T}], got {seq_len}")
    if not isinstance(causal, bool):
        raise InvalidArgumentError(f"causal must be a bool, got {causal!r}")
    return T, seq_len


def _check_rows(t: torch.Tensor, name: str, shape, device) -> None:
    """``lse`` / ``delta``: contiguous float32 ``(B, H, T)``."""
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or t.device != device
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise InvalidArgumentError(
            f"{name} must be a contiguous float32 {tuple(shape)} tensor on {device}")


def _dims(q, k, v, seq_len: int, causal: bool):
    B, T, H, Dh = q.shape
    strides = []
    for t in (q, k, v):
        sb, st, sh, _ = t.stride()
        strides += [sb, st, sh]
    if max(strides) >= 2**31 or B * H * -(-T // 64) >= 2**31:
        raise InvalidArgumentError("flash attention: shape past the kernels' 32-bit indexing")
    return _ints([B, H, T, Dh, seq_len, int(causal), *strides])


def _scale(q) -> float:
    return 1.0 / math.sqrt(q.shape[-1])


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def flash_fwd_plain(q, k, v, *, scale, causal, seq_len=None):
    """The plain version of :func:`flash_fwd`, materialised in float32:
    ``(o (B, T, H, Dh) in q's type, lse (B, H, T) float32)``. q is
    scaled before the product, as the forward kernel does."""
    T = q.shape[1]
    seq_len = T if seq_len is None else seq_len
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    mask = _key_mask(T, seq_len, causal, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l_safe.transpose(1, 2)
    return o.to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


def flash_fwd(q, k, v, *, causal: bool, seq_len=None):
    """Attention forward in one kernel: ``q, k, v (B, T, H, Dh)`` ->
    ``(o, lse)``, ``o = softmax(q k^T / sqrt(Dh)) v`` over the keys below
    ``seq_len`` (and, when ``causal``, not after the query)."""
    T, seq_len = _check({"q": q, "k": k, "v": v}, causal=causal, seq_len=seq_len)
    scale = _scale(q)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale=scale, causal=causal, seq_len=seq_len)
    B, _, H, Dh = q.shape
    o = torch.empty((B, T, H, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    launch = _build.launcher("flash_attention", "tdn_flash_fwd")
    with torch.cuda.device(q.device):
        code = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                      _dims(q, k, v, seq_len, causal), scale, int(q.dtype == torch.bfloat16),
                      _stream(q.device))
    _build.check(code, "flash_fwd launch")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def _probs(q, k, lse, *, scale, causal, seq_len):
    """``p = exp(q k^T * scale - lse)``, masked to 0: ``(B, H, T, T)``."""
    T = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _key_mask(T, T if seq_len is None else seq_len, causal, q.device)
    return torch.where(mask, torch.exp(s - lse[..., None]), 0.0)


def _dscores(p, do, v, delta):
    """``ds = p * (dO v^T - delta)``: ``(B, H, T, T)``."""
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p * (dp - delta[..., None])


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, scale, causal, seq_len=None):
    """The plain version of :func:`flash_bwd_dq`, in float32:
    ``dq = (ds k) * scale`` in q's type."""
    p = _probs(q, k, lse, scale=scale, causal=causal, seq_len=seq_len)
    ds = _dscores(p, do, v, delta)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, scale, causal, seq_len=None):
    """The plain version of :func:`flash_bwd_dkv`, in float32:
    ``dk = (ds^T q) * scale`` and ``dv = p^T dO`` in q's type."""
    p = _probs(q, k, lse, scale=scale, causal=causal, seq_len=seq_len)
    ds = _dscores(p, do, v, delta)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def _check_bwd(q, k, v, do, lse, delta, causal, seq_len):
    T, seq_len = _check({"q": q, "k": k, "v": v, "do": do}, causal=causal, seq_len=seq_len)
    if not do.is_contiguous():
        raise InvalidArgumentError("do must be contiguous (B, T, H, Dh)")
    B, _, H, _ = q.shape
    _check_rows(lse, "lse", (B, H, T), q.device)
    _check_rows(delta, "delta", (B, H, T), q.device)
    return T, seq_len


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, seq_len=None):
    """``dq`` of attention in one kernel, recomputing ``p`` from the
    forward's ``lse``; ``do`` is contiguous in q's type and ``delta =
    rowsum(dO * O)`` float32 ``(B, H, T)``."""
    T, seq_len = _check_bwd(q, k, v, do, lse, delta, causal, seq_len)
    scale = _scale(q)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, scale=scale, causal=causal,
                                  seq_len=seq_len)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    launch = _build.launcher("flash_attention", "tdn_flash_bwd_dq")
    with torch.cuda.device(q.device):
        code = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                      lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                      _dims(q, k, v, seq_len, causal), scale, int(q.dtype == torch.bfloat16),
                      _stream(q.device))
    _build.check(code, "flash_bwd_dq launch")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool, seq_len=None):
    """``(dk, dv)`` of attention in one kernel; arguments as
    :func:`flash_bwd_dq`."""
    T, seq_len = _check_bwd(q, k, v, do, lse, delta, causal, seq_len)
    scale = _scale(q)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale=scale, causal=causal,
                                   seq_len=seq_len)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    launch = _build.launcher("flash_attention", "tdn_flash_bwd_dkv")
    with torch.cuda.device(q.device):
        code = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                      lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                      _dims(q, k, v, seq_len, causal), scale, int(q.dtype == torch.bfloat16),
                      _stream(q.device))
    _build.check(code, "flash_bwd_dkv launch")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def _flash_bwd(q, k, v, o, lse, g, *, causal, seq_len=None):
    """The VJP: ``delta`` from the float32 cotangent (a torch op, as the
    JAX package leaves it to XLA), the kernels fed the cotangent in q's
    type."""
    delta = (g.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
    do = g.to(q.dtype).contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, seq_len=seq_len)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, seq_len=seq_len)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``o = attention(q, k, v)`` with the flash backward: saves
    ``(q, k, v, o, lse)``, no ``(T, T)`` tensor. Under
    ``torch.utils.checkpoint`` the forward runs again in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, g, causal=ctx.causal)
        return dq, dk, dv, None


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool):
    """Drop-in for ``dot_product_attention``: ``(..., T, H, Dh)`` in and
    out, differentiable through :class:`FlashAttention`."""
    if q.shape != k.shape or q.shape != v.shape:
        raise InvalidArgumentError(
            f"q/k/v shapes must match: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if q.dim() < 3:
        raise InvalidArgumentError(f"q must be (..., T, H, Dh), got {tuple(q.shape)}")
    *batch, T, H, Dh = q.shape

    def flat(a):
        a = a.reshape(-1, T, H, Dh)
        return a if a.stride(-1) == 1 else a.contiguous()

    o = FlashAttention.apply(flat(q), flat(k), flat(v), causal)
    return o.reshape(*batch, T, H, Dh)


def select_attention(q, k, v, *, causal: bool):
    """The kernel for CUDA tensors, ``dot_product_attention`` for CPU
    tensors."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal)
    from tpu_dist_nn_torch.models.transformer import dot_product_attention

    return dot_product_attention(q, k, v, causal=causal)


def default_attn_fn():
    """The attention the trainers use when none is given:
    :func:`select_attention`."""
    return select_attention
