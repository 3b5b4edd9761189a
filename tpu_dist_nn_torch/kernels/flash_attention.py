"""Flash attention: the forward and backward kernels, one autograd
Function.

Port of :mod:`tpu_dist_nn.kernels.flash_attention`. Two routes, chosen
by dtype (:func:`flash_route`), never as a fallback:

* bfloat16 on the card (the 85M recipe's path) -> the Hopper wgmma
  kernels of ``csrc/flash_attention_sm90.cu``: :func:`flash_fwd_sm90` ->
  ``(o, lse)`` (replaces the Pallas ``_fwd_kernel``) and
  :func:`flash_bwd_sm90` -> ``(dq, dk, dv)`` in one kernel
  (``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``);
* float32 on the card (``tdn lm``'s default) -> the TF32 tensor-core
  kernels of ``csrc/flash_attention_f32.cu``, which keep float32
  accuracy with 3xTF32 products: :func:`flash_fwd_f32` and
  :func:`flash_bwd_f32` (dq, dk and dv in one kernel);
* CPU tensors -> the plain versions.

:func:`flash_fwd` and :func:`flash_bwd` route; a bfloat16 call on the
card that the sm90 kernels do not take (a head dim outside
``SM90_HEAD_DIMS``, a stride or address TMA refuses) raises
:class:`InvalidArgumentError`. Each kernel wrapper counts its launches
in ``launches``.

Each kernel has a plain PyTorch version beside it (``*_plain``) that
materialises the scores in float32 and uses the kernels' own formulas:
``p = exp(s - lse)`` masked to 0, ``ds = p * (dp - delta)``;
:func:`flash_bwd_plain` can round ``p`` and ``ds`` to bfloat16 where
the sm90 kernel does, a tight reference for it.

Tensors are ``(B, T, H, Dh)``, read with their strides (the last
dimension must be contiguous), so the three views of a fused ``qkv``
projection go in without a copy. Outputs are contiguous ``(B, T, H,
Dh)`` in the input type; ``lse`` and ``delta`` are ``(B, H, T)``
float32. The TPU kernels pad T to a common multiple of their block
sizes and mask keys past ``seq_len``; here the kernels zero-fill ragged
tiles as they load them (cp.async in the f32 kernels, TMA in the sm90
ones), so ``seq_len`` (default T) only says how many keys are real, as
it does for the padded JAX arrays. The JAX ``block_q`` / ``block_k`` are
TPU tiling knobs and are not carried over: the f32 tiles are
``F32_TILES`` (by head width, :func:`f32_tiles`), the sm90 tiles
``SM90_TILES``.

:class:`FlashAttention` (the JAX package's ``_flash_call`` custom VJP)
and :func:`flash_attention` (the ``(..., T, H, Dh)`` drop-in for
``dot_product_attention``) sit on top. :func:`default_attn_fn` takes the
kernels for CUDA tensors at every sequence length — the JAX package's
``FLASH_MIN_SEQ`` was measured on a TPU, and the port's threshold will
come from the card's own timings — and ``dot_product_attention`` on the
CPU, as the JAX package does off the TPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from tpu_dist_nn_torch.kernels import _build
from tpu_dist_nn_torch.kernels.fused_dense import _ints, _stream
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

#: The f32 kernels stage a head's rows at a width of 32, 64 or 128
#: floats, the sm90 kernels take head dims up to 128.
MAX_HEAD_DIM = 128
#: The TPU kernels' finite mask value: exp(m - m_new) of a fully masked
#: tile stays 0 instead of NaN.
NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)


class Sm90Tiles(NamedTuple):
    block: int  #: forward: query rows and keys of a tile; backward: keys of a CTA
    wg_rows: int  #: rows of one consumer warpgroup (wgmma's M); the backward's q tile


#: The sm90 kernels' tiles. Every launch passes them, and the kernels
#: refuse any other values.
SM90_TILES = Sm90Tiles(block=128, wg_rows=64)
#: Head dims the sm90 kernels take: a row is one 64- or 128-byte TMA box,
#: or two.
SM90_HEAD_DIMS = (32, 64, 128)
#: TMA's rule for every global stride and base address, in bytes.
TMA_ALIGN = 16


class F32Tiles(NamedTuple):
    width: int  #: the head width the kernel is built for: Dh rounded up to 32, 64 or 128
    fwd_rows: int  #: forward: query rows of a CTA (4 warps of 16 or 32 rows)
    fwd_keys: int  #: forward: keys of a K/V tile
    bwd_keys: int  #: backward: keys of a CTA (4 warps of 16)
    bwd_rows: int  #: backward: query rows of a Q/dO tile


#: The f32 kernels' tiles by head width. Every launch passes them, and
#: the kernels refuse any other values.
F32_TILES = {32: F32Tiles(32, 128, 32, 64, 64), 64: F32Tiles(64, 128, 32, 64, 32),
             128: F32Tiles(128, 64, 32, 64, 16)}


def f32_tiles(head_dim: int) -> F32Tiles:
    """The tiles of the f32 kernel that takes ``head_dim`` (at most
    ``MAX_HEAD_DIM``)."""
    return F32_TILES[next(w for w in sorted(F32_TILES) if head_dim <= w)]


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


def _f32_params(q, k, v, seq_len: int, causal: bool, backward: bool) -> ctypes.Array:
    """The f32 launch's int parameters: B, H, T, Dh, seq_len, causal,
    the (batch, token, head) element strides of q, k and v, then the
    kernel's width and its two tiles (forward: ``fwd_rows``,
    ``fwd_keys``; backward: ``bwd_keys``, ``bwd_rows``) from
    :func:`f32_tiles`."""
    B, T, H, Dh = q.shape
    tiles = f32_tiles(Dh)
    strides = []
    for t in (q, k, v):
        sb, st, sh, _ = t.stride()
        strides += [sb, st, sh]
    if max(strides) >= 2**31 or B * H * -(-T // min(tiles.fwd_rows, tiles.bwd_keys)) >= 2**31:
        raise InvalidArgumentError("flash attention: shape past the kernels' 32-bit indexing")
    pair = (tiles.bwd_keys, tiles.bwd_rows) if backward else (tiles.fwd_rows, tiles.fwd_keys)
    return _ints([B, H, T, Dh, seq_len, int(causal), *strides, tiles.width, *pair])


def _scale(q) -> float:
    return 1.0 / math.sqrt(q.shape[-1])


def flash_route(device_type: str, dtype: torch.dtype, head_dim: int, byte_strides=(),
                addresses=()) -> str:
    """Which kernels a call takes: ``"plain"`` for CPU tensors,
    ``"f32"`` for float32 on the card, ``"sm90"`` for bfloat16 on the
    card. ``byte_strides`` are the strides in bytes, and ``addresses``
    the data pointers, of the tensors the sm90 kernels read through TMA.
    A bfloat16 call on the card that those kernels do not take raises
    :class:`InvalidArgumentError`: a head dim outside
    ``SM90_HEAD_DIMS``, or a stride or address that is not a multiple
    of ``TMA_ALIGN`` bytes."""
    if device_type == "cpu":
        return "plain"
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise InvalidArgumentError(
            f"flash attention takes {[str(d) for d in _DTYPES]}, got {dtype}")
    if head_dim not in SM90_HEAD_DIMS:
        raise InvalidArgumentError(
            f"bfloat16 flash attention on the card takes head dims {SM90_HEAD_DIMS}, got "
            f"{head_dim}")
    bad = [s for s in byte_strides if s % TMA_ALIGN]
    if bad:
        raise InvalidArgumentError(
            f"bfloat16 flash attention on the card reads through TMA: strides of {bad} bytes "
            f"are not multiples of {TMA_ALIGN}")
    if any(a % TMA_ALIGN for a in addresses):
        raise InvalidArgumentError(
            "bfloat16 flash attention on the card reads through TMA: a base address is not "
            f"{TMA_ALIGN}-byte aligned")
    return "sm90"


def _tma_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """``(batch, token, head)`` element strides of a ``(B, T, H, Dh)``
    view; a dimension of size 1 is never stepped, so it gets the packed
    stride."""
    B, T, H, Dh = t.shape
    packed = (T * H * Dh, H * Dh, Dh)
    return tuple(p if n == 1 else s for n, s, p in zip((B, T, H), t.stride()[:3], packed))


def _route(*tensors) -> str:
    q = tensors[0]
    strides = [2 * s for t in tensors for s in _tma_strides(t)]
    return flash_route(q.device.type, q.dtype, q.shape[-1], strides,
                       [t.data_ptr() for t in tensors])


def _sm90_params(q, seq_len: int, causal: bool, *tensors) -> ctypes.Array:
    """The sm90 launch's int64 parameters: B, H, T, Dh, seq_len, causal,
    ``SM90_TILES``, then the element strides of each tensor read through
    TMA (q, k, v and, for the backward, dO)."""
    B, T, H, Dh = q.shape
    if B * H * -(-T // SM90_TILES.block) >= 2**31:
        raise InvalidArgumentError("flash attention: more CTAs than one grid dimension holds")
    values = [B, H, T, Dh, seq_len, int(causal), *SM90_TILES]
    for t in tensors:
        values += _tma_strides(t)
    return (ctypes.c_longlong * len(values))(*values)


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
    ``seq_len`` (and, when ``causal``, not after the query). Routes by
    :func:`flash_route`."""
    T, seq_len = _check({"q": q, "k": k, "v": v}, causal=causal, seq_len=seq_len)
    route = _route(q, k, v)
    if route == "plain":
        return flash_fwd_plain(q, k, v, scale=_scale(q), causal=causal, seq_len=seq_len)
    launch = flash_fwd_sm90 if route == "sm90" else flash_fwd_f32
    return launch(q, k, v, causal=causal, seq_len=seq_len)


def flash_fwd_f32(q, k, v, *, causal: bool, seq_len=None):
    """:func:`flash_fwd` on the TF32 tensor-core kernel
    ``tdn_flash_fwd_f32`` (3xTF32 products): float32 only, any head dim
    up to ``MAX_HEAD_DIM``."""
    T, seq_len = _check({"q": q, "k": k, "v": v}, causal=causal, seq_len=seq_len)
    scale = _scale(q)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale=scale, causal=causal, seq_len=seq_len)
    if q.dtype != torch.float32:
        raise InvalidArgumentError(f"flash_fwd_f32 takes float32, got {q.dtype}")
    B, _, H, Dh = q.shape
    o = torch.empty((B, T, H, Dh), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    launch = _build.launcher("flash_attention_f32", "tdn_flash_fwd_f32")
    with torch.cuda.device(q.device):
        code = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                      _f32_params(q, k, v, seq_len, causal, backward=False), scale,
                      _stream(q.device))
    _build.check(code, "flash_fwd_f32 launch")
    flash_fwd_f32.launches += 1
    return o, lse


flash_fwd_f32.launches = 0


def flash_fwd_sm90(q, k, v, *, causal: bool, seq_len=None):
    """:func:`flash_fwd` on the tensor-core kernel ``tdn_flash_fwd_sm90``:
    bfloat16 only, head dims ``SM90_HEAD_DIMS``."""
    T, seq_len = _check({"q": q, "k": k, "v": v}, causal=causal, seq_len=seq_len)
    scale = _scale(q)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale=scale, causal=causal, seq_len=seq_len)
    if _route(q, k, v) != "sm90":
        raise InvalidArgumentError(f"flash_fwd_sm90 takes bfloat16, got {q.dtype}")
    B, _, H, Dh = q.shape
    o = torch.empty((B, T, H, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    launch = _build.launcher("flash_attention_sm90", "tdn_flash_fwd_sm90")
    with torch.cuda.device(q.device):
        code = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                      _sm90_params(q, seq_len, causal, q, k, v), scale, _stream(q.device))
    _build.check(code, "flash_fwd_sm90 launch")
    flash_fwd_sm90.launches += 1
    return o, lse


flash_fwd_sm90.launches = 0


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


def _to_bf16(t, on: bool):
    """``t`` rounded to bfloat16 (and back to float32) when ``on``."""
    return t.to(torch.bfloat16).float() if on else t


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, scale, causal, seq_len=None,
                       round_bf16=False):
    """dq of attention (the TPU ``_bwd_dq_kernel``), plain, in float32:
    ``dq = (ds k) * scale`` in q's type; ``round_bf16`` rounds ``ds`` to
    bfloat16 before the product, as the sm90 kernel does."""
    p = _probs(q, k, lse, scale=scale, causal=causal, seq_len=seq_len)
    ds = _to_bf16(_dscores(p, do, v, delta), round_bf16)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, scale, causal, seq_len=None,
                        round_bf16=False):
    """dk and dv of attention (the TPU ``_bwd_dkv_kernel``), plain, in
    float32: ``dk = (ds^T q) * scale`` and ``dv = p^T dO`` in q's type;
    ``round_bf16`` rounds ``p`` and ``ds`` to bfloat16 before the
    products, as the sm90 kernel does."""
    p = _probs(q, k, lse, scale=scale, causal=causal, seq_len=seq_len)
    ds = _to_bf16(_dscores(p, do, v, delta), round_bf16)
    p = _to_bf16(p, round_bf16)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_bwd_plain(q, k, v, do, lse, delta, *, scale, causal, seq_len=None,
                    round_bf16=False):
    """The plain version of :func:`flash_bwd`, :func:`flash_bwd_f32` and
    :func:`flash_bwd_sm90`:
    ``(dq, dk, dv)`` from :func:`flash_bwd_dq_plain` and
    :func:`flash_bwd_dkv_plain`, ``round_bf16`` passed to both."""
    kw = dict(scale=scale, causal=causal, seq_len=seq_len, round_bf16=round_bf16)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


#: Relative error of one round to nearest bfloat16.
BF16_ROUNDING = 2.0**-8


def bf16_rounding_bounds(q, k, v, do, lse, delta, *, scale, causal, seq_len=None):
    """How far the sm90 kernels' bfloat16 rounding of P (forward and
    dV) and dS (dK, dQ) can move each output: every rounded term moves
    by at most ``BF16_ROUNDING`` of its size, so an output moves by at
    most that share of the same product taken over absolute values.
    Returns float32 ``(o, dq, dk, dv)`` bounds, ``(B, T, H, Dh)``; a
    kernel's stated tolerance adds them to the float32 one."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    o_abs = flash_fwd_plain(q, k, v.abs(), scale=scale, causal=causal, seq_len=seq_len)[0]
    p = _probs(q, k, lse, scale=scale, causal=causal, seq_len=seq_len)
    ds = _dscores(p, do, v, delta).abs()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.abs()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.abs()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.abs())
    return tuple(BF16_ROUNDING * t for t in (o_abs, dq, dk, dv))


def _check_bwd(q, k, v, do, lse, delta, causal, seq_len):
    T, seq_len = _check({"q": q, "k": k, "v": v, "do": do}, causal=causal, seq_len=seq_len)
    if not do.is_contiguous():
        raise InvalidArgumentError("do must be contiguous (B, T, H, Dh)")
    B, _, H, _ = q.shape
    _check_rows(lse, "lse", (B, H, T), q.device)
    _check_rows(delta, "delta", (B, H, T), q.device)
    return T, seq_len


def _dq_workspace(q, tile_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A zeroed float32 dq of q's shape and, in the same allocation (one
    memset), the zeroed int32 counters a backward kernel orders its dq
    adds with: one ticket, then a turn counter per (batch x head, query
    tile of ``tile_rows``)."""
    B, T, H, _ = q.shape
    n = q.numel()
    buf = torch.zeros(n + 1 + B * H * -(-T // tile_rows), dtype=torch.float32, device=q.device)
    return buf[:n].view(q.shape), buf[n:].view(torch.int32)


def flash_bwd_f32(q, k, v, do, lse, delta, *, causal: bool, seq_len=None):
    """``(dq, dk, dv)`` of attention in one TF32 tensor-core kernel,
    ``tdn_flash_bwd_f32`` (3xTF32 products), recomputing ``p`` from the
    forward's ``lse``: float32 only; ``do`` is contiguous float32 and
    ``delta = rowsum(dO * O)`` float32 ``(B, H, T)``. dq is summed into
    a zeroed float32 output in key-block order, so two calls on one
    input give the same bits."""
    T, seq_len = _check_bwd(q, k, v, do, lse, delta, causal, seq_len)
    scale = _scale(q)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, scale=scale, causal=causal,
                               seq_len=seq_len)
    if q.dtype != torch.float32:
        raise InvalidArgumentError(f"flash_bwd_f32 takes float32, got {q.dtype}")
    dq, order = _dq_workspace(q, f32_tiles(q.shape[3]).bwd_rows)
    dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    launch = _build.launcher("flash_attention_f32", "tdn_flash_bwd_f32")
    with torch.cuda.device(q.device):
        code = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                      lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), order.data_ptr(),
                      _f32_params(q, k, v, seq_len, causal, backward=True),
                      scale, _stream(q.device))
    _build.check(code, "flash_bwd_f32 launch")
    flash_bwd_f32.launches += 1
    return dq, dk, dv


flash_bwd_f32.launches = 0


def flash_bwd_sm90(q, k, v, do, lse, delta, *, causal: bool, seq_len=None):
    """``(dq, dk, dv)`` of attention in one tensor-core kernel,
    ``tdn_flash_bwd_sm90``: bfloat16 only, head dims ``SM90_HEAD_DIMS``;
    arguments as :func:`flash_bwd_f32`. dq is summed in a zeroed float32
    workspace in a fixed order (two calls on one input give the same
    bits) and cast to q's type."""
    T, seq_len = _check_bwd(q, k, v, do, lse, delta, causal, seq_len)
    scale = _scale(q)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, scale=scale, causal=causal,
                               seq_len=seq_len)
    if _route(q, k, v, do) != "sm90":
        raise InvalidArgumentError(f"flash_bwd_sm90 takes bfloat16, got {q.dtype}")
    dq_accum, order = _dq_workspace(q, SM90_TILES.wg_rows)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    launch = _build.launcher("flash_attention_sm90", "tdn_flash_bwd_sm90")
    with torch.cuda.device(q.device):
        code = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                      lse.data_ptr(), delta.data_ptr(), dq_accum.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), order.data_ptr(),
                      _sm90_params(q, seq_len, causal, q, k, v, do), scale, _stream(q.device))
    _build.check(code, "flash_bwd_sm90 launch")
    flash_bwd_sm90.launches += 1
    return dq_accum.to(q.dtype), dk, dv


flash_bwd_sm90.launches = 0


def flash_bwd(q, k, v, do, lse, delta, *, causal: bool, seq_len=None):
    """``(dq, dk, dv)`` of attention, routed by :func:`flash_route`: the
    fused sm90 kernel for bfloat16 on the card, the fused f32 kernel for
    float32, the plain version for CPU tensors."""
    T, seq_len = _check_bwd(q, k, v, do, lse, delta, causal, seq_len)
    kw = dict(causal=causal, seq_len=seq_len)
    route = _route(q, k, v, do)
    if route == "plain":
        return flash_bwd_plain(q, k, v, do, lse, delta, scale=_scale(q), **kw)
    launch = flash_bwd_sm90 if route == "sm90" else flash_bwd_f32
    return launch(q, k, v, do, lse, delta, **kw)


def _flash_bwd(q, k, v, o, lse, g, *, causal, seq_len=None):
    """The VJP: ``delta`` from the float32 cotangent (a torch op, as the
    JAX package leaves it to XLA), the kernels fed the cotangent in q's
    type, contiguous and 16-byte aligned (TMA's rule)."""
    delta = (g.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
    do = g.to(q.dtype).contiguous()
    if do.data_ptr() % TMA_ALIGN:
        do = do.clone()
    return flash_bwd(q, k, v, do, lse, delta, causal=causal, seq_len=seq_len)


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
    """The kernels for CUDA tensors (routed by dtype), ``dot_product_attention``
    for CPU tensors."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal)
    from tpu_dist_nn_torch.models.transformer import dot_product_attention

    return dot_product_attention(q, k, v, causal=causal)


def default_attn_fn():
    """The attention the trainers use when none is given:
    :func:`select_attention`."""
    return select_attention
