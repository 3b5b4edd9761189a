"""Fused conv2d + bias + activation (+ max-pool) kernel.

Port of :mod:`tpu_dist_nn.kernels.conv2d`: :func:`fused_conv2d`
computes ``maxpool?(act(conv2d(imgs, w) + b))`` in one launch of
``csrc/conv2d.cu``, which replaces the Pallas ``_conv_kernel``. The
pre-pool activation stays in shared memory: only the pooled output is
written to device memory, which is what the Pallas kernel exists for.

The public function keeps the JAX layouts, ``imgs (B, H, W, Cin)`` NHWC
and ``w (kh, kw, Cin, Cout)`` HWIO, so the tests compare like with
like. The Pallas kernel falls back to XLA for strided convs and for
stages whose lane-padded tile overflows VMEM (the 32x32x3 input stage);
neither limit exists on Hopper, so the kernel here takes SAME and VALID
padding, any stride, and a fused max-pool with any window and stride.
``block_b``, a TPU tiling knob, is not carried over. The limit on the
card is that one band of pooled rows fits a block's shared memory
(:func:`conv_plan`, the one owner of the kernel's shared-memory
layout); past it the wrapper raises.

For CPU tensors the wrapper runs :func:`fused_conv2d_plain`; for CUDA
tensors it launches the kernel or raises. ``fused_conv2d.launches``
counts kernel launches.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tpu_dist_nn_torch.core.activations import activation_id, apply_activation_by_id
from tpu_dist_nn_torch.kernels import _build
from tpu_dist_nn_torch.kernels.fused_dense import SMEM_LIMIT_BYTES, _check_tensor, _ints, _stream
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

#: Shared memory a band aims at: 4 blocks of 256 threads fit one SM.
#: A band whose single row needs more takes up to the 227 KB limit.
BAND_TARGET_BYTES = 48 * 1024
#: Largest weight chunk staged at once (kh * kw * Cin * channels floats).
WEIGHT_CHUNK_BYTES = 64 * 1024


def same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """lax's SAME split for any stride: ``total = max((ceil(size/s) - 1)
    * s + k - size, 0)``, ``total // 2`` before and the rest after."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Output geometry and the kernel's tiling for one call."""

    out_shape: tuple[int, int, int, int]  # (B, ph, pw, Cout): pooled output
    conv_hw: tuple[int, int]  # conv output (oh, ow) before the pool
    pad: tuple[int, int]  # leading (top, left) padding
    pool: tuple[int, int, int, int]  # (wh, ww, sh, sw); all 1 without a pool
    cpt: int  # output channels per thread
    cc: int  # output channels per staged weight chunk
    band: int  # pooled rows per CTA
    smem_floats: tuple[int, int, int]  # (weight chunk, input rows, conv tile)

    @property
    def smem_bytes(self) -> int:
        return 4 * sum(self.smem_floats)


def _smem_floats(kh, kw, cin, cout, stride, pool, pw, band, cc) -> tuple[int, int, int]:
    """Shared-memory floats of one CTA, in csrc/conv2d.cu's order: the
    weight chunk ``(kh*kw*cin, cc)``, the band's input rows (halo
    included) and its conv tile, both at odd pixel strides (C | 1).
    The kernel takes the three as offsets and does not recompute them."""
    pwh, pww, psh, psw = pool
    cw = (pw - 1) * psw + pww
    iw = (cw - 1) * stride[1] + kw
    crm = (band - 1) * psh + pwh
    irm = (crm - 1) * stride[0] + kh
    return kh * kw * cin * cc, irm * iw * (cin | 1), crm * cw * (cout | 1)


def _geometry(imgs_shape, w_shape, stride, padding, pool_window, pool_stride):
    """Validated shapes -> (pooled output shape, conv (oh, ow), leading
    padding, pool (wh, ww, sh, sw)); raises :class:`InvalidArgumentError`."""
    B, H, W, cin = (int(d) for d in imgs_shape)
    kh, kw, cin_w, cout = (int(d) for d in w_shape)
    if cin != cin_w:
        raise InvalidArgumentError(
            f"shape mismatch: imgs{tuple(imgs_shape)} conv w{tuple(w_shape)}"
        )
    sh, sw = (int(s) for s in stride)
    if min(sh, sw, kh, kw, cout) < 1:
        raise InvalidArgumentError(f"conv stride {stride} and kernel {w_shape} must be positive")
    if padding.lower() == "same":
        oh, ow = -(-H // sh), -(-W // sw)
        pad = (same_pad(H, kh, sh)[0], same_pad(W, kw, sw)[0])
    elif padding.lower() == "valid":
        oh, ow = (H - kh) // sh + 1, (W - kw) // sw + 1
        pad = (0, 0)
    else:
        raise InvalidArgumentError(f"unsupported padding: {padding!r}")
    if pool_window is None:
        pool = (1, 1, 1, 1)
    else:
        pwh, pww = (int(k) for k in pool_window)
        psh, psw = (int(s) for s in (pool_stride or pool_window))
        if min(pwh, pww, psh, psw) < 1:
            raise InvalidArgumentError(
                f"pool window {pool_window} and stride {pool_stride} must be positive")
        pool = (pwh, pww, psh, psw)
    ph, pw = (oh - pool[0]) // pool[2] + 1, (ow - pool[1]) // pool[3] + 1
    if min(oh, ow, ph, pw) < 1:
        raise InvalidArgumentError(
            f"conv kernel {(kh, kw)} stride {(sh, sw)} and pool {pool_window} do not "
            f"fit input {(H, W)} (conv output {oh}x{ow}, pooled {ph}x{pw})"
        )
    return (B, ph, pw, cout), (oh, ow), pad, pool


def conv_plan(imgs_shape, w_shape, stride=(1, 1), padding="valid",
              pool_window=None, pool_stride=None) -> ConvPlan:
    """Validate the shapes and pick the kernel's tiling; raises
    :class:`InvalidArgumentError` on a bad shape or when not even one
    pooled row of a band fits a block's shared memory."""
    out_shape, conv_hw, pad, pool = _geometry(
        imgs_shape, w_shape, stride, padding, pool_window, pool_stride)
    kh, kw, cin, cout = (int(d) for d in w_shape)
    ph, pw = out_shape[1:3]
    cpt = next(c for c in (8, 4, 2, 1) if cout >= c)
    cc = -(-cout // cpt) * cpt
    per_channel = 4 * kh * kw * cin
    if cc * per_channel > WEIGHT_CHUNK_BYTES:
        cc = max(cpt, WEIGHT_CHUNK_BYTES // per_channel // cpt * cpt)

    def smem(band, chunk):
        return 4 * sum(_smem_floats(kh, kw, cin, cout, stride, pool, pw, band, chunk))

    if smem(1, cc) > SMEM_LIMIT_BYTES:
        cc = cpt
    if smem(1, cc) > SMEM_LIMIT_BYTES:
        raise InvalidArgumentError(
            f"fused_conv2d: one pooled row needs {smem(1, cc)} bytes of shared "
            f"memory, over the {SMEM_LIMIT_BYTES}-byte limit of a Hopper block; "
            "the conv kernel cannot run this layer"
        )
    budget = BAND_TARGET_BYTES if smem(1, cc) <= BAND_TARGET_BYTES else SMEM_LIMIT_BYTES
    fit = max(b for b in range(1, ph + 1) if smem(b, cc) <= budget)
    n_bands = -(-ph // fit)
    band = -(-ph // n_bands)  # even bands: 16 rows at a fit of 9 run as 8 + 8
    return ConvPlan(out_shape, conv_hw, pad, pool, cpt, cc, band,
                    _smem_floats(kh, kw, cin, cout, stride, pool, pw, band, cc))


def maxpool_nhwc(x: torch.Tensor, window, stride=None) -> torch.Tensor:
    """VALID max-pool of ``(B, H, W, C)`` (floor semantics); ``stride``
    defaults to the window."""
    (wh, ww), (sh, sw) = window, (stride or window)
    return x.unfold(1, wh, sh).unfold(2, ww, sw).amax(dim=(-2, -1))


def fused_conv2d_plain(imgs, w, b, *, stride=(1, 1), padding="valid",
                       activation="linear", pool_window=None,
                       pool_stride=None) -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_conv2d`: the sum over
    taps of strided input slices times ``w[i, j]``, then bias,
    activation (softmax over each pixel's channels) and the max-pool."""
    _, (oh, ow), _, _ = _geometry(imgs.shape, w.shape, stride, padding, pool_window,
                                  pool_stride)
    kh, kw, cin, cout = w.shape
    sh, sw = stride
    x = imgs.to(torch.float32)
    if padding.lower() == "same":
        (pt, pb), (pl, pr) = same_pad(x.shape[1], kh, sh), same_pad(x.shape[2], kw, sw)
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
    rows = x.shape[0] * oh * ow
    z = None
    for i in range(kh):
        for j in range(kw):
            tap = x[:, i : i + sh * (oh - 1) + 1 : sh, j : j + sw * (ow - 1) + 1 : sw, :]
            part = tap.reshape(rows, cin) @ w[i, j]
            z = part if z is None else z + part
    out = apply_activation_by_id((z + b).reshape(x.shape[0], oh, ow, cout),
                                 activation_id(activation))
    if pool_window is not None:
        out = maxpool_nhwc(out, pool_window, pool_stride)
    return out


def fused_conv2d(imgs, w, b, *, stride=(1, 1), padding: str = "valid",
                 activation: str = "linear", pool_window=None,
                 pool_stride=None) -> torch.Tensor:
    """``maxpool?(act(conv2d(imgs, w) + b))`` in one kernel.

    ``imgs (B, H, W, Cin)`` NHWC and ``w (kh, kw, Cin, Cout)`` HWIO,
    ``b (Cout,)``, all float32 and contiguous on one device; returns
    ``(B, OH, OW, Cout)`` float32. ``padding`` is "same" (lax's split)
    or "valid"; ``pool_window`` fuses a VALID max-pool whose
    ``pool_stride`` defaults to the window. The activation name is
    canonicalised first (case-insensitive, unknown names are linear),
    as the JAX network does before its Pallas call.
    """
    if not isinstance(imgs, torch.Tensor):
        raise InvalidArgumentError(f"imgs must be a torch.Tensor, got {type(imgs).__name__}")
    dev = imgs.device
    for t, name in ((imgs, "imgs"), (w, "w"), (b, "b")):
        _check_tensor(t, name, (torch.float32,), dev)
    if imgs.dim() != 4 or w.dim() != 4 or b.shape != (w.shape[3],):
        raise InvalidArgumentError(
            f"shape mismatch: imgs{tuple(imgs.shape)} conv w{tuple(w.shape)} + b{tuple(b.shape)}"
        )
    if dev.type == "cpu":  # the plain version has no shared-memory limit
        return fused_conv2d_plain(imgs, w, b, stride=stride, padding=padding,
                                  activation=activation, pool_window=pool_window,
                                  pool_stride=pool_stride)
    plan = conv_plan(imgs.shape, w.shape, stride, padding, pool_window, pool_stride)
    out = torch.empty(plan.out_shape, dtype=torch.float32, device=dev)
    B, H, W, cin = imgs.shape
    if B == 0:
        return out
    kh, kw, _, cout = w.shape
    _, ph, pw, _ = plan.out_shape
    w_floats, in_floats, _ = plan.smem_floats
    args = (B, H, W, cin, kh, kw, cout, *stride, *plan.pad, *plan.pool, ph, pw,
            activation_id(activation), plan.band, plan.cc, w_floats, w_floats + in_floats,
            plan.smem_bytes)
    launch = _build.launcher("conv2d")
    with torch.cuda.device(dev):
        code = launch(imgs.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                      _ints([int(a) for a in args]), plan.cpt, _stream(dev))
    _build.check(code, "fused_conv2d launch")
    fused_conv2d.launches += 1
    return out


fused_conv2d.launches = 0
