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
``block_b``, a TPU tiling knob, is not carried over. The kernel is an
implicit GEMM whose K (taps x input channels) streams in slices, over
tiles of conv pixels: no image width or channel count is refused.
:func:`conv_plan` picks the tiling and owns the kernel's shared-memory
layout.

For CPU tensors the wrapper runs :func:`fused_conv2d_plain`; for CUDA
tensors it launches the kernel or raises. ``fused_conv2d.launches``
counts kernel launches.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from tpu_dist_nn_torch.core.activations import activation_id, apply_activation_by_id
from tpu_dist_nn_torch.kernels import _build
from tpu_dist_nn_torch.kernels.fused_dense import SMEM_LIMIT_BYTES, _check_tensor, _ints, _stream
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

#: Conv pixels and output channels a thread computes (csrc kPix, kChan).
PIX_PER_THREAD = 4
CHANNELS_PER_GROUP = 16
#: Pixels a CTA of 8 warps computes with one channel group; with CG
#: groups each warp takes one group, so a CTA computes 1024 / CG pixels.
_CTA_PIXELS = 8 * 32 * PIX_PER_THREAD
#: Input channels a K slice takes at most.
_MAX_CK = 64
#: Shared memory of a CTA when two share an SM (228 KB, 1 KB each reserved).
_TWO_CTAS_BYTES = 113 * 1024
#: Activations a register-held 2x2 pool takes: max commutes with them
#: (and with the bias) exactly.
_REGISTER_POOL_ACTS = (activation_id("linear"), activation_id("relu"))


def same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """lax's SAME split for any stride: ``total = max((ceil(size/s) - 1)
    * s + k - size, 0)``, ``total // 2`` before and the rest after."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Output geometry and the kernel's tiling for one call
    (:func:`conv_args` lays it out as csrc/conv2d.cu's ``ConvArgs``)."""

    out_shape: tuple[int, int, int, int]  # (B, ph, pw, Cout): pooled output
    conv_hw: tuple[int, int]  # conv output (oh, ow) before the pool
    pad: tuple[int, int]  # leading (top, left) padding
    pool: tuple[int, int, int, int]  # (wh, ww, sh, sw); all 1 without a pool
    cg: int  # channel groups of 16 a CTA computes
    imgs: int  # images a tile covers
    tile: tuple[int, int]  # pooled rows and columns a tile covers
    conv_tile: tuple[int, int]  # conv rows and columns a tile computes
    cin: int  # the layer's input channels
    ck: int  # input channels per K slice
    patch: tuple[int, int, int, int, int]  # pixel, row, image strides; rows, columns
    patch_floats: int  # one slot's patch, rounded up to 4 floats
    stage_floats: int  # one slot: patch, then weights
    ldt: int  # conv-tile pixel stride (odd)
    grid: tuple[int, int, int, int]  # image groups, row tiles, column tiles, channel tiles
    pool_regs: bool  # a 2x2/2 pool of relu or linear values taken in registers
    smem_bytes: int

    @property
    def slices(self) -> int:
        return -(-self.cin // self.ck)



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


def _patch_layout(ck, imgs, cr, ccw, kh, kw, stride, rows_apart):
    """(cs, prs, pimg, prow, pcol): the patch's pixel stride is odd (a
    warp's 16 or 32 consecutive pixels of a row fall in distinct banks)
    and ``rows_apart`` row strides are 16 more than a multiple of 32
    floats (when a tile is 16 columns wide a warp's two half-warps read
    rows that far apart, csrc ``pixel_slot``: opposite bank halves)."""
    prow, pcol = (cr - 1) * stride[0] + kh, (ccw - 1) * stride[1] + kw
    cs = ck | 1
    step = 32 // rows_apart
    prs = pcol * cs + (16 // rows_apart - pcol * cs) % step
    return cs, prs, prow * prs, prow, pcol


def _tile_shape(ph, pw, pool, mt):
    """Pooled rows x columns of a tile whose conv pixels (whole windows)
    fit ``mt``, cut evenly; None when not one window fits."""
    pwh, pww, psh, psw = pool
    tpc = min(pw, (mt - pww) // psw + 1) if pww <= mt else 0
    while tpc >= 1:
        ccw = (tpc - 1) * psw + pww
        if pwh * ccw <= mt:
            tpr = min(ph, (mt // ccw - pwh) // psh + 1)
            tiles_y, tiles_x = -(-ph // tpr), -(-pw // tpc)
            return -(-ph // tiles_y), -(-pw // tiles_x)
        tpc -= 1
    return None


def conv_plan(imgs_shape, w_shape, stride=(1, 1), padding="valid",
              pool_window=None, pool_stride=None, activation="linear") -> ConvPlan:
    """Validate the shapes and pick the kernel's tiling (see
    csrc/conv2d.cu). A CTA computes ``1024 / cg`` conv pixels of 16 cg
    channels (cg = 1 for up to 16 channels, else 2; softmax needs every
    channel in one CTA, so there cg covers Cout); its tile covers whole
    pool windows, several images when one image is smaller; K streams in
    slices of up to 64 input channels (the widest whose two-slot ring
    lets two CTAs share an SM, where one does), so no image width or
    channel count is refused. A 2x2 stride-2 pool of relu or linear
    values is taken in registers (``pool_regs``). Raises :class:`InvalidArgumentError` on a bad
    shape, a softmax over more than 128 channels, or a pool window of
    more conv pixels than a CTA computes. Cached: a serving loop asks for
    the same plan every batch."""
    return _conv_plan(tuple(int(d) for d in imgs_shape), tuple(int(d) for d in w_shape),
                      tuple(int(s) for s in stride), padding,
                      None if pool_window is None else tuple(int(k) for k in pool_window),
                      None if pool_stride is None else tuple(int(k) for k in pool_stride),
                      activation)


@functools.lru_cache(maxsize=1024)
def _conv_plan(imgs_shape, w_shape, stride, padding, pool_window, pool_stride,
               activation) -> ConvPlan:
    out_shape, conv_hw, pad, pool = _geometry(
        imgs_shape, w_shape, stride, padding, pool_window, pool_stride)
    B, ph, pw, cout = out_shape
    kh, kw, cin, _ = (int(d) for d in w_shape)
    act = activation_id(activation)
    softmax = act == activation_id("softmax")
    groups = -(-cout // CHANNELS_PER_GROUP)
    if softmax and groups > 8:
        raise InvalidArgumentError(
            f"fused_conv2d: a softmax over {cout} channels; the conv kernel normalises "
            f"at most {8 * CHANNELS_PER_GROUP} channels of a pixel in one CTA")
    cg = (1 << (groups - 1).bit_length() if softmax
          else min(groups, max(1, 32 // CHANNELS_PER_GROUP)))  # 32 channels a CTA
    nct = CHANNELS_PER_GROUP * cg
    mt = _CTA_PIXELS // cg
    shape = _tile_shape(ph, pw, pool, mt)
    if shape is None:
        raise InvalidArgumentError(
            f"fused_conv2d: a {pool[0]}x{pool[1]} pool window is more than the {mt} conv "
            "pixels one CTA computes")
    ldt = nct | 1
    while True:
        tpr, tpc = shape
        cr, ccw = (tpr - 1) * pool[2] + pool[0], (tpc - 1) * pool[3] + pool[1]
        whole = tpr == ph and tpc == pw
        imgs = max(1, min(B, mt // (cr * ccw))) if whole else 1
        # The main path's pool: relu (or linear) values pooled 2x2 in
        # registers, with no conv tile in shared memory.
        pool_regs = (pool == (2, 2, 2, 2) and act in _REGISTER_POOL_ACTS
                     and ccw in (16, 32) and cr * ccw % (32 * PIX_PER_THREAD) == 0)
        cks = ([cin] if cin <= _MAX_CK else []) + [c for c in (64, 32, 16, 8, 4, 2, 1)
                                                    if c < min(cin, _MAX_CK + 1)]
        for budget in (_TWO_CTAS_BYTES, SMEM_LIMIT_BYTES):
            for ck in cks:
                cs, prs, pimg, prow, pcol = _patch_layout(
                    ck, imgs, cr, ccw, kh, kw, stride, 2 if pool_regs and ccw == 16 else 1)
                patch_floats = -(-imgs * pimg // 4) * 4
                stage = patch_floats + kh * kw * ck * nct
                stages = 2 if ck < cin else 1
                smem = 4 * max(stages * stage, 0 if pool_regs else mt * ldt)
                if smem <= budget:
                    grid = (-(-B // imgs), -(-ph // tpr), -(-pw // tpc), -(-cout // nct))
                    return ConvPlan(out_shape, conv_hw, pad, pool, cg, imgs, (tpr, tpc),
                                    (cr, ccw), cin, ck, (cs, prs, pimg, prow, pcol),
                                    patch_floats, stage, ldt, grid, pool_regs, smem)
        # Not even one input channel of this tile's patch fits: halve the
        # tile (rows first).
        if tpr > 1:
            shape = (-(-tpr // 2), tpc)
        elif tpc > 1:
            shape = (1, -(-tpc // 2))
        else:
            raise InvalidArgumentError(
                f"fused_conv2d: the patch of one pooled pixel ({kh}x{kw} kernel, stride "
                f"{tuple(stride)}, pool {pool_window}) is over the {SMEM_LIMIT_BYTES}-byte "
                "limit of a Hopper block")


def conv_args(plan: ConvPlan, imgs_shape, w_shape, stride, activation) -> list[int]:
    """csrc/conv2d.cu's ``ConvArgs``, in its order."""
    B, H, W, cin = (int(d) for d in imgs_shape)
    kh, kw, _, cout = (int(d) for d in w_shape)
    _, ph, pw, _ = plan.out_shape
    return [B, H, W, cin, kh, kw, cout, *(int(s) for s in stride), *plan.pad, *plan.pool,
            ph, pw, activation_id(activation), plan.cg, plan.imgs, *plan.tile, *plan.conv_tile,
            plan.ck, *plan.patch, plan.patch_floats, plan.stage_floats, plan.ldt,
            *plan.grid[1:], int(plan.pool_regs), plan.smem_bytes]


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
    plan = conv_plan(imgs.shape, w.shape, stride, padding, pool_window, pool_stride, activation)
    out = torch.empty(plan.out_shape, dtype=torch.float32, device=dev)
    if imgs.shape[0] == 0:
        return out
    launch = _build.launcher("conv2d")
    with torch.cuda.device(dev):
        code = launch(imgs.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                      _ints(conv_args(plan, imgs.shape, w.shape, stride, activation)),
                      _stream(dev))
    _build.check(code, "fused_conv2d launch")
    fused_conv2d.launches += 1
    return out


fused_conv2d.launches = 0
