"""Fused dense kernels: one layer, and the whole FCNN chain.

Port of :mod:`tpu_dist_nn.kernels.fused_dense`:

* :func:`fused_dense` — ``act(x @ W + b)`` in one kernel
  (``csrc/fused_dense.cu``, replacing the Pallas ``_dense_kernel``).
* :func:`fcnn_fused_forward` — every layer of an FCNN in one kernel,
  inter-layer activations kept in shared memory
  (``csrc/fcnn_chain.cu``, replacing the Pallas ``_chain_kernel``).

Both run on one FP32 tile (``csrc/f32_tile.cuh``): 256 threads in two K
groups, an R x TN register tile each (8 x 8 at the flagship), K streamed
in 64-deep slices through a 3-slot ``cp.async`` ring. The planners here
choose each launch's shape from the widths, the batch and the card
(:func:`dense_plan`, :func:`chain_plan`); they are plain functions, so
the CPU tests check their choices and emulate the kernels' loops with
them.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else. For CPU tensors it runs its plain PyTorch version
(``*_plain``); for CUDA tensors it launches its kernel or raises — there
is no fallback from the card to the plain version. ``launches`` on each
wrapper counts kernel launches.

The TPU package gates the chain kernel on an 8 MB VMEM weight budget
and falls back to the jnp chain above it. Here weights stream from L2
and the input streams through the ring, so neither is limited: the
limit of one launch is that 8 rows of the interior activations fit a
block's shared memory beside the ring (:func:`chain_plan`), and a chain
past it raises, as one past :data:`MAX_LAYERS` layers does.
:func:`chain_segments` cuts a dense run of any depth and width into
launches that fit (the int8 chain's too); the engine and the conv
network serve through it (``models/network.py::dense_forward``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from tpu_dist_nn_torch.core.activations import ACTIVATION_IDS, apply_activation_by_id
from tpu_dist_nn_torch.kernels import _build
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

#: Dynamic shared memory one Hopper block may opt into (227 KB).
SMEM_LIMIT_BYTES = 232448
#: The chain kernels' cap on layers (csrc kMaxLayers).
MAX_LAYERS = 32
#: SMs of an H100 SXM: the planners' count for tensors off the card.
H100_SMS = 132
# The FP32 tile's constants (csrc/f32_tile.cuh): rows per CTA (8 row
# groups times R) for fused_dense and for the chain, K per slice, ring
# slots, floats per A row in a slot, widest column pass.
_F32_TILE_ROWS = (64, 32, 16, 8)
_CHAIN_TILE_ROWS = (64, 72, 8)
_BK = 64
_STAGES = 3
_A_STRIDE = _BK + 4
_MAX_PASS = 128
_SOFTMAX = ACTIVATION_IDS["softmax"]


def activation_ids(activations: Sequence[str]) -> tuple[int, ...]:
    """Names -> ids, rejecting unknown names (the fused kernels take an
    explicit activation; only model files map unknown names to linear)."""
    ids = []
    for name in activations:
        if name not in ACTIVATION_IDS:
            raise InvalidArgumentError(f"unknown activation for fused kernel: {name}")
        ids.append(ACTIVATION_IDS[name])
    return tuple(ids)


def _layer_acts(params, activations) -> tuple[int, ...]:
    if activations is None:
        return tuple(int(p["act"]) for p in params)
    acts = activation_ids(activations)
    if len(acts) != len(params):
        raise InvalidArgumentError(
            f"need {len(params)} activations, got {len(acts)}"
        )
    return acts


def _check_tensor(t: torch.Tensor, name: str, dtypes, device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise InvalidArgumentError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise InvalidArgumentError(f"{name} is on {t.device}, x is on {device}")
    if t.dtype not in dtypes:
        raise InvalidArgumentError(
            f"{name} has dtype {t.dtype}; expected one of {[str(d) for d in dtypes]}"
        )
    if not t.is_contiguous():
        raise InvalidArgumentError(f"{name} must be contiguous")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


# ---------------------------------------------------------------------------
# Planners
# ---------------------------------------------------------------------------

def _device_index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


def _sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        return H100_SMS
    return _cuda_sm_count(_device_index(device))


@functools.lru_cache(maxsize=None)
def _cuda_sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fills(ctas: int, sm_count: int) -> bool:
    """At least 90% of the SMs get a CTA (128 of 132: the flagship's one
    wave of 64-row tiles)."""
    return 10 * ctas >= 9 * sm_count


def pass_tn(remaining: int, max_tn: int = 8) -> int:
    """Columns a thread takes in a pass that starts with ``remaining``
    columns left: the pass is 16 x TN wide, TN the smallest of 1, 2, 4, 8
    that covers them, at most ``max_tn`` (csrc ``pass_tn``)."""
    tn = 8 if remaining > 64 else 4 if remaining > 32 else 2 if remaining > 16 else 1
    return min(max_tn, tn)


def column_passes(dout: int, first_layer: bool = True) -> list[tuple[int, int]]:
    """A chain layer's column passes, ``(first column, width)``: up to
    128 columns wide in the first layer, 64 in the later ones (csrc
    ``max_pass_tn``)."""
    passes, c0 = [], 0
    while c0 < dout:
        width = 16 * pass_tn(dout - c0, 8 if first_layer else 4)
        passes.append((c0, width))
        c0 += width
    return passes


@functools.lru_cache(maxsize=1024)
def dense_plan(M: int, N: int, sm_count: int = H100_SMS) -> tuple[int, int]:
    """``fused_dense``'s tile, ``(tm, tn)``: ``tm`` rows by ``16 tn``
    columns a CTA; ``tn`` from N's width, ``tm`` the tallest whose grid
    fills the SMs (else the shortest, for the most CTAs)."""
    tn = pass_tn(N)
    col_tiles = -(-N // (16 * tn))
    for tm in _F32_TILE_ROWS:
        if _fills(-(-M // tm) * col_tiles, sm_count):
            return tm, tn
    return _F32_TILE_ROWS[-1], tn


class ChainPlan(NamedTuple):
    """One ``fcnn_chain`` launch: ``tm`` rows a row tile, ``split`` CTAs
    (one cluster) a row tile, the resident buffers' row widths ``ld0``
    (dims[1], dims[3], ...) and ``ld1`` (dims[2], ...), and the block's
    dynamic shared memory."""

    tm: int
    split: int
    ld0: int
    ld1: int
    smem_bytes: int


def k_ranges(K: int) -> list[tuple[int, int]]:
    """Layer 0's K ranges, ``[kb, ke)`` each, of whole 64-deep slices: 8
    from 32 slices, 2 from 16, else one (csrc ``k_ranges``). A lone CTA
    adds the ranges' sums in this order, and a split-K cluster gives each
    rank one range, so a row's result does not depend on the plan its
    batch took."""
    slices = -(-K // _BK)
    n = 8 if slices >= 32 else 2 if slices >= 16 else 1
    per = -(-slices // n)
    return [(min(K, r * per * _BK), min(K, (r + 1) * per * _BK)) for r in range(n)]


def _row_stride(width: int) -> int:
    """A resident buffer's row stride: a multiple of 4 floats (rows are
    read 16 bytes at a time), not of 32 (a warp reads two adjacent rows
    at once: 32 floats apart they would share banks); 0 for no buffer."""
    ld = -(-width // 4) * 4
    return ld + 4 if ld and ld % 32 == 0 else ld


def _buffer_widths(dims: Sequence[int], acts: Sequence[int]) -> tuple[int, int]:
    """Row strides of the two resident buffers (:func:`_row_stride`):
    every interior boundary; the last one when its softmax is wider
    than one pass (128 columns in the first layer, 64 after); dims[1]
    when layer 0's K has more than one range (:func:`k_ranges`): the
    ranges' sums gather there."""
    L = len(dims) - 1
    ranged = len(k_ranges(dims[0])) > 1
    one_pass = _MAX_PASS if L == 1 else _MAX_PASS // 2  # the last layer's widest pass
    widths = [0, 0]
    for bnd in range(1, L + 1):
        if (bnd < L or (acts[-1] == _SOFTMAX and dims[L] > one_pass)
                or (bnd == 1 and ranged)):
            widths[(bnd - 1) % 2] = max(widths[(bnd - 1) % 2], dims[bnd])
    return tuple(_row_stride(w) for w in widths)


def chain_plan(dims: Sequence[int], acts: Sequence[int], M: int, sm_count: int = H100_SMS,
               device_index: int | None = None,
               what: str = "fcnn_fused_forward") -> ChainPlan:
    """The f32 chain's launch. Among the row tiles (64, 72, 8 rows) whose
    ring and resident buffers fit a block's shared memory and the splits
    (1, or one CTA a K range of :func:`k_ranges`) whose clusters the card
    runs all at once (:func:`max_clusters`), the first that fills the
    SMs, trying 64-row tiles before 72 and no split before one; if none
    fills, the one with the most CTAs. The 72-row tile is for a batch of
    1024: 16 clusters of 8 would not run at once, 15 do. Raises
    :class:`InvalidArgumentError` naming the limit when not even 8 rows
    of the interior widths fit. Cached: a serving loop asks for the same
    plan every batch."""
    return _chain_plan(tuple(dims), tuple(acts), M, sm_count, device_index, what)


def _chain_smem(tm: int, ld0: int, ld1: int) -> int:
    """Bytes of the chain kernel's ring and resident buffers."""
    return 4 * (_STAGES * (tm * _A_STRIDE + _BK * _MAX_PASS) + tm * (ld0 + ld1))


#: Clusters of the chain kernel an H100 SXM runs at once, by split, one
#: CTA an SM (cudaOccupancyMaxActiveClusters on the card): clusters of 4
#: and of 8 fill only 120 of the 132 SMs.
_H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}


@functools.lru_cache(maxsize=1024)
def max_clusters(device_index: int | None, tm: int, split: int, smem: int,
                 sm_count: int = H100_SMS) -> int:
    """How many clusters of ``split`` chain CTAs run at once: asked of
    the card for a CUDA device, else the H100 figures scaled to
    ``sm_count``."""
    if device_index is None:
        return _H100_CLUSTERS[split] * sm_count // H100_SMS
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        code = _build.launcher("fcnn_chain", "tdn_fcnn_chain_max_clusters")(
            tm, split, smem, ctypes.byref(n))
    _build.check(code, "fcnn_chain max clusters")
    return n.value


@functools.lru_cache(maxsize=1024)
def _chain_plan(dims, acts, M, sm_count, device_index, what) -> ChainPlan:
    ranges = len(k_ranges(dims[0]))
    ld0, ld1 = _buffer_widths(dims, acts)
    best = None
    for tm in _CHAIN_TILE_ROWS:
        tiles = -(-M // tm)
        smem = _chain_smem(tm, ld0, ld1)
        if smem > SMEM_LIMIT_BYTES:
            continue
        for split in dict.fromkeys((1, ranges)):
            plan = ChainPlan(tm, split, ld0, ld1, smem)
            if split > 1 and tiles > max_clusters(device_index, tm, split, smem, sm_count):
                continue
            if _fills(tiles * split, sm_count):
                return plan
            if best is None or tiles * split > -(-M // best.tm) * best.split:
                best = plan
    if best is not None:
        return best
    tm = _CHAIN_TILE_ROWS[-1]
    need = _chain_smem(tm, ld0, ld1)
    raise InvalidArgumentError(
        f"{what}: {tm} rows of the interior activations ({ld0} + {ld1} floats wide) "
        f"and the K-slice ring need {need} bytes of shared memory, over the "
        f"{SMEM_LIMIT_BYTES}-byte limit of a Hopper block; the chain kernel cannot "
        "run these widths"
    )


# The int8 chain's constants (csrc/int8_chain.cu): its cp.async ring of
# 64-deep slices of up to 128 packed columns, the widest input it
# quantises from registers, its row tiles (largest first).
_I8_RING_BYTES = 4 * 2 * 16 * 256
_I8_REG_COLS = 1024
_I8_TILE_ROWS = (64, 32, 16)


class Int8Plan(NamedTuple):
    """One ``int8_chain`` launch: ``tm`` rows a tile, the resident f32
    activations' row stride ``ldh`` (floats), the int8 codes' row stride
    ``ldq`` (bytes, 16 more than a multiple of 128), ``kc`` the widest
    input whose codes stay resident (a multiple of 64; a wider layer-0
    input is quantised ``kc`` columns at a time), and the block's
    dynamic shared memory."""

    tm: int
    ldh: int
    ldq: int
    kc: int
    smem_bytes: int


def _int8_layout(dims: Sequence[int], tm: int) -> Int8Plan:
    interior = max(dims[1:-1], default=0)
    kc = -(-max(interior, min(dims[0], _I8_REG_COLS)) // 64) * 64
    ldq = kc + (16 - kc) % 128
    ldh = _row_stride(interior)
    return Int8Plan(tm, ldh, ldq, kc, _I8_RING_BYTES + tm * ldq + 4 * tm * (ldh + 1))


def int8_plan(dims: Sequence[int], M: int, sm_count: int = H100_SMS) -> Int8Plan:
    """The int8 chain's launch: among the row tiles whose layout fits a
    block's shared memory, the tallest whose tiles give every SM two
    CTAs (one streams its input while the other multiplies), else the
    shortest. Raises :class:`InvalidArgumentError` naming the limit when
    not even 16 rows of the interior widths fit."""
    return _int8_plan(tuple(dims), M, sm_count)


@functools.lru_cache(maxsize=1024)
def _int8_plan(dims, M, sm_count) -> Int8Plan:
    fitting = [_int8_layout(dims, tm) for tm in _I8_TILE_ROWS]
    fitting = [p for p in fitting if p.smem_bytes <= SMEM_LIMIT_BYTES]
    if not fitting:
        need = _int8_layout(dims, _I8_TILE_ROWS[-1]).smem_bytes
        raise InvalidArgumentError(
            f"fcnn_quantized_forward: {_I8_TILE_ROWS[-1]} rows of the interior activations and codes "
            f"({max(dims[1:-1])} wide) and the weight ring need {need} bytes of shared "
            f"memory, over the {SMEM_LIMIT_BYTES}-byte limit of a Hopper block; the chain "
            "kernel cannot run these widths")
    for plan in fitting:
        if _fills(-(-M // plan.tm), 2 * sm_count):
            return plan
    return fitting[-1]


class Segment(NamedTuple):
    """Layers ``[start, stop)`` of a dense run in one launch: of the
    chain kernel, or (``dense``) of ``fused_dense`` for one layer the
    f32 chain cannot hold (a softmax or a split-K sum wider than its
    shared memory)."""

    start: int
    stop: int
    dense: bool = False


def _fits(dims: tuple, acts: tuple, dtype: str) -> bool:
    if dtype == "int8":
        return _int8_layout(dims, _I8_TILE_ROWS[-1]).smem_bytes <= SMEM_LIMIT_BYTES
    ld0, ld1 = _buffer_widths(dims, acts)
    return _chain_smem(_CHAIN_TILE_ROWS[-1], ld0, ld1) <= SMEM_LIMIT_BYTES


def chain_segments(dims: Sequence[int], acts: Sequence[int],
                   dtype: str = "float32") -> tuple[Segment, ...]:
    """Cut a dense run (widths ``dims``, activation ids ``acts``) into
    launches, ``dtype`` "float32" (:func:`fcnn_fused_forward`) or "int8"
    (the int8 chain): pure shape arithmetic. A chain takes at most
    :data:`MAX_LAYERS` layers and ends before the first interior
    boundary whose resident rows would not fit the kernel's shared
    memory at its smallest row tile; the next chain streams that wide
    activation as its input, which both kernels take at any width. A
    single f32 layer that does not fit even alone runs as ``fused_dense``
    (which takes a softmax of any width in a second pass). Every layer
    lands in exactly one segment, in order. Cached: a serving loop asks
    for the same cut every batch."""
    if dtype not in ("float32", "int8"):
        raise InvalidArgumentError(f"chain_segments: dtype {dtype!r}; float32 or int8")
    return _chain_segments(tuple(int(d) for d in dims), tuple(int(a) for a in acts), dtype)


@functools.lru_cache(maxsize=1024)
def _chain_segments(dims, acts, dtype) -> tuple[Segment, ...]:
    segments, start, layers = [], 0, len(acts)
    while start < layers:
        if not _fits(dims[start:start + 2], acts[start:start + 1], dtype):
            segments.append(Segment(start, start + 1, dense=True))
            start += 1
            continue
        stop = start + 1
        while (stop < layers and stop - start < MAX_LAYERS
               and _fits(dims[start:stop + 2], acts[start:stop + 1], dtype)):
            stop += 1
        segments.append(Segment(start, stop))
        start = stop
    return tuple(segments)


# ---------------------------------------------------------------------------
# Single fused layer
# ---------------------------------------------------------------------------

def fused_dense_plain(x, w, b, activation: str = "linear") -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_dense`."""
    (act,) = activation_ids([activation])
    return apply_activation_by_id(x @ w + b, act)


def fused_dense(x, w, b, *, activation: str = "linear") -> torch.Tensor:
    """``act(x @ W + b)`` in one kernel: ``x (M, K)``, ``w (K, N)``,
    ``b (N,)``, all float32 on one device; returns ``(M, N)`` float32."""
    (act,) = activation_ids([activation])
    dev = x.device if isinstance(x, torch.Tensor) else None
    for t, name in ((x, "x"), (w, "w"), (b, "b")):
        _check_tensor(t, name, (torch.float32,), dev)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] or b.shape != (w.shape[1],):
        raise InvalidArgumentError(
            f"shape mismatch: x{tuple(x.shape)} @ w{tuple(w.shape)} + b{tuple(b.shape)}"
        )
    if dev.type == "cpu":
        return fused_dense_plain(x, w, b, activation)
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    tm, tn = dense_plan(M, N, _sm_count(dev))
    launch = _build.launcher("fused_dense")
    with torch.cuda.device(dev):
        code = launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                      M, K, N, act, tm, tn, _stream(dev))
    _build.check(code, "fused_dense launch")
    fused_dense.launches += 1
    return out


fused_dense.launches = 0


# ---------------------------------------------------------------------------
# Whole-chain kernel
# ---------------------------------------------------------------------------

def _chain_dims(params, x) -> list[int]:
    dims = [int(x.shape[1])]
    for i, p in enumerate(params):
        w, b = p["w"], p["b"]
        if w.dim() != 2 or w.shape[0] != dims[-1] or b.shape != (w.shape[1],):
            raise InvalidArgumentError(
                f"layer {i}: shape mismatch: input width {dims[-1]}, "
                f"w{tuple(w.shape)}, b{tuple(b.shape)}"
            )
        dims.append(int(w.shape[1]))
    return dims


def fcnn_fused_forward_plain(params, x, *, activations=None,
                             input_scale: float | None = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`fcnn_fused_forward`."""
    acts = _layer_acts(params, activations)
    h = x.to(torch.float32)
    if input_scale is not None:
        h = h * input_scale
    for p, act in zip(params, acts):
        h = apply_activation_by_id(h @ p["w"] + p["b"], act)
    return h


def fcnn_fused_forward(params, x, *, activations: Sequence[str] | None = None,
                       input_scale: float | None = None) -> torch.Tensor:
    """The whole FCNN chain in one kernel launch (:func:`chain_plan`).

    ``params``: the :mod:`tpu_dist_nn_torch.models.fcnn` list (float32
    ``w``/``b`` on x's device). ``x``: ``(M, in_dim)`` float32, or uint8
    pixels that the kernel scales by ``input_scale`` on load (1 byte per
    feature over the host link instead of 4). Returns ``(M, out_dim)``
    float32. ``activations`` (names) overrides the params' ids.
    """
    if not isinstance(x, torch.Tensor):
        raise InvalidArgumentError(f"x must be a torch.Tensor, got {type(x).__name__}")
    dev = x.device
    _check_tensor(x, "x", (torch.float32, torch.uint8), dev)
    if x.dim() != 2:
        raise InvalidArgumentError(f"x must be 2-D (rows, features), got {tuple(x.shape)}")
    if not params or len(params) > MAX_LAYERS:
        raise InvalidArgumentError(f"the chain kernel takes 1..{MAX_LAYERS} layers, got {len(params)}")
    acts = _layer_acts(params, activations)
    for i, p in enumerate(params):
        _check_tensor(p["w"], f"layer {i} w", (torch.float32,), dev)
        _check_tensor(p["b"], f"layer {i} b", (torch.float32,), dev)
    dims = _chain_dims(params, x)
    if dev.type == "cpu":  # the plain version has no shared-memory limit
        return fcnn_fused_forward_plain(params, x, activations=activations,
                                        input_scale=input_scale)
    M = int(x.shape[0])
    plan = chain_plan(dims, acts, M, _sm_count(dev),
                      _device_index(dev) if dev.type == "cuda" else None)
    out = torch.empty((M, dims[-1]), dtype=torch.float32, device=dev)
    if M == 0:
        return out
    launch = _build.launcher("fcnn_chain", "tdn_fcnn_chain")
    scale = 1.0 if input_scale is None else float(input_scale)
    with torch.cuda.device(dev):
        code = launch(
            x.data_ptr(), int(x.dtype == torch.uint8), scale, out.data_ptr(), M,
            _ptrs([p["w"] for p in params]), _ptrs([p["b"] for p in params]),
            _ints(dims), _ints(acts), len(params), plan.tm, plan.split, plan.ld0, plan.ld1,
            _stream(dev),
        )
    _build.check(code, "fcnn_fused_forward launch")
    fcnn_fused_forward.launches += 1
    return out


fcnn_fused_forward.launches = 0
