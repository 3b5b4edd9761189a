"""Fused dense kernels: one layer, and the whole FCNN chain.

Port of :mod:`tpu_dist_nn.kernels.fused_dense`:

* :func:`fused_dense` — ``act(x @ W + b)`` in one kernel
  (``csrc/fused_dense.cu``, replacing the Pallas ``_dense_kernel``).
* :func:`fcnn_fused_forward` — every layer of an FCNN in one kernel,
  inter-layer activations kept in shared memory
  (``csrc/fcnn_chain.cu``, replacing the Pallas ``_chain_kernel``).

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else. For CPU tensors it runs its plain PyTorch version
(``*_plain``); for CUDA tensors it launches its kernel or raises — there
is no fallback from the card to the plain version. ``launches`` on each
wrapper counts kernel launches.

The TPU package gates the chain kernel on an 8 MB VMEM weight budget
and falls back to the jnp chain above it. Here weights stream from L2,
so there is no weight budget: the limit is that one tile of rows of the
two widest activation buffers fits a block's shared memory
(:func:`chain_tile_rows`), and a chain past it raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from tpu_dist_nn_torch.core.activations import ACTIVATION_IDS, apply_activation_by_id
from tpu_dist_nn_torch.kernels import _build
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

#: Dynamic shared memory one Hopper block may opt into (227 KB).
SMEM_LIMIT_BYTES = 232448
#: Rows per CTA the chain kernels take, largest first (csrc: tm <= 64).
_TILE_ROWS = (64, 32, 16, 8, 4, 2, 1)
#: The chain kernels' caps and fixed shared-memory slices (csrc constants).
MAX_LAYERS = 32
_F32_WSLICE_BYTES = 32 * 128 * 4  # fcnn_chain.cu: kBK x kCW floats


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
    launch = _build.launcher("fused_dense")
    with torch.cuda.device(dev):
        code = launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                      M, K, N, act, _stream(dev))
    _build.check(code, "fused_dense launch")
    fused_dense.launches += 1
    return out


fused_dense.launches = 0


# ---------------------------------------------------------------------------
# Whole-chain kernel
# ---------------------------------------------------------------------------

def boundary_widths(dims: Sequence[int]) -> tuple[int, int]:
    """Widest even and odd layer boundary: the two ping-pong buffers'
    row widths (buffer A holds dims[0], dims[2], ...; B dims[1], ...)."""
    return max(dims[0::2]), max(dims[1::2])


def chain_tile_rows(row_bytes: int, fixed_bytes: int, what: str) -> int:
    """Largest rows-per-CTA whose buffers fit a block's shared memory;
    raises :class:`InvalidArgumentError` naming the limit when not even
    one row fits."""
    for tm in _TILE_ROWS:
        if tm * row_bytes + fixed_bytes <= SMEM_LIMIT_BYTES:
            return tm
    raise InvalidArgumentError(
        f"{what}: one row of activations needs {row_bytes + fixed_bytes} "
        f"bytes of shared memory, over the {SMEM_LIMIT_BYTES}-byte limit of "
        "a Hopper block; the chain kernel cannot run these widths"
    )


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
    """The whole FCNN chain in one kernel per tile of rows.

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
    ld_a, ld_b = boundary_widths(dims)
    tm = chain_tile_rows(4 * (ld_a + ld_b), _F32_WSLICE_BYTES, "fcnn_fused_forward")
    if dev.type == "cpu":
        return fcnn_fused_forward_plain(params, x, activations=activations,
                                        input_scale=input_scale)
    M = int(x.shape[0])
    out = torch.empty((M, dims[-1]), dtype=torch.float32, device=dev)
    if M == 0:
        return out
    launch = _build.launcher("fcnn_chain")
    scale = 1.0 if input_scale is None else float(input_scale)
    with torch.cuda.device(dev):
        code = launch(
            x.data_ptr(), int(x.dtype == torch.uint8), scale, out.data_ptr(), M,
            _ptrs([p["w"] for p in params]), _ptrs([p["b"] for p in params]),
            _ints(dims), _ints(acts), len(params), tm, ld_a, ld_b, _stream(dev),
        )
    _build.check(code, "fcnn_fused_forward launch")
    fcnn_fused_forward.launches += 1
    return out


fcnn_fused_forward.launches = 0
