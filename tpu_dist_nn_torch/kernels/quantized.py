"""Int8 quantized inference: weight quantization + the fused int8 chain.

Port of :mod:`tpu_dist_nn.kernels.quantized` (``quantize_fcnn``,
``forward_quantized``, ``fcnn_quantized_forward``):

* **Per-output-channel symmetric int8 weights** — ``scale_j =
  max|W[:, j]| / 127``, computed in numpy exactly as the JAX package
  does, so both packages hold the same codes and scales.
* **Dynamic per-row activation quantization** — each row gets its own
  scale (``max|x_i| / 127``, floored at 1e-8), codes round half to even
  and clip to ±127; the product is int8 x int8 -> int32, rescaled to
  f32 for bias and activation.
* **One kernel for the whole chain** (``csrc/int8_chain.cu``, replacing
  the Pallas ``_chain_kernel``): activations re-quantize between layers
  in shared memory and never reach HBM; the products run on the int8
  tensor cores, on weights packed once into the MMA operands' order
  (:func:`pack_wq`, the ``"wq_packed"`` entry of :func:`quantize_fcnn`).

:func:`forward_quantized` is the plain version: the same arithmetic,
operation for operation, in PyTorch. The int8 dot runs as a float64
matmul, which is exact here (every product and partial sum is an
integer far below 2**53) and runs on both the CPU and the card. The
kernel matches it bit for bit for relu and linear interiors.

The JAX package routes chains with an interior width under 128 to its
jnp path, a TPU v5e measurement; that gate is not carried over: on a
CUDA tensor the kernel runs at every width. ``prefer_kernel=False``
asks for the plain version explicitly.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tpu_dist_nn_torch.core.activations import apply_activation_by_id
from tpu_dist_nn_torch.kernels import _build
from tpu_dist_nn_torch.kernels.fused_dense import (
    MAX_LAYERS,
    _check_tensor,
    _ints,
    _layer_acts,
    _ptrs,
    _sm_count,
    _stream,
    int8_plan,
)
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError


def pack_wq(wq: torch.Tensor) -> torch.Tensor:
    """``(K, N)`` int8 codes -> the int8 chain kernel's B operands, flat
    int8 on the same device: K zero-padded to a multiple of 64, N to a
    multiple of 8, then for each 32-deep k step ``S`` and 8-column tile
    ``j`` the 256 bytes of one ``mma.m16n8k32`` B fragment: lane ``4g +
    t`` holds column ``8j + g`` at k ``32S + 4t + q`` (its first 4
    bytes, q = 0..3) and ``32S + 16 + 4t + q`` (the next 4)."""
    K, N = wq.shape
    kp, np_ = -(-K // 64) * 64, -(-N // 8) * 8
    w = torch.zeros((kp, np_), dtype=torch.int8, device=wq.device)
    w[:K, :N] = wq
    # k = 32S + 16r + 4t + q, n = 8j + g  ->  (S, j, g, t, r, q)
    w = w.reshape(kp // 32, 2, 4, 4, np_ // 8, 8).permute(0, 4, 5, 2, 1, 3)
    return w.contiguous().reshape(-1)


def unpack_wq(packed: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """The inverse of :func:`pack_wq`: ``(K, N)`` int8 codes."""
    kp, np_ = -(-K // 64) * 64, -(-N // 8) * 8
    w = packed.reshape(kp // 32, np_ // 8, 8, 4, 2, 4).permute(0, 4, 3, 5, 1, 2)
    return w.reshape(kp, np_)[:K, :N].contiguous()


def quantize_fcnn(params) -> list[dict]:
    """f32 FCNN params -> per-layer ``{"wq" int8, "wq_packed" int8,
    "scale" f32 (Dout,), "b" f32, "act"}`` with symmetric
    per-output-channel scales, on the params' device. ``wq_packed`` is
    ``wq`` in the int8 chain kernel's operand order (:func:`pack_wq`),
    made once here; the plain version reads ``wq``."""
    out = []
    for p in params:
        dev = p["w"].device
        w = p["w"].detach().cpu().numpy().astype(np.float32)
        absmax = np.maximum(np.abs(w).max(axis=0), 1e-8)
        scale = (absmax / 127.0).astype(np.float32)
        wq = torch.from_numpy(np.clip(np.round(w / scale), -127, 127).astype(np.int8)).to(dev)
        out.append(
            {
                "wq": wq,
                "wq_packed": pack_wq(wq),
                "scale": torch.from_numpy(scale).to(dev),
                "b": p["b"].detach().to(torch.float32).contiguous(),
                "act": int(p["act"]),
            }
        )
    return out


def _quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8: -> (x_q int8, row_scale f32 (M, 1))."""
    absmax = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-8)
    # Divide by a tensor, not a Python number: on CUDA, PyTorch turns
    # division by a host scalar into a multiply by its reciprocal, which
    # is not the IEEE division the kernel and the JAX package do.
    s = absmax / torch.full_like(absmax, 127.0)
    xq = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return xq, s


def _int8_layer(x, wq, scale, b, act: int):
    """One quantized layer on f32 input ``x``: exact int dot + rescale."""
    xq, sx = _quantize_rows(x)
    z = xq.to(torch.float64) @ wq.to(torch.float64)  # exact integer sums
    y = z.to(torch.float32) * (sx * scale[None, :]) + b
    return apply_activation_by_id(y, act)


def forward_quantized(qparams: Sequence[dict], x: torch.Tensor,
                      activations: Sequence[str] | None = None) -> torch.Tensor:
    """The plain version: the exact arithmetic of the fused kernel."""
    acts = _layer_acts(qparams, activations)
    x = x.to(torch.float32)
    for p, act in zip(qparams, acts):
        x = _int8_layer(x, p["wq"], p["scale"], p["b"], act)
    return x


def fcnn_quantized_forward(qparams, x, *, activations: Sequence[str] | None = None,
                           prefer_kernel: bool | None = None) -> torch.Tensor:
    """The whole int8 chain in one kernel launch
    (:func:`~tpu_dist_nn_torch.kernels.fused_dense.int8_plan`).

    ``qparams`` from :func:`quantize_fcnn` on x's device; ``x`` is
    ``(M, in_dim)`` float32 of any width. Returns ``(M, out_dim)``
    float32. ``prefer_kernel=False`` runs :func:`forward_quantized`
    instead.
    """
    if prefer_kernel is False:
        return forward_quantized(qparams, x, activations)
    if not isinstance(x, torch.Tensor):
        raise InvalidArgumentError(f"x must be a torch.Tensor, got {type(x).__name__}")
    dev = x.device
    _check_tensor(x, "x", (torch.float32,), dev)
    if x.dim() != 2:
        raise InvalidArgumentError(f"x must be 2-D (rows, features), got {tuple(x.shape)}")
    if not qparams or len(qparams) > MAX_LAYERS:
        raise InvalidArgumentError(f"the chain kernel takes 1..{MAX_LAYERS} layers, got {len(qparams)}")
    acts = _layer_acts(qparams, activations)
    dims = [int(x.shape[1])]
    for i, p in enumerate(qparams):
        _check_tensor(p["wq"], f"layer {i} wq", (torch.int8,), dev)
        _check_tensor(p["scale"], f"layer {i} scale", (torch.float32,), dev)
        _check_tensor(p["b"], f"layer {i} b", (torch.float32,), dev)
        wq = p["wq"]
        if (wq.dim() != 2 or wq.shape[0] != dims[-1]
                or p["scale"].shape != (wq.shape[1],) or p["b"].shape != (wq.shape[1],)):
            raise InvalidArgumentError(
                f"layer {i}: shape mismatch: input width {dims[-1]}, wq{tuple(wq.shape)}, "
                f"scale{tuple(p['scale'].shape)}, b{tuple(p['b'].shape)}"
            )
        dims.append(int(wq.shape[1]))
    if dev.type == "cpu":  # the plain version has no shared-memory limit
        return forward_quantized(qparams, x, activations)
    for i, p in enumerate(qparams):
        want = -(-dims[i] // 64) * 64 * (-(-dims[i + 1] // 8) * 8)
        if "wq_packed" not in p:
            raise InvalidArgumentError(f"layer {i}: no wq_packed (make qparams with quantize_fcnn)")
        _check_tensor(p["wq_packed"], f"layer {i} wq_packed", (torch.int8,), dev)
        if p["wq_packed"].shape != (want,):
            raise InvalidArgumentError(
                f"layer {i}: wq_packed{tuple(p['wq_packed'].shape)} is not pack_wq of "
                f"wq{tuple(p['wq'].shape)} ({want} codes)")
    M = int(x.shape[0])
    plan = int8_plan(dims, M, _sm_count(dev))
    out = torch.empty((M, dims[-1]), dtype=torch.float32, device=dev)
    if M == 0:
        return out
    launch = _build.launcher("int8_chain")
    with torch.cuda.device(dev):
        code = launch(
            x.data_ptr(), out.data_ptr(), M,
            _ptrs([p["wq_packed"] for p in qparams]), _ptrs([p["scale"] for p in qparams]),
            _ptrs([p["b"] for p in qparams]), _ints(dims), _ints(acts), len(qparams),
            plan.tm, plan.ldh, plan.ldq, plan.kc, plan.smem_bytes, _stream(dev),
        )
    _build.check(code, "fcnn_quantized_forward launch")
    fcnn_quantized_forward.launches += 1
    return out


fcnn_quantized_forward.launches = 0
