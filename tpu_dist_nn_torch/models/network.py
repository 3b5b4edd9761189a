"""Mixed-layer network execution: dense + conv2d + maxpool2d chains.

Port of :mod:`tpu_dist_nn.models.network`. Layer structure (kinds,
shapes, strides) lives in a tuple of :class:`LayerPlan`; weights live in
a params list (``{"w", "b"}`` per dense or conv layer, ``{}`` per pool).
Every layer boundary stays a flat ``(B, features)`` vector, as in the
JAX package and the reference's Matrix wire shape; conv layers view
their input as NHWC.

Dispatch in :func:`network_forward` (the JAX package's
``TDN_PALLAS_CONV`` switch has no counterpart: convs always take the
kernel):

* a conv layer, with a maxpool that directly follows it, is one
  :func:`~tpu_dist_nn_torch.kernels.conv2d.fused_conv2d` call;
* a maxpool that follows no conv is plain torch (the JAX package's
  ``reduce_window``, outside Pallas);
* each maximal run of dense layers is :func:`dense_forward`: one
  :func:`~tpu_dist_nn_torch.kernels.fused_dense.fcnn_fused_forward`
  launch per segment that
  :func:`~tpu_dist_nn_torch.kernels.fused_dense.chain_segments` cuts
  (one for the CIFAR tail), as the dense engine serves (JAX leaves
  these products to XLA).

On the card the CIFAR conv+MLP network is three launches a batch.

Training runs :func:`network_forward_lax` and :func:`network_logits`
instead: plain differentiable PyTorch ops, as the JAX package trains on
lax ops (``pallas_call`` has no VJP there; the kernels here have no
backward). The serving forward stays on the kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tpu_dist_nn_torch.core.activations import ACTIVATION_NAMES, activation_id, apply_activation
from tpu_dist_nn_torch.core.schema import Conv2DSpec, LayerSpec, MaxPool2DSpec, ModelSpec
from tpu_dist_nn_torch.kernels.conv2d import fused_conv2d, maxpool_nhwc, same_pad
from tpu_dist_nn_torch.kernels.fused_dense import chain_segments, fcnn_fused_forward, fused_dense
from tpu_dist_nn_torch.kernels.quantized import fcnn_quantized_forward
from tpu_dist_nn_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Static per-layer structure."""

    kind: str
    activation: str
    in_shape: tuple | None = None  # conv/pool: (H, W, C)
    stride: tuple | None = None
    padding: str | None = None
    window: tuple | None = None


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device).contiguous()


def build_network(model: ModelSpec, dtype=torch.float32, device=None):
    """ModelSpec -> (plan, params) with params on ``device`` (default: cuda)."""
    dev = resolve_device(device)
    plan = []
    params = []
    for layer in model.layers:
        if isinstance(layer, LayerSpec):
            plan.append(LayerPlan(kind="dense", activation=layer.activation))
        elif isinstance(layer, Conv2DSpec):
            plan.append(LayerPlan(
                kind="conv2d", activation=layer.activation,
                in_shape=tuple(layer.in_shape), stride=tuple(layer.stride),
                padding=layer.padding.upper(),
            ))
        elif isinstance(layer, MaxPool2DSpec):
            plan.append(LayerPlan(
                kind="maxpool2d", activation="linear", in_shape=tuple(layer.in_shape),
                stride=tuple(layer.eff_stride), window=tuple(layer.window),
            ))
            params.append({})
            continue
        else:
            raise ValueError(f"unsupported layer kind: {layer.kind}")
        params.append({"w": _tensor(layer.weights, dtype, dev),
                       "b": _tensor(layer.biases, dtype, dev)})
    return tuple(plan), params


def network_params_from_jax(params, dtype=torch.float32, device=None) -> list[dict]:
    """JAX-package network params (a list of ``{"w", "b"}`` or ``{}`` per
    layer, any array type numpy reads) -> port params, so both packages
    compute the same thing."""
    dev = resolve_device(device)
    return [{k: _tensor(p[k], dtype, dev) for k in ("w", "b")} if p else {} for p in params]


def _conv(p: LayerPlan, w: dict, x: torch.Tensor, pool: LayerPlan | None) -> torch.Tensor:
    h, wd, c = p.in_shape
    out = fused_conv2d(
        x.reshape(-1, h, wd, c), w["w"], w["b"], stride=p.stride,
        padding=p.padding.lower(), activation=p.activation,
        pool_window=pool.window if pool is not None else None,
        pool_stride=pool.stride if pool is not None else None,
    )
    return out.reshape(out.shape[0], -1)


def dense_forward(params, x: torch.Tensor, *, quantized: bool = False) -> torch.Tensor:
    """A dense run of any depth and width, as :func:`chain_segments`
    cuts it: each segment one chain launch (``fcnn_fused_forward``, or
    ``fcnn_quantized_forward`` with ``quantized`` and the params of
    ``quantize_fcnn``) or one ``fused_dense`` launch. A cut int8 run
    stays bit-equal to ``forward_quantized``: the chain re-quantises
    every layer's f32 activation whether it sits in shared or in device
    memory. A cut f32 run rounds as the uncut one does, in another
    summation order. uint8 ``x`` goes to an f32 chain as it is (the
    kernel converts on load); a ``fused_dense`` or int8 segment takes
    it cast to float32, the same values."""
    key = "wq" if quantized else "w"
    dims = (int(x.shape[1]), *(int(p[key].shape[1]) for p in params))
    acts = tuple(int(p["act"]) for p in params)
    for seg in chain_segments(dims, acts, "int8" if quantized else "float32"):
        part = params[seg.start:seg.stop]
        if x.dtype == torch.uint8 and (seg.dense or quantized):
            x = x.to(torch.float32)
        if seg.dense:
            p = part[0]
            x = fused_dense(x, p["w"], p["b"], activation=ACTIVATION_NAMES[int(p["act"])])
        elif quantized:
            x = fcnn_quantized_forward(part, x)
        else:
            x = fcnn_fused_forward(part, x)
    return x


def network_forward(plan: Sequence[LayerPlan], params, x: torch.Tensor) -> torch.Tensor:
    """Forward ``x: (B, in_dim)`` float32 -> ``(B, out_dim)``."""
    i = 0
    while i < len(plan):
        p = plan[i]
        if p.kind == "conv2d":
            # A directly-following maxpool fuses into the conv kernel;
            # the spec's validate_chain made its in_shape the conv's out.
            pool = plan[i + 1] if i + 1 < len(plan) and plan[i + 1].kind == "maxpool2d" else None
            x = _conv(p, params[i], x, pool)
            i += 2 if pool is not None else 1
        elif p.kind == "maxpool2d":
            h, wd, c = p.in_shape
            out = maxpool_nhwc(x.reshape(-1, h, wd, c), p.window, p.stride)
            x = out.reshape(out.shape[0], -1)
            i += 1
        else:
            j = i
            while j < len(plan) and plan[j].kind == "dense":
                j += 1
            chain = [{"w": params[k]["w"], "b": params[k]["b"],
                      "act": activation_id(plan[k].activation)} for k in range(i, j)]
            x = dense_forward(chain, x.contiguous())
            i = j
    return x


def _apply_layer(p: LayerPlan, w: dict, x: torch.Tensor) -> torch.Tensor:
    """One layer on a flat batch ``x: (B, in_dim)`` -> ``(B, out_dim)``
    in plain differentiable ops (the JAX ``_apply_layer``)."""
    if p.kind == "dense":
        return apply_activation(x @ w["w"] + w["b"], p.activation)
    h, wd, c = p.in_shape
    imgs = x.reshape(-1, h, wd, c).permute(0, 3, 1, 2)  # NHWC viewed as NCHW
    if p.kind == "conv2d":
        kh, kw = w["w"].shape[:2]
        if p.padding == "SAME":
            (pt, pb), (pl, pr) = same_pad(h, kh, p.stride[0]), same_pad(wd, kw, p.stride[1])
            imgs = F.pad(imgs, (pl, pr, pt, pb))
        out = F.conv2d(imgs, w["w"].permute(3, 2, 0, 1), stride=p.stride)
        out = apply_activation(out.permute(0, 2, 3, 1) + w["b"], p.activation)
    elif p.kind == "maxpool2d":
        out = F.max_pool2d(imgs, p.window, p.stride).permute(0, 2, 3, 1)
    else:
        raise ValueError(f"unsupported layer kind: {p.kind}")
    return out.reshape(out.shape[0], -1)


def network_forward_lax(plan: Sequence[LayerPlan], params, x: torch.Tensor) -> torch.Tensor:
    """The training-time forward, every layer's activation applied: the
    JAX ``network_forward_lax`` (``models/network.py:164-174``) on plain
    differentiable ops: ``F.conv2d`` on NHWC viewed as NCHW (lax's SAME
    split of the padding), ``F.max_pool2d``, ``x @ w + b`` and the
    activations of :mod:`~tpu_dist_nn_torch.core.activations`. The JAX
    package computes these ops outside any Pallas kernel, so the
    library's conv here (cuDNN on a card) is its own lax path, not a
    port of a kernel; :func:`network_forward` serves on the kernels. The
    heterogeneous pipeline's backward recomputes a stage with this
    function, so its forward runs it too."""
    for p, w in zip(plan, params):
        x = _apply_layer(p, w, x)
    return x


def network_logits(plan: Sequence[LayerPlan], params, x: torch.Tensor) -> torch.Tensor:
    """:func:`network_forward_lax` with the final layer's activation
    skipped: the training entry (cross-entropy takes raw logits), as the
    JAX ``network_logits``."""
    for p, w in zip(plan[:-1], params[:-1]):
        x = _apply_layer(p, w, x)
    return _apply_layer(dataclasses.replace(plan[-1], activation="linear"), params[-1], x)


def network_model_from_params(model: ModelSpec, params) -> ModelSpec:
    """Write params back into a copy of the spec (export leg)."""
    new_layers = []
    for layer, w in zip(model.layers, params):
        if w:
            new_layers.append(dataclasses.replace(
                layer,
                weights=w["w"].detach().cpu().double().numpy(),
                biases=w["b"].detach().cpu().double().numpy(),
            ))
        else:
            new_layers.append(layer)
    return ModelSpec(new_layers, dict(model.metadata))


def init_conv_mlp(
    generator: torch.Generator,
    *,
    in_shape=(32, 32, 3),
    conv_filters=(16, 32),
    kernel_size=(3, 3),
    hidden=(64,),
    num_classes=10,
    pool_after_conv=True,
) -> ModelSpec:
    """Random CIFAR-style conv+MLP hybrid (BASELINE configs[3] shape):
    [conv-relu(-maxpool)]* -> dense-relu* -> dense-softmax, He-normal
    weights drawn from ``generator`` in float64, zero biases."""
    def he(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float64)
        return (w * np.sqrt(2.0 / fan_in)).numpy()

    layers = []
    h, w, c = in_shape
    kh, kw = kernel_size
    for f in conv_filters:
        layers.append(Conv2DSpec(
            in_shape=(h, w, c), weights=he((kh, kw, c, f), kh * kw * c),
            biases=np.zeros(f), stride=(1, 1), padding="same", activation="relu",
        ))
        h, w, c = layers[-1].out_shape
        if pool_after_conv:
            layers.append(MaxPool2DSpec(in_shape=(h, w, c), window=(2, 2)))
            h, w, c = layers[-1].out_shape
    sizes = [h * w * c, *hidden, num_classes]
    for i in range(len(sizes) - 1):
        last = i == len(sizes) - 2
        layers.append(LayerSpec(
            weights=he((sizes[i], sizes[i + 1]), sizes[i]),
            biases=np.zeros(sizes[i + 1]),
            activation="softmax" if last else "relu",
            type_tag="output" if last else "hidden",
        ))
    return ModelSpec(layers=layers)
