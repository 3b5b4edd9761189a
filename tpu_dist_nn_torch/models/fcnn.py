"""Fully-connected network: params + forward.

Port of :mod:`tpu_dist_nn.models.fcnn`. Params are a list of
``{"w": (in, out), "b": (out,), "act": int}`` dicts; each layer
computes ``activation(x @ W + b)`` (the reference's per-node compute,
``grpc_node.py:75-97``). The activation id is a plain Python int: torch
runs eagerly, so nothing is traced and nothing is read back from the
device to dispatch on it.

The JAX package leaves this product to XLA, outside Pallas, so here it
is a library ``torch.matmul``; the hand-written whole-chain kernel that
computes the same function is :func:`tpu_dist_nn_torch.kernels.
fused_dense.fcnn_fused_forward`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tpu_dist_nn_torch.core.activations import activation_id, apply_activation_by_id
from tpu_dist_nn_torch.core.schema import LayerSpec, ModelSpec
from tpu_dist_nn_torch.utils.device import resolve_device


def params_from_spec(model: ModelSpec, dtype=torch.float32, device=None) -> list[dict]:
    """Materialize params from a ModelSpec on ``device`` (default: cuda)."""
    dev = resolve_device(device)
    return [
        {
            "w": torch.as_tensor(layer.weights, dtype=dtype, device=dev).contiguous(),
            "b": torch.as_tensor(layer.biases, dtype=dtype, device=dev).contiguous(),
            "act": activation_id(layer.activation),
        }
        for layer in model.layers
    ]


def params_from_jax(params: Sequence[dict], dtype=torch.float32, device=None) -> list[dict]:
    """JAX-package params (``[{"w", "b", "act"}]``, any array type that
    numpy reads) -> port params, so both packages compute the same thing."""
    dev = resolve_device(device)
    return [
        {
            "w": torch.as_tensor(np.array(p["w"]), dtype=dtype, device=dev).contiguous(),
            "b": torch.as_tensor(np.array(p["b"]), dtype=dtype, device=dev).contiguous(),
            "act": int(np.asarray(p["act"])),
        }
        for p in params
    ]


def spec_from_params(
    params: Sequence[dict],
    activations: Sequence[str],
    metadata: dict | None = None,
) -> ModelSpec:
    """Back-convert params to the JSON-exportable ModelSpec.

    ``activations`` supplies names (ids are not reversible to arbitrary
    unknown names). The last layer is tagged "output", the rest "hidden",
    matching the exporter convention (notebook cell 10).
    """
    if len(activations) != len(params):
        raise ValueError(
            f"need {len(params)} activation names, got {len(activations)}"
        )
    n = len(params)
    layers = [
        LayerSpec(
            weights=p["w"].detach().cpu().double().numpy(),
            biases=p["b"].detach().cpu().double().numpy(),
            activation=act,
            type_tag="output" if i == n - 1 else "hidden",
        )
        for i, (p, act) in enumerate(zip(params, activations))
    ]
    return ModelSpec(layers=layers, metadata=dict(metadata or {}))


def init_fcnn(
    generator: torch.Generator,
    layer_sizes: Sequence[int],
    activations: Sequence[str] | None = None,
    dtype=torch.float32,
    device=None,
) -> list[dict]:
    """He-initialized params for ``layer_sizes = [in, h1, ..., out]``.

    Weights are drawn on the CPU from ``generator`` (so a seed gives the
    same model on every device) and then moved. Default activations:
    relu on hidden layers, softmax on the output.
    """
    dev = resolve_device(device)
    n_layers = len(layer_sizes) - 1
    if activations is None:
        activations = ["relu"] * (n_layers - 1) + ["softmax"]
    if len(activations) != n_layers:
        raise ValueError(f"need {n_layers} activations, got {len(activations)}")
    params = []
    for i in range(n_layers):
        fan_in, fan_out = layer_sizes[i], layer_sizes[i + 1]
        w = torch.randn((fan_in, fan_out), generator=generator, dtype=dtype)
        params.append(
            {
                "w": (w * (2.0 / fan_in) ** 0.5).to(dev),
                "b": torch.zeros((fan_out,), dtype=dtype, device=dev),
                "act": activation_id(activations[i]),
            }
        )
    return params


def forward(params: Sequence[dict], x: torch.Tensor) -> torch.Tensor:
    """Forward pass ``x: (batch, in_dim) -> (batch, out_dim)``; each step
    is ``activation(x @ W + b)`` (grpc_node.py:87-90)."""
    for p in params:
        x = apply_activation_by_id(x @ p["w"] + p["b"], p["act"])
    return x


def forward_logits(params: Sequence[dict], x: torch.Tensor) -> torch.Tensor:
    """Forward pass that skips the final layer's activation (raw logits
    for a cross-entropy loss)."""
    for p in params[:-1]:
        x = apply_activation_by_id(x @ p["w"] + p["b"], p["act"])
    p = params[-1]
    return x @ p["w"] + p["b"]
