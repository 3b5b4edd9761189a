"""Activation functions by name and by dense id.

Port of :mod:`tpu_dist_nn.core.activations`: the same id order
(``linear, relu, sigmoid, softmax, tanh, gelu``), the same
unknown-name-is-linear rule (the reference node runtime,
``grpc_node.py:72-73``), and a numerically stable softmax over the
last axis. GELU is the tanh form: ``jax.nn.gelu`` defaults to it and
the float64 oracle matches it, while torch's default is the erf form.
The CUDA kernels use the same ids (``kernels/csrc/common.cuh``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Order matters: index == activation id stored in params and passed to
# the kernels. "linear" is id 0.
_ACTIVATION_ORDER = ("linear", "relu", "sigmoid", "softmax", "tanh", "gelu")

ACTIVATION_IDS = {name: i for i, name in enumerate(_ACTIVATION_ORDER)}

#: Public id -> name view (index == activation id).
ACTIVATION_NAMES = _ACTIVATION_ORDER

SOFTMAX_ID = ACTIVATION_IDS["softmax"]

_ACTIVATION_FNS = (
    lambda x: x,
    torch.relu,
    torch.sigmoid,
    lambda x: torch.softmax(x, dim=-1),
    torch.tanh,
    lambda x: F.gelu(x, approximate="tanh"),
)


def activation_id(name: str) -> int:
    """Map an activation name to its dense id; unknown names are linear."""
    return ACTIVATION_IDS.get(name.lower(), 0)


def apply_activation(x: torch.Tensor, name: str) -> torch.Tensor:
    """Apply a named activation."""
    return _ACTIVATION_FNS[activation_id(name)](x)


def apply_activation_by_id(x: torch.Tensor, act_id: int) -> torch.Tensor:
    """Apply the activation with dense id ``act_id``."""
    return _ACTIVATION_FNS[int(act_id)](x)
