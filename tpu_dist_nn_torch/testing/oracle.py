"""Float64 numpy oracle: the port's numerical ground truth.

A copy of the dense path of :mod:`tpu_dist_nn.testing.oracle`, which
re-implements the reference's single-process baseline
(``scripts/manual_nn.py:23-70``):

* per-neuron ``dot(a, weights) + bias`` in float64,
* whole-layer softmax for a softmax layer (manual_nn.py:42-44,59-61),
* otherwise per-neuron activation with linear fallback
  (manual_nn.py:63-68),
* dimension-mismatch raises ValueError (manual_nn.py:51-53).
"""

from __future__ import annotations

import numpy as np

from tpu_dist_nn_torch.core.schema import ModelSpec


def _np_softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - np.max(x, axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def _np_gelu(x):
    # tanh approximation, matching jax.nn.gelu's default.
    return 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x**3)))


_SCALAR_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": lambda x: np.maximum(0, x),
    "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "tanh": np.tanh,
    "gelu": _np_gelu,
}


def oracle_forward(model: ModelSpec, input_vector) -> np.ndarray:
    """Single-example forward, per-neuron loop, float64 (manual_nn.py:23-70)."""
    a = np.asarray(input_vector, dtype=np.float64).reshape(-1)
    for idx, layer in enumerate(model.layers):
        if layer.in_dim != a.shape[0]:
            raise ValueError(
                f"Dimension mismatch in layer {idx}: input dimension {a.shape[0]} "
                f"does not match number of weights {layer.in_dim}"
            )
        # Per-neuron dot products (column j of the (in,out) matrix is
        # neuron j's weight row, schema.LayerSpec.from_neurons).
        z = np.array(
            [
                np.dot(a, layer.weights[:, j]) + layer.biases[j]
                for j in range(layer.out_dim)
            ]
        )
        act = layer.activation.lower()
        if act == "softmax":
            a = _np_softmax(z)
        else:
            a = _SCALAR_ACTIVATIONS.get(act, lambda x: x)(z)
    return a


def oracle_forward_batch(model: ModelSpec, inputs) -> np.ndarray:
    """Batched oracle: loop of single-example forwards, stacked."""
    return np.stack([oracle_forward(model, x) for x in np.asarray(inputs)])
