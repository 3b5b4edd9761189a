"""Float64 numpy oracle: the port's numerical ground truth.

A copy of :mod:`tpu_dist_nn.testing.oracle`, which re-implements the
reference's single-process baseline (``scripts/manual_nn.py:23-70``)
and extends it with conv2d / maxpool2d layers:

* per-neuron ``dot(a, weights) + bias`` in float64,
* whole-layer softmax for a softmax layer (manual_nn.py:42-44,59-61),
* otherwise per-neuron activation with linear fallback
  (manual_nn.py:63-68),
* dimension-mismatch raises ValueError (manual_nn.py:51-53);
* a direct float64 conv (XLA's SAME split) and max-pool, with flat
  vectors at every layer boundary; softmax on a conv layer normalises
  each pixel's channel vector.
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


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA SAME-padding split (lo = total // 2)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv2d_np(x: np.ndarray, w: np.ndarray, stride, padding) -> np.ndarray:
    """Direct float64 conv: x (H,W,C), w (kh,kw,cin,cout) -> (OH,OW,cout)."""
    kh, kw, _, cout = w.shape
    sh, sw = stride
    if padding.lower() == "same":
        (pt, pb), (pl, pr) = _same_pad(x.shape[0], kh, sh), _same_pad(x.shape[1], kw, sw)
        x = np.pad(x, ((pt, pb), (pl, pr), (0, 0)))
    oh = (x.shape[0] - kh) // sh + 1
    ow = (x.shape[1] - kw) // sw + 1
    out = np.zeros((oh, ow, cout))
    for i in range(oh):
        for j in range(ow):
            patch = x[i * sh : i * sh + kh, j * sw : j * sw + kw, :]
            out[i, j] = np.tensordot(patch, w, axes=([0, 1, 2], [0, 1, 2]))
    return out


def _maxpool2d_np(x: np.ndarray, window, stride) -> np.ndarray:
    kh, kw = window
    sh, sw = stride
    oh = (x.shape[0] - kh) // sh + 1
    ow = (x.shape[1] - kw) // sw + 1
    out = np.zeros((oh, ow, x.shape[2]))
    for i in range(oh):
        for j in range(ow):
            out[i, j] = x[i * sh : i * sh + kh, j * sw : j * sw + kw, :].max(axis=(0, 1))
    return out


def oracle_forward(model: ModelSpec, input_vector) -> np.ndarray:
    """Single-example forward, per-neuron loop, float64 (manual_nn.py:23-70),
    extended with conv2d / maxpool2d layers."""
    a = np.asarray(input_vector, dtype=np.float64).reshape(-1)
    for idx, layer in enumerate(model.layers):
        if layer.in_dim != a.shape[0]:
            raise ValueError(
                f"Dimension mismatch in layer {idx}: input dimension {a.shape[0]} "
                f"does not match number of weights {layer.in_dim}"
            )
        act = layer.activation.lower()
        if layer.kind == "maxpool2d":
            img = a.reshape(layer.in_shape)
            a = _maxpool2d_np(img, layer.window, layer.eff_stride).reshape(-1)
            continue
        if layer.kind == "conv2d":
            img = a.reshape(layer.in_shape)
            # Softmax acts on the last axis of the NHWC image: each
            # pixel's channel vector, not the flattened layer output.
            z = _conv2d_np(img, layer.weights, layer.stride, layer.padding) + layer.biases
        else:
            # Per-neuron dot products (column j of the (in,out) matrix is
            # neuron j's weight row, schema.LayerSpec.from_neurons).
            z = np.array(
                [
                    np.dot(a, layer.weights[:, j]) + layer.biases[j]
                    for j in range(layer.out_dim)
                ]
            )
        if act == "softmax":
            a = _np_softmax(z).reshape(-1)
        else:
            a = _SCALAR_ACTIVATIONS.get(act, lambda x: x)(z).reshape(-1)
    return a


def oracle_forward_batch(model: ModelSpec, inputs) -> np.ndarray:
    """Batched oracle: loop of single-example forwards, stacked."""
    return np.stack([oracle_forward(model, x) for x in np.asarray(inputs)])
