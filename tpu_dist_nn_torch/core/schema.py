"""The public JSON model / examples schema, and pipeline partitioning.

A copy of :mod:`tpu_dist_nn.core.schema` for the port, on the pure-
``json`` path: dense, conv2d and maxpool2d layers. The JAX package's
native C++ codec is not carried over (ROADMAP lists it).

This module is the framework's contract with the outside world and is
shared verbatim with the reference system:

* Model files: ``{"layers": [{"type", "nodes", "neurons":
  [{"weights", "bias", "activation"}]}]}``
  (reference ``config/config_sample.json:1-33``).  A neuron's
  ``weights`` list is a row; a layer's weight matrix is the stack of
  neuron rows **transposed** to ``(in_dim, out_dim)`` — the
  materialization rule of the reference node runtime
  (``grpc_node.py:51``).  The layer activation is taken from the first
  neuron (``grpc_node.py:53``).
* Example inputs: ``{"examples": [{"input": [...], "label": k}]}``
  (reference ``config/example_inputs/example_inputs_sample.json``).
* Per-stage configs: ``{"layer_0": [neurons...], "layer_1": [...]}`` —
  the format the reference orchestrator ships to each node via the
  ``NEURONS_CONFIG`` env var (``run_grpc_fcnn.py:208-218`` /
  ``grpc_node.py:46``), kept here as the stage-serialization format.
* Placement: a ``layer_distribution`` vector assigning contiguous layer
  runs to pipeline stages, validated as summing to the total layer
  count (``run_grpc_fcnn.py:182-183``).

The JSON model file doubles as the checkpoint/interchange format (the
reference has no other persistence).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Sequence

import numpy as np


# Parity constants with the reference orchestrator (run_grpc_fcnn.py:18-22):
# stage naming and the port formula survive as stable stage identifiers,
# even though there is no TCP listener behind them on TPU.
STAGE_NAME_PREFIX = "fcnn_node_"
BASE_PORT = 5100
PORT_STRIDE = 100


def stage_port(index: int) -> int:
    """Stable per-stage id, reference port formula (run_grpc_fcnn.py:221)."""
    return BASE_PORT + PORT_STRIDE * index + 1


@dataclasses.dataclass
class LayerSpec:
    """One dense layer: ``act(x @ weights + biases)``.

    ``weights`` is ``(in_dim, out_dim)`` (already transposed from the
    per-neuron row layout, grpc_node.py:51). ``type_tag`` preserves the
    reference's "hidden"/"output" tag for lossless round-trip.
    """

    weights: np.ndarray
    biases: np.ndarray
    activation: str = "linear"
    type_tag: str = "hidden"
    kind: str = "dense"

    @property
    def in_dim(self) -> int:
        return int(self.weights.shape[0])

    @property
    def out_dim(self) -> int:
        return int(self.weights.shape[1])

    def validate(self) -> None:
        if self.weights.ndim != 2:
            raise ValueError(f"dense layer weights must be 2-D, got {self.weights.shape}")
        if self.biases.shape != (self.out_dim,):
            raise ValueError(
                f"bias shape {self.biases.shape} does not match out_dim {self.out_dim}"
            )

    @classmethod
    def from_neurons(cls, layer_json: dict) -> "LayerSpec":
        neurons = layer_json["neurons"]
        if not neurons:
            raise ValueError("layer has no neurons")
        widths = {len(n["weights"]) for n in neurons}
        if len(widths) != 1:
            raise ValueError(
                f"neurons in a layer must have equal weight counts, got {sorted(widths)}"
            )
        rows = np.asarray([n["weights"] for n in neurons], dtype=np.float64)
        weights = rows.T  # (in_dim, out_dim) — grpc_node.py:51
        biases = np.asarray([n["bias"] for n in neurons], dtype=np.float64)
        # All neurons in a layer share the first neuron's activation
        # (grpc_node.py:53).
        activation = neurons[0].get("activation", "linear")
        spec = cls(
            weights=weights,
            biases=biases,
            activation=activation,
            type_tag=layer_json.get("type", "hidden"),
        )
        spec.validate()
        return spec

    def to_neurons(self) -> dict:
        """Export back to the per-neuron JSON layout (notebook cell 10 format)."""
        neurons = [
            {
                "weights": self.weights[:, j].tolist(),
                "bias": float(self.biases[j]),
                "activation": self.activation,
            }
            for j in range(self.out_dim)
        ]
        return {"type": self.type_tag, "nodes": self.out_dim, "neurons": neurons}


@dataclasses.dataclass
class ModelSpec:
    """A whole model: an ordered list of layers plus passthrough metadata.

    ``metadata`` carries any non-"layers" keys of the model file —
    notably ``inference_metrics``, which the reference toolchain embeds
    into exported models (notebook cell 10) — so load→save round-trips.
    """

    layers: list[LayerSpec]
    metadata: dict = dataclasses.field(default_factory=dict)

    @property
    def input_dim(self) -> int:
        return self.layers[0].in_dim

    @property
    def output_dim(self) -> int:
        return self.layers[-1].out_dim

    @property
    def layer_sizes(self) -> list[int]:
        return [self.input_dim] + [l.out_dim for l in self.layers]

    @property
    def is_dense(self) -> bool:
        """True when every layer is dense (the FCNN serving paths apply)."""
        return all(l.kind == "dense" for l in self.layers)

    def validate_chain(self) -> None:
        """Check inter-layer dim consistency (the reference checks this
        per-forward at grpc_node.py:83-84; we fail fast at load)."""
        for i, layer in enumerate(self.layers):
            layer.validate()
            if i > 0 and layer.in_dim != self.layers[i - 1].out_dim:
                raise ValueError(
                    f"layer {i}: input dim {layer.in_dim} does not match "
                    f"previous layer output dim {self.layers[i - 1].out_dim}"
                )

    @classmethod
    def from_json_dict(cls, obj: dict) -> "ModelSpec":
        if not obj.get("layers"):
            raise ValueError("model has no layers")
        layers = [_layer_from_json(lj) for lj in obj["layers"]]
        metadata = {k: v for k, v in obj.items() if k != "layers"}
        spec = cls(layers=layers, metadata=metadata)
        spec.validate_chain()
        return spec

    def to_json_dict(self) -> dict:
        out: dict[str, Any] = {"layers": [_layer_to_json(l) for l in self.layers]}
        out.update(self.metadata)
        return out


def load_model(path: str | Path) -> ModelSpec:
    """Load a model JSON (the pure-``json`` path of the JAX package's
    loader; its native C++ codec is not ported)."""
    with open(path, "rb") as f:
        return ModelSpec.from_json_dict(json.loads(f.read()))


def save_model(model: ModelSpec, path: str | Path) -> None:
    with open(path, "w") as f:
        json.dump(model.to_json_dict(), f)


@dataclasses.dataclass
class Conv2DSpec:
    """A 2-D convolution layer — the CIFAR extension (BASELINE configs[3]).

    The reference has no conv type (its node computes only dense chains,
    grpc_node.py:75-97); the JSON schema is extended with
    ``{"type": "conv2d", "in_shape": [H,W,C], "kernel_size": [kh,kw],
    "stride": [sh,sw], "padding": "same"|"valid", "weights": nested
    (kh,kw,cin,cout), "bias": [cout], "activation": ...}``. Activations
    stay flat vectors at layer boundaries (the reference's Matrix wire
    shape); the layer reshapes to NHWC internally.
    """

    in_shape: tuple[int, int, int]  # (H, W, C)
    weights: np.ndarray  # (kh, kw, cin, cout)
    biases: np.ndarray  # (cout,)
    stride: tuple[int, int] = (1, 1)
    padding: str = "same"
    activation: str = "relu"
    type_tag: str = "conv2d"
    kind: str = "conv2d"

    @property
    def out_shape(self) -> tuple[int, int, int]:
        h, w, _ = self.in_shape
        kh, kw, _, cout = self.weights.shape
        sh, sw = self.stride
        if self.padding.lower() == "same":
            oh, ow = -(-h // sh), -(-w // sw)
        else:
            oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
        return (oh, ow, cout)

    @property
    def in_dim(self) -> int:
        h, w, c = self.in_shape
        return h * w * c

    @property
    def out_dim(self) -> int:
        oh, ow, oc = self.out_shape
        return oh * ow * oc

    def validate(self) -> None:
        if self.weights.ndim != 4:
            raise ValueError(f"conv2d weights must be 4-D, got {self.weights.shape}")
        if self.weights.shape[2] != self.in_shape[2]:
            raise ValueError(
                f"conv2d kernel expects {self.weights.shape[2]} input channels "
                f"but in_shape has {self.in_shape[2]}"
            )
        if self.biases.shape != (self.weights.shape[3],):
            raise ValueError(
                f"conv2d bias shape {self.biases.shape} does not match "
                f"{self.weights.shape[3]} filters"
            )
        if self.padding.lower() not in ("same", "valid"):
            raise ValueError(f"conv2d padding must be same|valid, got {self.padding!r}")
        oh, ow, _ = self.out_shape
        if oh <= 0 or ow <= 0:
            raise ValueError(
                f"conv2d kernel {self.weights.shape[:2]} with stride "
                f"{self.stride} does not fit input {self.in_shape} "
                f"(output would be {oh}x{ow})"
            )

    @classmethod
    def from_json(cls, obj: dict) -> "Conv2DSpec":
        spec = cls(
            in_shape=tuple(obj["in_shape"]),
            weights=np.asarray(obj["weights"], dtype=np.float64),
            biases=np.asarray(obj["bias"], dtype=np.float64),
            stride=tuple(obj.get("stride", (1, 1))),
            padding=obj.get("padding", "same"),
            activation=obj.get("activation", "relu"),
        )
        spec.validate()
        return spec

    def to_json(self) -> dict:
        return {
            "type": "conv2d",
            "in_shape": list(self.in_shape),
            "kernel_size": [int(self.weights.shape[0]), int(self.weights.shape[1])],
            "filters": int(self.weights.shape[3]),
            "stride": list(self.stride),
            "padding": self.padding,
            "activation": self.activation,
            "weights": self.weights.tolist(),
            "bias": self.biases.tolist(),
        }


@dataclasses.dataclass
class MaxPool2DSpec:
    """Max pooling over NHWC windows (flat-vector boundaries like conv)."""

    in_shape: tuple[int, int, int]
    window: tuple[int, int] = (2, 2)
    stride: tuple[int, int] | None = None  # defaults to window
    type_tag: str = "maxpool2d"
    kind: str = "maxpool2d"
    activation: str = "linear"

    @property
    def eff_stride(self) -> tuple[int, int]:
        return tuple(self.stride) if self.stride else tuple(self.window)

    @property
    def out_shape(self) -> tuple[int, int, int]:
        h, w, c = self.in_shape
        sh, sw = self.eff_stride
        kh, kw = self.window
        return ((h - kh) // sh + 1, (w - kw) // sw + 1, c)

    @property
    def in_dim(self) -> int:
        h, w, c = self.in_shape
        return h * w * c

    @property
    def out_dim(self) -> int:
        oh, ow, oc = self.out_shape
        return oh * ow * oc

    def validate(self) -> None:
        if any(k <= 0 for k in self.window):
            raise ValueError(f"maxpool2d window must be positive, got {self.window}")
        if any(s <= 0 for s in self.eff_stride):
            raise ValueError(
                f"maxpool2d stride must be positive, got {self.eff_stride}"
            )
        if any(d <= 0 for d in self.in_shape):
            raise ValueError(
                f"maxpool2d in_shape must be positive, got {self.in_shape}"
            )
        oh, ow, _ = self.out_shape
        if oh <= 0 or ow <= 0:
            raise ValueError(
                f"maxpool2d window {self.window} does not fit input "
                f"{self.in_shape} (output shape {self.out_shape})"
            )

    @classmethod
    def from_json(cls, obj: dict) -> "MaxPool2DSpec":
        spec = cls(
            in_shape=tuple(obj["in_shape"]),
            window=tuple(obj.get("window", (2, 2))),
            stride=tuple(obj["stride"]) if "stride" in obj else None,
        )
        spec.validate()
        return spec

    def to_json(self) -> dict:
        out = {
            "type": "maxpool2d",
            "in_shape": list(self.in_shape),
            "window": list(self.window),
        }
        if self.stride:
            out["stride"] = list(self.stride)
        return out


def _layer_from_json(obj: dict):
    """Dispatch a layer JSON object to its spec class by ``type``."""
    kind = obj.get("type", "hidden")
    if kind == "conv2d":
        return Conv2DSpec.from_json(obj)
    if kind == "maxpool2d":
        return MaxPool2DSpec.from_json(obj)
    # "hidden" / "output" / anything neuron-shaped: the reference's dense
    # format (grpc_node.py:44-55).
    return LayerSpec.from_neurons(obj)


def _layer_to_json(layer) -> dict:
    if isinstance(layer, LayerSpec):
        return layer.to_neurons()
    return layer.to_json()


# ---------------------------------------------------------------------------
# Example-inputs format (run_grpc_inference.py:35-52).


def load_examples(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Load ``{"examples": [{"input", "label"}]}`` → (inputs, labels).

    Inputs are flattened to 1-D per example (the shipped MNIST files are
    flat 784-vectors; the sample file nests rows, which the reference
    would have mis-sized — we flatten instead).
    """
    with open(path, "rb") as f:
        obj = json.loads(f.read())
    examples = obj["examples"]
    inputs = np.asarray(
        [np.asarray(e["input"], dtype=np.float64).reshape(-1) for e in examples]
    )
    labels = np.asarray([e.get("label", -1) for e in examples], dtype=np.int32)
    return inputs, labels


def save_examples(inputs: np.ndarray, labels: np.ndarray, path: str | Path) -> None:
    examples = [
        {"input": np.asarray(x).reshape(-1).tolist(), "label": int(y)}
        for x, y in zip(inputs, labels)
    ]
    with open(path, "w") as f:
        json.dump({"examples": examples}, f)


# ---------------------------------------------------------------------------
# Pipeline partitioning (the reference's calculate_layer_mappings,
# run_grpc_fcnn.py:176-252, re-expressed for mesh placement).


@dataclasses.dataclass
class StageSpec:
    """One pipeline stage: a contiguous run of layers placed on one device.

    Mirrors a reference node's identity (name + port, run_grpc_fcnn.py:
    199-221) and env contract (expected_input_dim, grpc_node.py:20).
    """

    index: int
    layers: list[LayerSpec]
    expected_input_dim: int

    @property
    def name(self) -> str:
        return f"{STAGE_NAME_PREFIX}{self.index}"

    @property
    def port(self) -> int:
        return stage_port(self.index)

    @property
    def output_dim(self) -> int:
        return self.layers[-1].out_dim if self.layers else self.expected_input_dim

    def to_stage_json(self) -> dict:
        """Serialize in the reference's per-node config format
        (``{"layer_N": [neurons...]}``, run_grpc_fcnn.py:208-218), plus an
        ``expected_input_dim`` key (our extension; the reference carries
        this via the EXPECTED_INPUT_DIM env var instead, grpc_node.py:20)
        so identity stages round-trip losslessly."""
        out = {
            f"layer_{i}": self.layers[i].to_neurons()["neurons"]
            for i in range(len(self.layers))
        }
        out["expected_input_dim"] = self.expected_input_dim
        return out

    @classmethod
    def from_stage_json(cls, obj: dict, index: int = 0, expected_input_dim: int | None = None) -> "StageSpec":
        """Parse the ``layer_N``-keyed format, sorting keys numerically
        (grpc_node.py:46)."""
        keys = sorted((k for k in obj if k.startswith("layer_")), key=lambda k: int(k.split("_")[1]))
        layers = [
            LayerSpec.from_neurons({"neurons": obj[k]}) for k in keys if obj[k]
        ]
        if expected_input_dim is None:
            expected_input_dim = obj.get("expected_input_dim")
        if expected_input_dim is None:
            if not layers:
                # The bare layer_N format carries no dims; an empty
                # (identity) stage is unrecoverable without the
                # pass-through width.
                raise ValueError(
                    "stage config has no layers; pass expected_input_dim explicitly"
                )
            expected_input_dim = layers[0].in_dim
        return cls(index=index, layers=layers, expected_input_dim=expected_input_dim)


def validate_distribution(distribution: Sequence[int], num_layers: int) -> None:
    """``sum(layer_distribution) == len(layers)`` (run_grpc_fcnn.py:182-183)."""
    if any(int(d) < 0 for d in distribution):
        raise ValueError(f"layer_distribution entries must be >= 0, got {list(distribution)}")
    if sum(int(d) for d in distribution) != num_layers:
        raise ValueError(
            f"sum(layer_distribution)={sum(distribution)} does not equal "
            f"number of layers={num_layers}"
        )


def partition_model(model: ModelSpec, distribution: Sequence[int]) -> list[StageSpec]:
    """Pack contiguous layer runs into stages per the distribution vector.

    Stages with zero layers are kept as identity stages (pass-through);
    the reference instead skipped them when chaining next-pointers
    (run_grpc_fcnn.py:224-237) — on a mesh every stage coordinate exists,
    so identity is the natural equivalent.
    """
    model.validate_chain()
    validate_distribution(distribution, len(model.layers))
    stages: list[StageSpec] = []
    cursor = 0
    current_dim = model.input_dim
    for i, count in enumerate(int(d) for d in distribution):
        layers = model.layers[cursor : cursor + count]
        stages.append(StageSpec(index=i, layers=layers, expected_input_dim=current_dim))
        if layers:
            current_dim = layers[-1].out_dim
        cursor += count
    return stages
