"""The Engine: orchestrator + client surface in one object.

Port of the single-program half of :mod:`tpu_dist_nn.api.engine`,
which replaces both reference drivers:

* ``run_grpc_fcnn.py`` (orchestrator): validate the distribution, infer
  the input dim, place, readiness-check, teardown — here
  ``Engine.up()`` validates, places on one card and runs a warm-up
  batch (which also builds the CUDA kernels); ``setup_seconds`` mirrors
  its bring-up timing (run_grpc_fcnn.py:321-322).
* ``run_grpc_inference.py`` (client): single / whole-set / chunked-batch
  inference with accuracy + latency reporting
  (run_grpc_inference.py:162-216).

Dispatch: float32 serving of a dense model runs the whole FCNN chain in
one kernel (:func:`~tpu_dist_nn_torch.kernels.fused_dense.fcnn_fused_forward`);
``quantize="int8"`` runs the int8 chain kernel
(:func:`~tpu_dist_nn_torch.kernels.quantized.fcnn_quantized_forward`).
A chain deeper than 32 layers, or with an interior too wide for the
kernel's shared memory, runs as several launches
(:func:`~tpu_dist_nn_torch.models.network.dense_forward`).
A model with conv / pool layers is built into a layer plan at
construction (:func:`~tpu_dist_nn_torch.models.network.build_network`)
and served by :func:`~tpu_dist_nn_torch.models.network.network_forward`:
each conv with its pool in one conv kernel, each run of dense layers in
one chain kernel. For an engine on the CPU every kernel runs its plain
PyTorch version. The JAX package serves float32 through XLA's fused
program; eager PyTorch has no such fusion, and the kernels do the same
work with no intermediate activation written to device memory.

Placement: a distribution that names more stages (times data shards)
than there are visible GPUs collapses to the single-program executor,
as the JAX Engine collapses to one chip. The cross-GPU pipeline (and,
for conv models, the heterogeneous per-stage pipeline) is not ported
yet, so a multi-card placement also serves on one card; both are
logged.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from tpu_dist_nn_torch.core.schema import ModelSpec, load_model, partition_model, save_model
from tpu_dist_nn_torch.data.feed import batch_iterator
from tpu_dist_nn_torch.kernels.quantized import quantize_fcnn
from tpu_dist_nn_torch.models.fcnn import params_from_spec
from tpu_dist_nn_torch.models.network import build_network, dense_forward, network_forward
from tpu_dist_nn_torch.train.metrics import classification_metrics
from tpu_dist_nn_torch.utils.device import resolve_device
from tpu_dist_nn_torch.utils.errors import (
    InvalidArgumentError,
    UnavailableError,
    check_input_dim,
)
from tpu_dist_nn_torch.utils.profiling import LatencyStats

log = logging.getLogger("tpu_dist_nn_torch.engine")


@dataclasses.dataclass
class PendingInference:
    """Handle from :meth:`Engine.infer_async`: a launched batch whose
    result is still being computed and copied back. ``value`` is the
    host tensor the result lands in (pinned memory on the card);
    ``done`` the CUDA event recorded after that copy (None on the CPU).
    :meth:`Engine.fetch` waits for it — the one host sync."""

    value: torch.Tensor
    done: object


@dataclasses.dataclass
class InferenceResult:
    """Client-side report (run_grpc_inference.py:185-216)."""

    outputs: np.ndarray
    seconds: float
    batch_seconds: list[float]
    metrics: dict | None = None

    def latency_summary(self) -> dict:
        """Percentiles over per-batch wall times."""
        return LatencyStats("batch_infer", list(self.batch_seconds)).summary()


class Engine:
    """A brought-up model: placed, warmed, ready to serve."""

    def __init__(self, model: ModelSpec, distribution, dtype, device,
                 quantize: str | None = None):
        if quantize is not None and quantize != "int8":
            raise InvalidArgumentError(
                f"unknown quantize mode {quantize!r}; supported: 'int8'"
            )
        if quantize is not None and not model.is_dense:
            raise InvalidArgumentError(
                "quantize='int8' serves dense models only (conv/pool "
                "layers have no int8 path); it composes with pipeline, "
                "data-parallel, AND interleaved placements"
            )
        if dtype != torch.float32:
            raise InvalidArgumentError(
                f"engine dtype {dtype} is not ported yet; the port serves float32"
            )
        # Copy metadata so export()'s annotations never mutate a
        # ModelSpec the caller still holds.
        self.model = ModelSpec(model.layers, dict(model.metadata))
        self.distribution = list(distribution)
        self.dtype = dtype
        self.device = device
        self._plan = None  # mixed-layer (conv/pool) networks only
        if model.is_dense:
            self._params = params_from_spec(model, dtype, device)
        else:
            self._plan, self._params = build_network(model, dtype, device)
        self._q = quantize_fcnn(self._params) if quantize else None
        self._warm_buckets: set[int] = set()
        self.setup_seconds: float | None = None

    # ---------------------------------------------------------------- up

    @classmethod
    def up(cls, model, distribution=None, *, data_parallel: int = 1,
           num_microbatches: int = 4, dtype=torch.float32, device=None,
           warmup: bool = True, quantize: str | None = None,
           warm_rows: int = 0) -> "Engine":
        """Validate, place, warm; returns a ready engine.

        ``model`` is a path or a ModelSpec. ``num_microbatches`` is kept
        for the JAX Engine's signature: it sizes the cross-GPU pipeline,
        which is not ported. ``device`` defaults to the
        card (raises :class:`UnavailableError` without one); pass
        ``"cpu"`` for the plain PyTorch path. ``quantize="int8"`` serves
        through the int8 chain kernel (dense models only). A conv model
        serves through the conv and chain kernels. ``warm_rows > 0``
        runs the whole pow2 row-bucket ladder up to that many rows at
        bring-up.
        """
        t0 = time.monotonic()
        dev = resolve_device(device)
        if not isinstance(model, ModelSpec):
            model = load_model(model)
        if distribution is None:
            distribution = model.metadata.get("layer_distribution")
        if distribution is None:
            distribution = [len(model.layers)]
        # Fail fast on an invalid plan (run_grpc_fcnn.py:182-183).
        partition_model(model, distribution)
        stages = len(distribution)
        if stages * data_parallel > 1:
            n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
            if stages * data_parallel > n_devices:
                why = f"exceed {n_devices} device(s)"
            else:
                why = "need the cross-GPU pipeline, which is not ported yet"
            log.info(
                "placement: %d stages x %d data shards %s; collapsing to "
                "the single-program executor", stages, data_parallel, why,
            )
        engine = cls(model, [len(model.layers)], dtype, dev, quantize=quantize)
        if warmup or warm_rows > 0:
            engine.warm_buckets(max(warm_rows, 1 if warmup else 0))
        engine.setup_seconds = time.monotonic() - t0
        log.info("engine.up seconds=%.3f placement=%s", engine.setup_seconds,
                 engine.placement())
        return engine

    @property
    def numpy_dtype(self) -> np.dtype:
        """The engine dtype as numpy names it: the dtype a server
        decodes request rows into."""
        return torch.empty((), dtype=self.dtype).numpy().dtype

    def placement(self) -> dict:
        """Placement summary — the spawn-log analogue (run_grpc_fcnn.py:133-143)."""
        return {
            "devices": 1,
            "device": str(self.device),
            "distribution": self.distribution,
            "data_parallel": 1,
            "pipelined": False,
            "num_stages": 1,
            "input_dim": self.model.input_dim,
            "output_dim": self.model.output_dim,
        }

    # ------------------------------------------------------------- infer

    def infer(self, x) -> np.ndarray:
        """Forward a batch → (N, out_dim) outputs.

        Raises :class:`InvalidArgumentError` on a feature-dim mismatch
        (the reference's per-forward check, grpc_node.py:83-84) and
        :class:`UnavailableError` after :meth:`down`.
        """
        return self.fetch(self.infer_async(x))

    def infer_async(self, x) -> PendingInference:
        """Validate, stage and LAUNCH a batch without waiting for it.

        On the card the rows are cast once into pinned host memory
        (uint8 rows of a dense float32 model stay uint8), copied to the
        device, run through the kernels and copied
        back into pinned memory, all queued on the current CUDA stream;
        :meth:`fetch` is the host sync. Validation errors raise here.
        """
        if self._params is None:
            raise UnavailableError(
                "engine is down; relaunch with Engine.up from the model JSON"
            )
        x = np.asarray(x)
        in_dim = self.model.input_dim
        if x.ndim >= 2:
            check_input_dim(in_dim, int(x.shape[-1]), stage=0)
        elif x.size != in_dim:
            check_input_dim(in_dim, int(x.size), stage=0)
        host = torch.from_numpy(np.ascontiguousarray(x.reshape(-1, in_dim)))
        # uint8 rows reach a dense float32 model's chain kernel as they
        # are (the same float32 values at a quarter of the bytes); the
        # int8 and conv paths take them cast.
        dtype = (torch.uint8 if x.dtype == np.uint8 and self._q is None
                 and self._plan is None else self.dtype)
        if self.device.type == "cpu":
            out = self._forward(host.to(dtype))
            return PendingInference(out, None)
        staged = torch.empty(host.shape, dtype=dtype, pin_memory=True)
        staged.copy_(host)  # the one cast, straight to the engine dtype
        out = self._forward(staged.to(self.device, non_blocking=True))
        result = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        result.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return PendingInference(result, done)

    def fetch(self, pending: PendingInference) -> np.ndarray:
        """Wait for an :meth:`infer_async` handle; returns host numpy."""
        if pending.done is not None:
            pending.done.synchronize()
        return pending.value.numpy()

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._q is not None:
            return dense_forward(self._q, x, quantized=True)
        if self._plan is not None:
            return network_forward(self._plan, self._params, x)
        return dense_forward(self._params, x)

    def warm_buckets(self, max_rows: int) -> list[int]:
        """Run the pow2 row-bucket ladder (1, 2, 4, … up to the pow2
        ceiling of ``max_rows``) once each. There is no compile to
        precede here; the first call builds the kernels and warms the
        caching allocators. Idempotent; returns the buckets newly run."""
        warmed: list[int] = []
        if max_rows < 1:
            return warmed
        dim = self.model.input_dim
        top = 1 << (max_rows - 1).bit_length() if max_rows > 1 else 1
        n = 1
        while n <= top:
            if n not in self._warm_buckets:
                self.infer(np.zeros((n, dim), np.float32))
                self._warm_buckets.add(n)
                warmed.append(n)
            n *= 2
        return warmed

    @property
    def warm_bucket_count(self) -> int:
        return len(self._warm_buckets)

    def infer_single(self, x) -> tuple[np.ndarray, float]:
        """One example, with its wall time (run_grpc_inference.py:54-99)."""
        t0 = time.monotonic()
        out = self.infer(np.asarray(x).reshape(1, -1))[0]
        return out, time.monotonic() - t0

    def step_latency(self, batch_size: int = 256, iters: int = 20) -> dict:
        """The BASELINE "p50 per-stage pipeline step latency" probe:
        ``iters`` synchronous forward steps on a synthetic batch."""
        if iters < 1 or batch_size < 1:
            raise InvalidArgumentError(
                f"step_latency needs iters >= 1 and batch_size >= 1, "
                f"got iters={iters}, batch_size={batch_size}"
            )
        rng = np.random.default_rng(0)
        x = rng.uniform(0.0, 1.0, (batch_size, self.model.input_dim))
        self.infer(x)  # warmup
        stats = LatencyStats("pipeline_step")
        for _ in range(iters):
            t0 = time.monotonic()
            self.infer(x)
            stats.record(time.monotonic() - t0)
        summary = stats.summary()
        summary["num_stages"] = 1
        summary["p50_per_stage_s"] = summary["p50_s"]
        return summary

    def run_inference(self, inputs, labels=None, *, batch_size: int | None = None,
                      num_classes: int | None = None) -> InferenceResult:
        """Whole-set or chunked-batch inference with accuracy + latency —
        the reference client's main loop (run_grpc_inference.py:185-216).

        The chunked path is double-buffered: batch ``i+1`` is staged and
        launched before batch ``i``'s fetch waits, so its host-to-device
        copy overlaps the previous batch's compute. ``batch_seconds[i]``
        spans batch i's dispatch to its materialized result.
        """
        inputs = np.asarray(inputs)
        t0 = time.monotonic()
        outputs = []
        batch_seconds = []
        if batch_size is None:
            bt0 = time.monotonic()
            outputs.append(self.infer(inputs))
            batch_seconds.append(time.monotonic() - bt0)
        else:
            pending = None
            pt0 = 0.0
            for bx in batch_iterator(inputs, batch_size=batch_size):
                bt0 = time.monotonic()
                nxt = self.infer_async(bx)
                if pending is not None:
                    outputs.append(self.fetch(pending))
                    batch_seconds.append(time.monotonic() - pt0)
                pending, pt0 = nxt, bt0
            if pending is not None:
                outputs.append(self.fetch(pending))
                batch_seconds.append(time.monotonic() - pt0)
        outputs = np.concatenate(outputs)
        seconds = time.monotonic() - t0
        metrics = None
        if labels is not None:
            metrics = classification_metrics(outputs, labels, num_classes)
        return InferenceResult(outputs, seconds, batch_seconds, metrics)

    # ------------------------------------------------------------ export

    def export(self, path, metrics: dict | None = None) -> ModelSpec:
        """Write the weights to the public JSON schema, embedding metrics
        under inference_metrics (notebook cell 10 parity)."""
        if metrics is not None:
            self.model.metadata["inference_metrics"] = metrics
        save_model(self.model, path)
        return self.model

    # -------------------------------------------------------------- down

    def down(self) -> None:
        """Release the device state. Idempotent; relaunch = ``Engine.up``
        again from the JSON model (run_grpc_fcnn.py:329-344)."""
        self._params = None
        self._q = None

    @property
    def is_ready(self) -> bool:
        return self._params is not None

