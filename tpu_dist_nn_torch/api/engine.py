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

Placement (the JAX Engine's rules): a dense model whose distribution
names S stages, times ``data_parallel`` replicas, that fit the
``devices`` is served by the layer-distribution pipeline
(:mod:`tpu_dist_nn_torch.parallel.pipeline`): each stage's real layers
on a stage slot (a device and its own CUDA stream), the GPipe schedule
(or, with ``virtual_stages=v``, the interleaved table over S/v slots)
issuing one chain-kernel launch a stage a microbatch. ``devices``
defaults to the visible cards, each counted once; a list may name one
card several times, and each mention is a slot with its own stream.
A conv model's multi-stage distribution is served by the
heterogeneous pipeline
(:class:`~tpu_dist_nn_torch.parallel.hetero_pipeline.HeteroPipeline`):
each stage's layers on a slot, through the conv and chain kernels,
``len(x) // num_microbatches`` rows a chunk. A single-stage plan with
``data_parallel = N`` slots is the data-sharded single program (JAX
``Engine.data_sharded``): the rows padded with zeros to a multiple of N,
slot ``d`` running its contiguous chunk through the model's kernels on
its own stream (the f32 chain, the int8 chain, or the conv kernels and
the chain tail; a slot on another card reads its own copy of the
weights), the results concatenated in slot order and the pad dropped;
:meth:`Engine.train` then trains a dense model with the rows over the
data slots (:func:`~tpu_dist_nn_torch.train.trainer.train_fcnn`'s
``mesh``), a conv model on one program, as the JAX Engine does. A
placement that needs more slots than there are collapses to the
single-program executor, as the JAX Engine collapses to one chip
(logged); on one card, pass ``devices=[card] * N``.

On a card, a pipelined engine whose slots share one card serves each
pow2 row bucket through a captured CUDA graph of the pipelined forward
(:class:`~tpu_dist_nn_torch.parallel.pipeline.GraphedPlaced`), f32 and
int8 alike: one replay a batch where the host issued every stage's
launch for every microbatch. A bucket is captured at its first use
(:meth:`Engine.warm_buckets` runs the ladder at bring-up). Slots on
several cards run the schedule eagerly: a graph belongs to one card.

The int8 warm-up gate: a quantized engine's first :meth:`Engine.warm_buckets`
times the f32 and the int8 forward of the largest warm bucket
(:meth:`Engine.measure_int8_speedup`: on a card the device time between
CUDA events, on the CPU the host clock) and, where int8 is slower,
reroutes serving to the f32 chain (``int8_auto_disabled``).
``TDN_INT8_AUTO=0`` keeps int8 (measure and warn only);
``TDN_INT8_WARMUP_MEASURE=0`` skips the measurement.

Training (:meth:`Engine.train`) trains a dense engine's params in place
with :func:`~tpu_dist_nn_torch.train.trainer.train_fcnn`, a conv
engine's with :func:`~tpu_dist_nn_torch.train.trainer.train_network`,
a pipelined dense engine's stages through the ``gpipe``, ``1f1b`` or
``interleaved`` schedule
(:func:`~tpu_dist_nn_torch.train.pipeline_trainer.train_pipelined`),
or a heterogeneous pipeline's through its GPipe schedule
(:func:`~tpu_dist_nn_torch.train.hetero_trainer.train_hetero`),
and serves the trained weights on every path afterwards.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import time

import numpy as np
import torch

from tpu_dist_nn_torch.core.schema import ModelSpec, load_model, partition_model, save_model
from tpu_dist_nn_torch.data.feed import batch_iterator
from tpu_dist_nn_torch.kernels.quantized import quantize_fcnn
from tpu_dist_nn_torch.models.fcnn import params_from_spec
from tpu_dist_nn_torch.models.network import (
    build_network,
    dense_forward,
    network_forward,
    network_model_from_params,
)
from tpu_dist_nn_torch.obs.goodput import GOODPUT, fcnn_flops_per_row
from tpu_dist_nn_torch.obs.log import get_logger
from tpu_dist_nn_torch.obs.registry import REGISTRY
from tpu_dist_nn_torch.parallel.gpipe import caller_event, gather, launch
from tpu_dist_nn_torch.parallel import multihost
from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh, visible_devices
from tpu_dist_nn_torch.parallel.one_f_one_b import validate_schedule
from tpu_dist_nn_torch.parallel.pipeline import (
    GraphedPlaced,
    build_pipeline_params,
    extract_model,
    pipeline_spec_summary,
    place_pipeline,
    place_pipeline_quantized,
    row_bucket,
    run_placed,
)
from tpu_dist_nn_torch.serving.integrity import GUARD
from tpu_dist_nn_torch.train.metrics import classification_metrics
from tpu_dist_nn_torch.train.pipeline_trainer import train_pipelined
from tpu_dist_nn_torch.train.trainer import TrainConfig, train_fcnn, train_network
from tpu_dist_nn_torch.utils.device import resolve_device
from tpu_dist_nn_torch.utils.errors import (
    IntegrityError,
    InvalidArgumentError,
    UnavailableError,
    check_input_dim,
)
from tpu_dist_nn_torch.utils.profiling import LatencyStats, device_call_ms

log = logging.getLogger("tpu_dist_nn_torch.engine")
slog = get_logger("tpu_dist_nn_torch.engine")

# Engine metric families (the JAX package's names). Host-side float
# adds only: a time.monotonic() pair around a launch, never a sync.
_INFER_SECONDS = REGISTRY.histogram(
    "tdn_engine_infer_seconds", "Engine.infer wall time per call",
)
_INFER_ROWS = REGISTRY.counter(
    "tdn_engine_infer_rows_total",
    "rows computed by Engine.infer (includes coalescing padding; "
    "tdn_batch_rows is the useful-rows view)",
)
_INFER_ERRORS = REGISTRY.counter(
    "tdn_engine_infer_errors_total", "Engine.infer calls that raised",
)
# The port has no compiles: a launch's row bucket whose CUDA graph is
# already captured (a pipelined engine on one card), or a launch row
# count this engine already served (every other placement), is a hit;
# a first use, which captures the bucket's graph, is a miss.
_COMPILE_HITS = REGISTRY.counter(
    "tdn_engine_compile_cache_hits_total",
    "infer calls whose launch shape was already served (on a pipelined "
    "engine on one card: its row bucket's CUDA graph was already captured)",
)
_COMPILE_MISSES = REGISTRY.counter(
    "tdn_engine_compile_cache_misses_total",
    "infer calls whose launch shape was new (on a pipelined engine on one "
    "card: the first use of a row bucket, which captures its CUDA graph)",
)
_TRAIN_SECONDS = REGISTRY.histogram(
    "tdn_engine_train_seconds", "Engine.train wall time per call",
    buckets=(1.0, 5.0, 15.0, 60.0, 300.0, 1800.0, 7200.0),
)
_TRAIN_CALLS = REGISTRY.counter(
    "tdn_engine_train_calls_total", "Engine.train invocations",
)
# Warm state of the pow2 row-bucket ladder (warm_buckets): how many
# buckets this process has already run (and, pipelined on one card,
# captured), so a scrape tells whether a live request can still meet a
# first use.
_WARM_BUCKETS = REGISTRY.gauge(
    "tdn_engine_warm_buckets",
    "pow2 row-bucket forwards already run (on a pipelined engine on one "
    "card: captured as CUDA graphs)",
)
# Measured at warm-up on quantized engines: f32 time / int8 time for one
# forward of the largest warm bucket (> 1: int8 pays off); device time
# on a card, host wall time on the CPU.
# NaN until a quantized engine has measured: an unlabeled gauge would
# otherwise read 0, "int8 is catastrophically slow".
_INT8_RATIO = REGISTRY.gauge(
    "tdn_int8_speedup_ratio",
    "f32 forward time / int8 forward time on the largest warm bucket "
    "(quantized engines; device time on a card, wall time on the CPU; "
    "< 1 = int8 is slower on this device; NaN until a quantized engine "
    "has measured)",
)
_INT8_RATIO.set(float("nan"))
# Timed forwards a gate arm takes on a card (after one warm forward); the
# arm's time is their median.
_GATE_CALLS = 7


@dataclasses.dataclass
class PendingInference:
    """Handle from :meth:`Engine.infer_async`: a launched batch whose
    result is still being computed and copied back. ``value`` is the
    host tensor the result lands in (pinned memory on the card);
    ``done`` the CUDA event recorded after that copy (None on the CPU).
    :meth:`Engine.fetch` waits for it — the one host sync, where the
    numeric guard leaves its ``(N,)`` mask of corrupt rows in
    ``bad_rows`` (None when every row is clean or the guard is off)."""

    value: torch.Tensor
    done: object
    bad_rows: object = None
    t0: float = 0.0


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
                 quantize: str | None = None, *, mesh_spec: MeshSpec = MeshSpec(),
                 num_microbatches: int = 4, devices=None, virtual_stages: int = 1):
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
        self.mesh_spec = mesh_spec
        self.num_microbatches = int(num_microbatches)
        self.virtual_stages = int(virtual_stages)
        # Engine.up overwrites this with the request when the placement
        # collapsed it (train() then falls back instead of raising).
        self.requested_virtual_stages = int(virtual_stages)
        # Interleaved placements pipeline V = stage * v chunks over
        # stage slots, so stage == 1 with v > 1 still pipelines.
        self.pipelined = mesh_spec.stage > 1 or self.virtual_stages > 1
        # Pure data parallelism on a single-stage plan: the rows over
        # the data slots, the weights shared (a copy a card).
        self.data_sharded = not self.pipelined and mesh_spec.data > 1
        self._copies: dict = {}  # data-sharded: device -> (params, q) there
        self._plan = None  # mixed-layer (conv/pool) networks only
        self._params = None  # single-program params
        self._pp = None  # pipelined: the padded contract
        self._placed = None  # pipelined: the f32 stages on their slots
        self._hp = None  # heterogeneous (non-dense) pipeline executor
        self._graphs: dict = {}  # pipelined on one card: "f32" / "int8" -> GraphedPlaced
        if self.pipelined and not model.is_dense:
            from tpu_dist_nn_torch.parallel.hetero_pipeline import HeteroPipeline

            if multihost.is_multiprocess() and devices is not None and any(
                    isinstance(d, multihost.HostDevice)
                    and d.rank != multihost.process_index() for d in devices):
                raise InvalidArgumentError(
                    "the heterogeneous (conv) pipeline across processes is not "
                    "supported: serve a conv model's distribution from a "
                    "single-process engine")

            self._hp = HeteroPipeline(model, self.distribution,
                                      devices=visible_devices(device) if devices is None
                                      else devices, dtype=dtype)
            self.mesh = self._hp.mesh
            self.device = self._hp.device
        elif self.pipelined:
            self.mesh = build_mesh(mesh_spec, devices)
            self._pp = build_pipeline_params(partition_model(model, self.distribution))
            self._placed = place_pipeline(self.mesh, self._pp, num_virtual=self.virtual_stages)
            self.device = self._placed.device
        else:
            self.mesh = build_mesh(mesh_spec, devices) if self.data_sharded else None
            self.device = device
            if model.is_dense:
                self._params = params_from_spec(model, dtype, device)
            else:
                self._plan, self._params = build_network(model, dtype, device)
        # Goodput accounting: the analytic FLOPs of one row through the
        # dense chain, recorded per launch at infer_async. None for a
        # conv model (no FLOP model). The peak resolves here, at
        # configure time, never on a sampler tick; launches are recorded
        # whole, so a placement's peak is per-device x its devices.
        self._flops_per_row = (fcnn_flops_per_row(self.model.layer_sizes)
                               if model.is_dense else None)
        if self._flops_per_row:
            GOODPUT.ensure_peak(device_count=mesh_spec.num_devices, dtype="float32")
        # The int8 path: quantize_fcnn's layers on one program, or the
        # placed stages of the padded int8 contract on a pipeline.
        self._q = None
        if quantize:
            self._quantize()
        self._warm_buckets: set[int] = set()
        # Launch shapes served (the compile-cache hit / miss proxy).
        self._seen_launch_keys: set = set()
        self.setup_seconds: float | None = None
        self._int8_measured = False
        # Set by measure_int8_speedup: int8 measured slower than f32, so
        # serving launches take the f32 chain.
        self.int8_auto_disabled = False
        self.int8_speedup_ratio: float | None = None

    def _quantize(self) -> None:
        self._graphs.clear()
        self._copies.clear()
        if self.pipelined:
            from tpu_dist_nn_torch.kernels.quantized import quantize_pipeline_weights

            self._q = place_pipeline_quantized(self.mesh,
                                               quantize_pipeline_weights(self._pp.weights),
                                               self._pp.meta, num_virtual=self.virtual_stages)
        else:
            self._q = quantize_fcnn(self._params)

    # ---------------------------------------------------------------- up

    @classmethod
    def up(cls, model, distribution=None, *, data_parallel: int = 1,
           num_microbatches: int = 4, dtype=torch.float32, device=None,
           devices=None, warmup: bool = True, quantize: str | None = None,
           warm_rows: int = 0, virtual_stages: int = 1) -> "Engine":
        """Validate, place, warm; returns a ready engine.

        ``model`` is a path or a ModelSpec. ``device`` defaults to the
        card (raises :class:`UnavailableError` without one); pass
        ``"cpu"`` for the plain PyTorch path. ``devices`` (default: the
        visible cards, each once; ``[device]`` on the CPU) are the slots
        a distribution may take: one per stage and data replica, and one
        card may be named several times. A dense model's ``S``-stage
        distribution with ``S x data_parallel`` slots runs the pipeline
        in ``num_microbatches`` microbatches, and a single-stage plan
        with ``data_parallel`` slots the data-sharded single program;
        with too few either collapses to one program (logged). ``quantize="int8"``
        serves through the int8 chain kernel (dense models only). A conv
        model serves through the conv and chain kernels.
        ``warm_rows > 0`` runs the whole pow2 row-bucket ladder up to
        that many rows at bring-up. ``virtual_stages=v > 1`` selects the
        interleaved placement: the distribution's ``V`` entries are
        chunks, chunk ``c`` on stage slot ``c % (V/v)``. A conv model's
        ``S``-stage distribution with ``S`` slots runs the heterogeneous
        pipeline (its ``data_parallel`` is ignored, logged).
        """
        t0 = time.monotonic()
        if devices is not None:
            devices = [d if isinstance(d, multihost.HostDevice) else resolve_device(d)
                       for d in devices]
            if not devices:
                raise InvalidArgumentError("devices is empty")
            dev = next((d.device for d in devices if isinstance(d, multihost.HostDevice)
                        and d.rank == multihost.process_index()), devices[0])
        elif multihost.is_multiprocess():
            # the global device list: every process's local devices
            dev = multihost.local_devices()[0]
            devices = multihost.global_devices()
        else:
            dev = resolve_device(device)
            devices = visible_devices(dev)
        if not isinstance(model, ModelSpec):
            model = load_model(model)
        if distribution is None:
            distribution = model.metadata.get("layer_distribution")
        if distribution is None:
            distribution = [len(model.layers)]
        # Fail fast on an invalid plan (run_grpc_fcnn.py:182-183).
        partition_model(model, distribution)
        n_devices = len(devices)
        stages = len(distribution)
        if virtual_stages < 1:
            raise InvalidArgumentError(f"virtual_stages must be >= 1, got {virtual_stages}")
        # Remember the request: the collapse below may reset it, and
        # train(schedule="interleaved") then falls back instead of
        # asking for the flag the caller already passed.
        requested_virtual = virtual_stages
        single = MeshSpec(stage=1, data=1)
        if virtual_stages > 1:
            if not model.is_dense:
                raise InvalidArgumentError(
                    "virtual_stages applies to dense pipelined models "
                    "(the heterogeneous executor pins one stage per device)"
                )
            if stages % virtual_stages:
                raise InvalidArgumentError(
                    f"distribution has {stages} entries (chunks), not "
                    f"divisible by virtual_stages={virtual_stages}"
                )
            stage_devices = stages // virtual_stages
            if stage_devices * data_parallel > n_devices:
                log.info(
                    "placement: interleaved %d stage device(s) x %d data shards "
                    "exceed %d device(s); collapsing to the single-program executor",
                    stage_devices, data_parallel, n_devices,
                )
                virtual_stages = 1
                mesh_spec = single
            else:
                mesh_spec = MeshSpec(stage=stage_devices, data=data_parallel)
        else:
            if stages > 1 and not model.is_dense and data_parallel > 1:
                log.info("placement: non-dense pipeline ignores data_parallel=%d",
                         data_parallel)
                data_parallel = 1
            if stages * data_parallel > n_devices:
                log.info(
                    "placement: %d stages x %d data shards exceed %d device(s); "
                    "collapsing to the single-program executor",
                    stages, data_parallel, n_devices,
                )
                mesh_spec = single
            else:
                mesh_spec = MeshSpec(stage=stages, data=data_parallel)
        if mesh_spec.stage == 1 and virtual_stages == 1:
            distribution = [len(model.layers)]
        engine = cls(model, distribution, dtype, dev, quantize=quantize,
                     mesh_spec=mesh_spec, num_microbatches=num_microbatches,
                     devices=devices, virtual_stages=virtual_stages)
        engine.requested_virtual_stages = int(requested_virtual)
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
        base = {
            "devices": self.mesh_spec.num_devices,
            "device": str(self.device),
            "distribution": self.distribution,
            "data_parallel": self.mesh_spec.data,
            "pipelined": self.pipelined,
        }
        if self.data_sharded:
            base["slots"] = [[str(slot.device) for slot in row] for row in self.mesh.slots]
        if self.virtual_stages > 1:
            base["virtual_stages"] = self.virtual_stages
        if self._hp is not None:
            base.update(self._hp.placement_summary())
            base["slots"] = [[str(slot.device) for slot in row] for row in self.mesh.slots]
        elif self.pipelined:
            base.update(pipeline_spec_summary(self._pp))
            base["slots"] = [[str(slot.device) for slot in row] for row in self.mesh.slots]
        else:
            base.update({"num_stages": 1, "input_dim": self.model.input_dim,
                         "output_dim": self.model.output_dim})
        return base

    # ------------------------------------------------------------- infer

    def infer(self, x) -> np.ndarray:
        """Forward a batch → (N, out_dim) outputs.

        Raises :class:`InvalidArgumentError` on a feature-dim mismatch
        (the reference's per-forward check, grpc_node.py:83-84) and
        :class:`UnavailableError` after :meth:`down`.

        A direct call is ONE request, so the numeric guard's per-row
        failover collapses to request granularity here: any corrupt row
        raises :class:`IntegrityError` rather than handing back a batch
        with non-finite rows inside (the batcher keeps row granularity
        through ``PendingInference.bad_rows``).
        """
        pending = self.infer_async(x)
        out = self.fetch(pending)
        bad = pending.bad_rows
        if bad is not None and bad.any():
            raise IntegrityError(
                f"numeric guard: {int(bad.sum())}/{len(out)} rows of "
                f"the result are non-finite or out of magnitude bounds"
            )
        return out

    def infer_async(self, x, *, useful_rows=None) -> PendingInference:
        """Validate, stage and LAUNCH a batch without waiting for it.

        On the card the rows are cast once into pinned host memory
        (uint8 rows of a dense float32 model stay uint8), copied to the
        device, run through the kernels and copied
        back into pinned memory, all queued on the current CUDA stream;
        :meth:`fetch` is the host sync. Validation errors raise here.

        ``useful_rows`` is the goodput declaration: how many of the rows
        carry request data (the batcher passes its pre-padding count, so
        bucket pad is booked as pad under ``path="batcher"``); a direct
        call counts every row useful under ``path="engine"``.
        """
        t0 = time.monotonic()
        try:
            pending, key = self._launch(x)
        except Exception:
            _INFER_ERRORS.inc()
            raise
        pending.t0 = t0
        if self._flops_per_row:
            rows = int(pending.value.shape[0])
            if useful_rows is None:
                GOODPUT.record_rows(self._flops_per_row, rows, rows, path="engine")
            else:
                GOODPUT.record_rows(self._flops_per_row, rows, int(useful_rows),
                                    path="batcher")
        if key in self._seen_launch_keys:
            _COMPILE_HITS.inc()
        else:
            self._seen_launch_keys.add(key)
            _COMPILE_MISSES.inc()
        return pending

    def _launch(self, x) -> tuple[PendingInference, tuple]:
        """infer_async's body: the handle and the launch's cache key
        (the row bucket on a captured pipelined forward, else the row
        count, with the input dtype)."""
        if not self.is_ready:
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
        dtype = (torch.uint8 if x.dtype == np.uint8 and not self._serves_int8
                 and self._plan is None and self._hp is None else self.dtype)
        n = int(host.shape[0])
        graphed = (self.pipelined and self.device.type == "cuda"
                   and self._hp is None and self.mesh.on_one_card)
        key = (row_bucket(n) if graphed and n else n, dtype, self._serves_int8)
        if self.device.type == "cpu":
            out = self._forward(host.to(dtype))
            return PendingInference(out, None), key
        staged = torch.empty(host.shape, dtype=dtype, pin_memory=True)
        staged.copy_(host)  # the one cast, straight to the engine dtype
        out = self._forward(staged.to(self.device, non_blocking=True))
        result = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        result.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return PendingInference(result, done), key

    def fetch(self, pending: PendingInference) -> np.ndarray:
        """Wait for an :meth:`infer_async` handle; returns host numpy.

        The numeric guard screens the host result here, one vectorized
        pass over the array just copied back: a partly corrupt launch
        leaves its row mask in ``pending.bad_rows`` for the batcher's
        per-row failover (clean rows ship bit-identical); a launch whose
        rows are ALL bad has nothing to salvage and raises
        :class:`IntegrityError`."""
        try:
            if pending.done is not None:
                pending.done.synchronize()
            out = pending.value.numpy()
            bad = GUARD.bad_rows(out) if GUARD.enabled else None
            if bad is not None and bad.any():
                pending.bad_rows = bad
                if bad.all():
                    raise IntegrityError(
                        f"numeric guard: all {len(out)} rows of the launch are "
                        f"non-finite or out of magnitude — refusing to ship the batch"
                    )
        except Exception:
            _INFER_ERRORS.inc()
            raise
        _INFER_SECONDS.observe(time.monotonic() - pending.t0)
        _INFER_ROWS.inc(len(out))
        return out

    @property
    def _serves_int8(self) -> bool:
        """A quantized engine that the warm-up gate left on int8."""
        return self._q is not None and not self.int8_auto_disabled

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._hp is not None:
            return self._hp.run(x, max(1, len(x) // self.num_microbatches))
        if self.pipelined:
            # Plain, interleaved, int8 or both: the placed stages carry it.
            placed = self._q if self._serves_int8 else self._placed
            graphed = self._graphed(placed)
            if graphed is not None:
                return graphed(x)
            return run_placed(placed, x, self.num_microbatches)
        if self.data_sharded:
            return self._sharded_forward(x)
        return self._program(self._params, self._q, x)

    def _program(self, params, q, x: torch.Tensor) -> torch.Tensor:
        """The single program's kernels on ``x`` with ``params`` (or the
        int8 ``q``) on ``x``'s device."""
        if self._serves_int8:
            return dense_forward(q, x, quantized=True)
        if self._plan is not None:
            return network_forward(self._plan, params, x)
        return dense_forward(params, x)

    def _sharded_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The data-sharded forward (the JAX Engine's data-sharded
        launch): rows zero-padded to a multiple of the data slots, slot
        ``d`` runs its contiguous chunk on its stream, the results
        concatenated in slot order on the caller's stream, pad dropped."""
        slots = self.mesh.slots[0]
        n, pad = len(x), -len(x) % len(slots)
        if pad:
            x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
        ready = caller_event(x)
        outs = [launch(slot, functools.partial(self._program, *self._weights_on(slot.device)),
                       rows, ready)
                for slot, rows in zip(slots, x.chunk(len(slots)))]
        return torch.cat(gather(outs, self.device, self.mesh))[:n]

    def _weights_on(self, device) -> tuple:
        """``(params, q)`` on ``device``: the engine's own on its card, a
        copy made once on another (shapes only on a remote slot)."""
        lead = self.mesh.slots[0][0]
        if device == (lead.device if lead.local else self.device):
            return self._params, self._q
        if device not in self._copies:
            self._copies[device] = (_moved(self._params, device), _moved(self._q, device))
        return self._copies[device]

    def _graphed(self, placed) -> GraphedPlaced | None:
        """The captured forward of ``placed`` (the f32 or the int8
        stages) when its slots share one card, created at first use;
        else None."""
        if not self.mesh.on_one_card:
            return None
        key = "int8" if placed is self._q else "f32"
        if key not in self._graphs:
            self._graphs[key] = GraphedPlaced(placed, self.num_microbatches)
        return self._graphs[key]

    def warm_buckets(self, max_rows: int) -> list[int]:
        """Run the pow2 row-bucket ladder (1, 2, 4, … up to the pow2
        ceiling of ``max_rows``) once each. There is no compile to
        precede here; the first call builds the kernels and warms the
        caching allocators, and on a card a pipelined engine captures
        each bucket's graph. Idempotent; returns the buckets newly run.

        A quantized engine's first warm ends with the int8 warm-up gate
        (:meth:`measure_int8_speedup`) unless
        ``TDN_INT8_WARMUP_MEASURE=0``."""
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
                # Per bucket: a scrape during a long warm sees progress.
                _WARM_BUCKETS.set(len(self._warm_buckets))
            n *= 2
        if (warmed and self._q is not None and not self._int8_measured
                and os.environ.get("TDN_INT8_WARMUP_MEASURE", "1") != "0"):
            self.measure_int8_speedup()
        return warmed

    def measure_int8_speedup(self, rows: int | None = None) -> float | None:
        """Time the engine's f32 and int8 forward of the largest warm
        bucket (or ``rows``) and publish ``tdn_int8_speedup_ratio``.

        Returns f32 time / int8 time (> 1: int8 is faster here), or None
        on an engine that is not quantized. Each arm runs the engine's
        own dispatch (the f32 arm with the quantized state cleared). On
        a card each arm is the device time of its forward: the input
        already resident, one warm forward, then the median of
        ``_GATE_CALLS`` forwards each between two CUDA events on the
        current stream, the card kept busy while the host issues it
        (:func:`~tpu_dist_nn_torch.utils.profiling.device_call_ms`). On
        the CPU each arm is the host wall time of
        ``infer``, best of 3 after one warm call. Where int8 is slower,
        serving is rerouted to the f32 chain (``int8_auto_disabled``)
        unless ``TDN_INT8_AUTO=0``, which measures and warns only.
        Bring-up only: not safe beside live traffic.
        """
        if self._q is None:
            return None
        if rows is None:
            rows = max(self._warm_buckets) if self._warm_buckets else 1
        x = np.zeros((int(rows), self.model.input_dim), np.float32)
        clock = "cuda_events" if self.device.type == "cuda" else "host"

        def device_median() -> float:
            xd = torch.from_numpy(x).to(self.device, self.dtype)
            return device_call_ms(lambda: self._forward(xd), calls=_GATE_CALLS) / 1e3

        def best_of(n: int = 3) -> float:
            self.infer(x)  # warm
            times = []
            for _ in range(n):
                t0 = time.monotonic()
                self.infer(x)
                times.append(time.monotonic() - t0)
            return min(times)

        arm = device_median if clock == "cuda_events" else best_of
        q, self._q = self._q, None
        try:
            f32_s = arm()
        finally:
            self._q = q
        # A re-measurement on a disabled engine times the real int8 path.
        gate, self.int8_auto_disabled = self.int8_auto_disabled, False
        try:
            int8_s = arm()
        finally:
            self.int8_auto_disabled = gate
        ratio = f32_s / int8_s if int8_s > 0 else float("inf")
        if self.mesh is not None and self.mesh.spans_ranks:
            # one verdict for every process: the ranks must serve one path
            ratio = multihost.broadcast_object(ratio, 0)
        self._int8_measured = True
        self.int8_speedup_ratio = ratio
        _INT8_RATIO.set(ratio)
        if ratio < 1.0:
            slog.warning(
                "int8.slower_than_f32", ratio=round(ratio, 3), rows=int(rows),
                f32_ms=round(f32_s * 1e3, 4), int8_ms=round(int8_s * 1e3, 4),
                clock=clock, device=self.device.type,
                hint="serve without --quantize on this device",
            )
            if os.environ.get("TDN_INT8_AUTO", "1") != "0":
                self.int8_auto_disabled = True
                slog.warning(
                    "int8.auto_disabled", ratio=round(ratio, 3), device=self.device.type,
                    hint="serving launches rerouted to the f32 chain "
                         "(TDN_INT8_AUTO=0 opts out of the fallback)",
                )
            else:
                # The opt-out also clears a reroute an earlier
                # measurement armed.
                self.int8_auto_disabled = False
        else:
            self.int8_auto_disabled = False
            slog.info("int8.speedup", ratio=round(ratio, 3), rows=int(rows),
                      f32_ms=round(f32_s * 1e3, 4), int8_ms=round(int8_s * 1e3, 4),
                      clock=clock, device=self.device.type)
        return ratio

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
        ``iters`` synchronous forward steps on a synthetic batch, their
        percentiles, the stage count and ``p50_per_stage_s`` (the step
        p50 over the stage count)."""
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
        num_stages = self.placement()["num_stages"]
        summary = stats.summary()
        summary["num_stages"] = num_stages
        summary["p50_per_stage_s"] = summary["p50_s"] / num_stages
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

    # ------------------------------------------------------------- train

    def train(self, train_data, config=None, eval_data=None, checkpoints=None,
              schedule: str = "gpipe") -> list[dict]:
        """Train the engine's weights in place; returns the history.

        ``config`` is a :class:`~tpu_dist_nn_torch.train.trainer.TrainConfig`
        (default: the reference recipe); ``checkpoints`` a
        :class:`~tpu_dist_nn_torch.checkpoint.CheckpointManager` for
        epoch-level save and resume. A pipelined engine trains through
        its stages with ``schedule`` "gpipe", "1f1b" or, on an
        interleaved placement (which selects it), "interleaved"; a
        single-program engine and a conv model's heterogeneous pipeline
        train "gpipe" only. Afterwards the engine
        serves the trained weights on every path: ``model`` holds them
        in float64 and an int8 engine is re-quantized.
        """
        _TRAIN_CALLS.inc()
        t0 = time.monotonic()
        try:
            return self._train(train_data, config, eval_data, checkpoints, schedule)
        finally:
            _TRAIN_SECONDS.observe(time.monotonic() - t0)

    def _train(self, train_data, config, eval_data, checkpoints, schedule) -> list[dict]:
        validate_schedule(schedule)
        if schedule in ("zb", "zb-v"):
            raise ValueError(
                "zero-bubble schedules are implemented for the "
                "transformer LM pipeline only (tdn lm --schedule zb); "
                "the classifier engine supports gpipe/1f1b/interleaved"
            )
        if self.virtual_stages > 1:
            # V chunks on V/v slots run the interleaved table only.
            if schedule == "1f1b":
                raise ValueError(
                    "schedule='1f1b' does not apply to an interleaved "
                    "(virtual_stages > 1) placement; the schedule is "
                    "'interleaved' there (the default 'gpipe' auto-"
                    "selects it)"
                )
            if schedule == "gpipe":
                log.info("train: interleaved placement (virtual_stages=%d) "
                         "selects schedule='interleaved'", self.virtual_stages)
            schedule = "interleaved"
        elif schedule == "interleaved":
            if self.requested_virtual_stages <= 1:
                raise ValueError(
                    "schedule='interleaved' needs an interleaved placement: "
                    "bring the engine up with virtual_stages=v (tdn train "
                    "--virtual-stages v) so the distribution's V chunks land "
                    "on V/v devices"
                )
            log.warning(
                "train: interleaved placement was collapsed to the "
                "single-chip executor at up() (too few devices); "
                "training with the default schedule"
            )
            schedule = "gpipe"
        # The heterogeneous executor trains through its own GPipe
        # schedule (train_hetero), which has no 1f1b variant.
        if schedule != "gpipe" and (not self.pipelined or self._hp is not None):
            raise ValueError(
                f"schedule={schedule!r} applies to the dense pipelined "
                "placement only (this engine was placed "
                + ("heterogeneous" if self._hp is not None else "single-program")
                + "); place a dense model with a multi-stage distribution "
                "to use it"
            )
        if not self.is_ready:
            raise UnavailableError(
                "engine is down; relaunch with Engine.up from the model JSON"
            )
        config = config or TrainConfig()
        if self._hp is not None:
            from tpu_dist_nn_torch.train.hetero_trainer import train_hetero

            # num_microbatches is an inference knob set at up(); training
            # takes the largest divisor of the batch size not above it.
            mb = max(d for d in range(1, self.num_microbatches + 1)
                     if config.batch_size % d == 0)
            if mb != self.num_microbatches:
                log.log(
                    logging.WARNING if mb == 1 else logging.INFO,
                    "train: using %d microbatches (engine's %d does not "
                    "divide batch_size %d)%s",
                    mb, self.num_microbatches, config.batch_size,
                    " — pipelined training fully serializes; choose a "
                    "batch size with a divisor > 1" if mb == 1 else "",
                )
            params_list, history = train_hetero(
                self._hp, train_data, config, eval_data=eval_data,
                checkpoints=checkpoints, num_microbatches=mb,
            )
            flat = [p for stage_params in params_list for p in stage_params]
            self.model = network_model_from_params(self.model, flat)
            return history
        if self._plan is not None:
            self._params, history = train_network(
                self._plan, self._params, train_data, config,
                eval_data=eval_data, checkpoints=checkpoints,
            )
            self._copies.clear()
            self.model = network_model_from_params(self.model, self._params)
            return history
        if self.pipelined:
            self._pp, history = train_pipelined(
                self._pp, self.mesh, train_data, config,
                num_microbatches=self.num_microbatches, eval_data=eval_data,
                checkpoints=checkpoints, schedule=schedule, num_virtual=self.virtual_stages,
            )
            self.model = extract_model(self._pp, self.model, self.distribution)
            self._placed = place_pipeline(self.mesh, self._pp, num_virtual=self.virtual_stages)
            self._graphs.clear()
        else:
            self._params, history = train_fcnn(
                self._params, train_data, config,
                eval_data=eval_data, checkpoints=checkpoints,
                # Data-sharded placement: train over the data slots too.
                mesh=self.mesh if self.data_sharded else None,
            )
            self._copies.clear()
            layers = [
                dataclasses.replace(layer, weights=p["w"].cpu().double().numpy(),
                                    biases=p["b"].cpu().double().numpy())
                for layer, p in zip(self.model.layers, self._params)
            ]
            self.model = ModelSpec(layers, dict(self.model.metadata))
        if self._q is not None:
            # Re-quantize: the int8 path would otherwise serve the
            # pre-training weights.
            self._quantize()
        return history

    # ------------------------------------------------------------ export

    def export(self, path, metrics: dict | None = None) -> ModelSpec:
        """Write the weights to the public JSON schema, embedding metrics
        under inference_metrics (notebook cell 10 parity)."""
        if metrics is not None:
            self.model.metadata["inference_metrics"] = metrics
        if "layer_distribution" not in self.model.metadata and self.pipelined:
            self.model.metadata["layer_distribution"] = self.distribution
        save_model(self.model, path)
        return self.model

    # -------------------------------------------------------------- down

    def down(self) -> None:
        """Release the device state, after the card has finished every
        operation queued on it (a caller's thread may still hold a
        launched batch). Idempotent; relaunch = ``Engine.up`` again from
        the JSON model (run_grpc_fcnn.py:329-344)."""
        if self.is_ready:
            for dev in {self.device} | (self.mesh.devices if self.mesh is not None else set()):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        self._graphs.clear()
        self._copies.clear()
        self._params = None
        self._placed = None
        self._q = None
        self._hp = None

    @property
    def is_ready(self) -> bool:
        """Attribute-only readiness (no device work): the one predicate
        :meth:`health`, ``/healthz`` and the runtime sampler share."""
        return self._params is not None or self._placed is not None or self._hp is not None

    def fingerprint(self) -> str:
        """Whole-model weights fingerprint
        (:func:`~tpu_dist_nn_torch.serving.integrity.fingerprint_tree`
        over every layer's host float64 weights and biases, the JAX
        Engine's tree), the value ``/healthz`` exposes: one model file
        gives one fingerprint in both packages, whatever the placement
        or quantization. Cached per model object (training replaces
        ``self.model``)."""
        cached = getattr(self, "_fingerprint_cache", None)
        if cached is not None and cached[0] is self.model:
            return cached[1]
        from tpu_dist_nn_torch.serving.integrity import fingerprint_tree

        tree = {}
        for i, layer in enumerate(self.model.layers):
            tree[f"layer{i}/weights"] = layer.weights
            tree[f"layer{i}/biases"] = layer.biases
        fp = fingerprint_tree(tree)["model"]
        self._fingerprint_cache = (self.model, fp)
        return fp

    def health(self, probe: bool = True) -> dict:
        """Structured readiness report (the reference's TCP readiness
        poll, run_grpc_fcnn.py:157-172, as a status). ``probe=False``
        skips the inference probe: the per-request form ``/healthz``
        serves (a poller must not launch device work beside serving)."""
        ready = self.is_ready
        status = {
            "ready": ready,
            "devices": self.mesh_spec.num_devices,
            "pipelined": self.pipelined,
            "setup_seconds": self.setup_seconds,
        }
        try:
            status["fingerprint"] = self.fingerprint()
        except Exception:  # noqa: BLE001 — health must never crash
            pass
        if ready and probe:
            try:
                out = self.infer(np.zeros((1, self.model.input_dim)))
                status["probe_ok"] = bool(np.isfinite(out).all())
            except Exception as e:  # a failing probe is the finding, not a crash
                status["probe_ok"] = False
                status["probe_error"] = repr(e)
        return status



def _moved(tree, device):
    """A copy of a params tree (lists and dicts of tensors and ints) on
    ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_moved(t, device) for t in tree)
    if isinstance(tree, dict):
        return {k: _moved(v, device) for k, v in tree.items()}
    return tree
