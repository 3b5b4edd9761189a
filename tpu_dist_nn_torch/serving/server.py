"""The reference's ``Process`` RPC in front of the port's Engine.

Port of the ``Process`` half of :mod:`tpu_dist_nn.serving.server`:
``LayerService.Process(Matrix) -> Matrix`` (``src/proto/dist_nn.proto:13-15``)
with raw-bytes (de)serialisers and the float64 wire codec of
:mod:`~tpu_dist_nn_torch.serving.wire`, so the reference's own client
(``run_grpc_inference.py``) and the JAX package's ``GrpcClient`` talk to
it unchanged.

Concurrent requests COALESCE: a :class:`Batcher` owns the engine, and
every request that arrives while a batch is in flight joins the next
one. Rows from many clients are landed straight from their wire bytes
into one power-of-two bucket buffer (in the engine's float32), launched
through ``Engine.infer_async`` (one chain kernel for a dense model) and
split per request on reply.

The module imports without grpcio. The handler's body
(:func:`make_process_handler`) is a plain function of request bytes,
metadata and budget that returns reply bytes or raises
:class:`RpcAbort` carrying a status code by name; ``grpc.StatusCode``
appears only in the socket adapter. :func:`serve_engine` and
:class:`GrpcClient` import grpc when called, and raise an
``ImportError`` naming grpcio where it is absent.

Status parity with the JAX server (``grpc_node.py:149-158``): a wrong
width is ``INVALID_ARGUMENT`` with ``expected input of shape (N, D),
got ...`` (checked per request BEFORE coalescing, so one bad client
cannot poison a shared batch), a shed ``RESOURCE_EXHAUSTED`` with the
``x-tdn-retry-after-ms`` trailing header, an expired budget
``DEADLINE_EXCEEDED``, the engine going down ``UNAVAILABLE``, a
numeric-guard failure ``DATA_LOSS``, anything else ``INTERNAL``.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

from tpu_dist_nn_torch.obs import trace as _trace
from tpu_dist_nn_torch.obs.log import get_logger
from tpu_dist_nn_torch.obs.registry import POW2_BUCKETS, REGISTRY
from tpu_dist_nn_torch.serving.resilience import (
    CLIENT_RETRIES,
    RETRYABLE_CODES,
    CircuitBreaker,
    RetryPolicy,
    _code_name,
)
from tpu_dist_nn_torch.serving.sched_core import SchedCore, normalize_class
from tpu_dist_nn_torch.serving.wire import (
    CLASS_HEADER,
    PROCESS_METHOD,
    RETRY_AFTER_HEADER,
    SERVICE_NAME,
    SESSION_HEADER,
    WireMatrix,
    decode_matrix,
    decode_matrix_lazy,
    encode_matrix,
)
from tpu_dist_nn_torch.utils.errors import (
    DeadlineExceededError,
    IntegrityError,
    InvalidArgumentError,
    ResourceExhaustedError,
    UnavailableError,
)

slog = get_logger(__name__)

_RPC_REQUESTS = REGISTRY.counter(
    "tdn_rpc_requests_total", "RPCs received, per method",
    labels=("method",),
)
_RPC_ERRORS = REGISTRY.counter(
    "tdn_rpc_errors_total", "RPCs aborted, per method and status code",
    labels=("method", "code"),
)
_BATCH_ROWS = REGISTRY.histogram(
    "tdn_batch_rows", "coalesced rows per device launch (pre-padding)",
    labels=("method",), buckets=POW2_BUCKETS,
)
_SUBMITS = REGISTRY.counter(
    "tdn_batcher_submits_total", "requests entering the coalescing queue",
    labels=("method",),
)
_ABANDONED = REGISTRY.counter(
    "tdn_batcher_abandoned_total",
    "requests that timed out waiting for their batch",
    labels=("method",),
)
_LAUNCHES = REGISTRY.counter(
    "tdn_batch_launches_total", "device launches issued by the batcher",
    labels=("method",),
)


# Rows a batch takes at most (whole requests; a larger lone request
# rides alone).
MAX_BATCH_ROWS = 65536


def _import_grpc():
    try:
        import grpc
    except ImportError as e:
        raise ImportError(
            "the gRPC socket needs grpcio, which is not installed; the "
            "Process handler body and the batcher run without it"
        ) from e
    return grpc


class Batcher:
    """Two-stage (double-buffered) micro-batching pipeline in front of
    one engine (the JAX package's ``_Batcher``).

    ``submit(x)`` blocks the calling (gRPC worker) thread until its
    rows' results are ready. Two daemon threads own the engine:

    * **dispatch** pops everything pending (up to ``MAX_BATCH_ROWS``
      rows, critical class first), lands it in a reusable per-bucket
      host buffer (wire rows decoded straight in, pad tail zeroed in
      place) and LAUNCHES it with ``engine.infer_async``: on the card
      the engine copies the buffer into pinned memory, queues the copy
      to the device, the kernels and the copy back on the current CUDA
      stream, and returns a handle without a host sync.
    * **drain** waits for launched batches in order
      (``engine.fetch``, the one host sync a batch), slices the result
      per request and wakes the waiting workers. A batch's buffer goes
      back to its pool only after its fetch.

    So batch N+1 is assembled and launched while batch N is still
    computing and copying back. ``pipeline_depth=1`` collapses to a
    strictly serial loop (dispatch fetches inline).
    Arrival during an in-flight batch is the coalescing window: no
    delay is ever added.
    """

    def __init__(self, engine, submit_timeout: float | None = 120.0,
                 pipeline_depth: int = 2, max_pending_rows: int | None = None,
                 class_watermarks: dict | None = None):
        self._engine = engine
        self._core = SchedCore(
            "Process", max_pending_rows=max_pending_rows,
            submit_timeout=submit_timeout,
            class_watermarks=class_watermarks,
        )
        self._serial = pipeline_depth <= 1
        # Launched-but-not-drained hand-off. The SEMAPHORE is the
        # launch-ahead bound: dispatch takes a slot BEFORE staging or
        # launching, drain returns it after the fetch, so at most
        # pipeline_depth batches (and staging buffers) are outstanding.
        self._launched: queue.Queue = queue.Queue()
        self._slots = threading.Semaphore(max(1, pipeline_depth))
        # Reusable staging buffers, keyed (bucket, feature-shape,
        # dtype) -> free list. Dispatch pops (sole consumer), drain
        # returns a buffer only AFTER its batch's fetch.
        self._staging: dict[tuple, list[np.ndarray]] = {}
        self._staging_keep = max(2, pipeline_depth)
        # batches < requests under load is the evidence of coalescing.
        self.batches_total = 0
        self.rows_total = 0
        self._m_submits = _SUBMITS.labels(method="Process")
        self._m_abandoned = _ABANDONED.labels(method="Process")
        self._m_launches = _LAUNCHES.labels(method="Process")
        self._m_rows = _BATCH_ROWS.labels(method="Process")
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, name="tdn-serve-dispatch", daemon=True
        )
        self._drain_thread = None
        if not self._serial:
            self._drain_thread = threading.Thread(
                target=self._drain_loop, name="tdn-serve-drain", daemon=True
            )
            self._drain_thread.start()
        self._dispatch_thread.start()

    @property
    def pending_rows(self) -> int:
        return self._core.pending_rows

    @property
    def requests_total(self) -> int:
        return self._core.requests_total

    @property
    def shed_total(self) -> int:
        return self._core.shed_total

    @property
    def expired_total(self) -> int:
        return self._core.expired_total

    def submit(self, x, timeout: float | None = None, ctx=None,
               slo_class: str = "standard") -> np.ndarray:
        """Block until this request's rows are served.

        ``timeout`` is the CALLER's remaining budget (the RPC deadline):
        the wait is ``min(timeout, submit_timeout)``, and the same
        budget is the entry's queue deadline (an entry still queued
        when it expires fails DEADLINE_EXCEEDED without a launch).
        ``slo_class`` sets its queue priority and shed watermark.
        ``ctx`` is the request's sampled
        :class:`~tpu_dist_nn_torch.obs.trace.SpanContext`: its passage
        is recorded as queue_wait / stage / launch / fetch spans.
        """
        item = {"x": x, "done": threading.Event(), "out": None, "err": None,
                "abandoned": False, "slo_class": slo_class,
                "t_submit": time.monotonic(),
                "ctx": ctx if ctx is not None and ctx.sampled else None}
        self._core.admit(item, timeout)
        self._m_submits.inc()
        try:
            self._core.wait(item, what="coalesced batch")
        except Exception:
            if item["abandoned"]:
                self._m_abandoned.inc()
            raise
        return item["out"]

    def _stage(self, group: list[dict]):
        """Assemble a width-group into a pow2-bucket staging buffer.

        Buckets keep the set of launch shapes small (log2 of the largest
        batch) and the warm-up ladder finite. Returns ``(xs, key,
        buf)``; ``buf`` is None on the zero-copy single-request lane (a
        lone decoded array already ON a bucket boundary is launched as
        it is; the engine's pinned copy is then its only copy).
        """
        n = sum(len(it["x"]) for it in group)
        n_pad = 1 << (n - 1).bit_length() if n > 1 else 1
        if (len(group) == 1 and n == n_pad
                and not isinstance(group[0]["x"], WireMatrix)):
            return group[0]["x"], None, None
        feat = tuple(group[0]["x"].shape[1:])
        dtype = group[0]["x"].dtype
        key = (n_pad, feat, str(dtype))
        pool = self._staging.get(key)
        buf = pool.pop() if pool else None
        if buf is None:
            buf = np.empty((n_pad, *feat), dtype)
        ofs = 0
        for it in group:
            x = it["x"]
            k = len(x)
            if isinstance(x, WireMatrix):
                # Wire bytes -> this bucket buffer in ONE cast-copy.
                x.read_into(buf, ofs)
            else:
                buf[ofs:ofs + k] = x
            ofs += k
        if ofs < n_pad:
            buf[ofs:] = 0  # zero the pad tail in place
        return buf, key, buf

    def _release(self, key, buf) -> None:
        """Drain-side buffer return, after the fetch. Single producer
        (drain) / single consumer (dispatch) per list: GIL-atomic list
        ops suffice."""
        if buf is None:
            return
        pool = self._staging.setdefault(key, [])
        if len(pool) < self._staging_keep:
            pool.append(buf)

    def _drain_one(self, group, handle, key, buf, launched_rows) -> None:
        """Fetch one launched batch and fan results out per request."""
        t_fetch = time.monotonic()
        err = None
        notes: list = []
        traced = any(it["ctx"] is not None for it in group)
        try:
            if traced:
                with _trace.annotation_sink() as notes:
                    out = self._engine.fetch(handle)
            else:
                out = self._engine.fetch(handle)
            ofs = 0
            for it in group:
                k = len(it["x"])
                it["out"] = out[ofs:ofs + k]
                ofs += k
        except Exception as e:  # noqa: BLE001 — fanned out per request
            err = e
            for it in group:
                it["err"] = e
        finally:
            dur = time.monotonic() - t_fetch
            if err is not None:
                notes = notes + [
                    (time.monotonic(), f"error: {type(err).__name__}: {err}")
                ]
            for it in group:
                if it["ctx"] is not None:
                    _trace.TRACER.record_span(
                        "fetch", it["ctx"], t_fetch, dur,
                        attrs={"rows": len(it["x"]),
                               "batch_rows": launched_rows},
                        annotations=notes,
                    )
            if err is None:
                # Completions feed the drain-rate window behind the
                # shed replies' x-tdn-retry-after-ms hint.
                self._core.note_drained(sum(len(it["x"]) for it in group))
            self._release(key, buf)
            self._slots.release()
            for it in group:
                it["done"].set()

    def _dispatch_loop(self) -> None:
        core = self._core
        while True:
            with core.cond:
                while not core.has_pending() and not core.closed:
                    core.cond.wait()
                if not core.has_pending() and core.closed:
                    if not self._serial:
                        self._launched.put(None)  # drain's shutdown pill
                    return
                # Class-priority pop; abandoned entries are discarded
                # and budget-expired ones failed DEADLINE_EXCEEDED here.
                batch, rows = core.pop_group(MAX_BATCH_ROWS)
                self.rows_total += rows
            core.drain_deferred()
            if not batch:
                continue
            t_pop = time.monotonic()
            for it in batch:
                if it["ctx"] is not None:
                    _trace.TRACER.record_span(
                        "queue_wait", it["ctx"], it["t_submit"],
                        t_pop - it["t_submit"],
                    )
            # One launch per feature width: an engine without a declared
            # input_dim cannot be pre-validated in the handler, and a
            # mixed-width batch would fail EVERY request in it.
            groups: dict[tuple, list[dict]] = {}
            for it in batch:
                groups.setdefault(
                    (it["x"].shape[1:], str(it["x"].dtype)), []
                ).append(it)
            for group in groups.values():
                # The launch-ahead slot BEFORE staging/launching: blocks
                # here while pipeline_depth batches are outstanding.
                self._slots.acquire()
                key = buf = None
                traced = [it for it in group if it["ctx"] is not None]
                group_rows = sum(len(it["x"]) for it in group)
                try:
                    t_stage = time.monotonic()
                    xs, key, buf = self._stage(group)
                    t_launch = time.monotonic()
                    if traced:
                        with _trace.annotation_sink() as notes:
                            handle = self._engine.infer_async(xs)
                    else:
                        handle = self._engine.infer_async(xs)
                    t_launched = time.monotonic()
                    for it in traced:
                        _trace.TRACER.record_span(
                            "stage", it["ctx"], t_stage, t_launch - t_stage,
                            attrs={"rows": len(it["x"]),
                                   "batch_rows": len(xs),
                                   "zero_copy": buf is None},
                        )
                        _trace.TRACER.record_span(
                            "launch", it["ctx"], t_launch,
                            t_launched - t_launch,
                            attrs={"batch_rows": len(xs)},
                            annotations=notes,
                        )
                except Exception as e:  # noqa: BLE001 — fanned out per request
                    # Failed before reaching the device (validation, a
                    # downed engine): the launch counters do NOT tick.
                    self._release(key, buf)
                    self._slots.release()
                    for it in group:
                        it["err"] = e
                        it["done"].set()
                    continue
                self.batches_total += 1
                self._m_launches.inc()
                self._m_rows.observe(group_rows)
                if self._serial:
                    self._drain_one(group, handle, key, buf, len(xs))
                else:
                    self._launched.put((group, handle, key, buf, len(xs)))

    def _drain_loop(self) -> None:
        while True:
            item = self._launched.get()
            if item is None:
                return
            self._drain_one(*item)

    def close(self, timeout: float = 10.0) -> None:
        """Dispatch drains the queue then pills the drain thread, which
        finishes every launched batch: both stages are empty when close
        returns. Anything still queued (a wedged dispatch never popped
        it) fails over UNAVAILABLE."""
        self._core.close_begin()
        self.join(timeout)
        self._core.sweep_leftovers()

    def join(self, timeout: float | None = None) -> bool:
        """Wait for the dispatch and drain threads to end (each within
        ``timeout``); True when neither is alive."""
        threads = [t for t in (self._dispatch_thread, self._drain_thread) if t is not None]
        for t in threads:
            t.join(timeout=timeout)
        return not any(t.is_alive() for t in threads)


class RpcAbort(Exception):
    """The status an RPC ends with: ``code`` is a gRPC status code NAME
    (``"INVALID_ARGUMENT"``), ``trailing`` the trailing metadata
    (always the server's trace id; a shed adds its retry-after hint)."""

    def __init__(self, code: str, message: str, trailing: tuple = ()):
        super().__init__(message)
        self.code = code
        self.message = message
        self.trailing = tuple(trailing)


def _request_span(metadata: dict, time_remaining: float | None, method: str):
    """Begin the handler span for one RPC and derive its wait budget.

    An inbound ``x-tdn-trace`` header makes the handler a child in the
    caller's trace (and inherits its sampling decision); without one it
    is a new root. The budget is ``min(deadline remaining,
    x-tdn-timeout-ms hint)`` over whichever exist."""
    parent = _trace.SpanContext.from_header(metadata.get(_trace.TRACE_HEADER))
    span = _trace.TRACER.start(f"rpc.{method}", parent=parent)
    bounds = []
    # Deadline-less calls can report a far-future sentinel (~1e10 s).
    if time_remaining is not None and time_remaining < 1e9:
        bounds.append(time_remaining)
    hint = metadata.get(_trace.TIMEOUT_HEADER)
    if hint is not None:
        try:
            bounds.append(float(hint) / 1000.0)
        except ValueError:
            pass  # a garbled hint must not fail the RPC
    return span, (min(bounds) if bounds else None)


def _abort(method: str, code: str, message: str, trailing: tuple = ()):
    """Count, then raise: one funnel for every abort."""
    _RPC_ERRORS.labels(method=method, code=code).inc()
    raise RpcAbort(code, message, trailing)


def _abort_for_exception(e, what: str, method: str = "Process",
                         trailing: tuple = ()):
    """Map the port's exceptions to the reference's gRPC status taxonomy
    (``grpc_node.py:149-158``) with the JAX server's codes and messages."""
    if isinstance(e, InvalidArgumentError):
        _abort(method, "INVALID_ARGUMENT", str(e), trailing)
    if isinstance(e, IntegrityError):
        # The result exists but cannot be trusted: not a transient
        # status, so a client never retries the same weights.
        _abort(method, "DATA_LOSS", str(e), trailing)
    if isinstance(e, DeadlineExceededError):
        _abort(method, "DEADLINE_EXCEEDED", str(e), trailing)
    if isinstance(e, ResourceExhaustedError):
        retry_after = getattr(e, "retry_after_ms", None)
        if retry_after is not None:
            trailing = tuple(trailing) + ((RETRY_AFTER_HEADER, str(int(retry_after))),)
        _abort(method, "RESOURCE_EXHAUSTED", str(e), trailing)
    if isinstance(e, UnavailableError):
        _abort(method, "UNAVAILABLE", str(e), trailing)
    slog.exception("rpc.internal_error", method=method, what=what,
                   error=f"{type(e).__name__}: {e}")
    _abort(method, "INTERNAL", f"{what} failed: {e}", trailing)


def make_process_handler(engine, batcher: Batcher | None):
    """The ``Process`` handler's body: ``process(request_bytes,
    metadata=None, time_remaining=None) -> (reply_bytes, trailing)``,
    raising :class:`RpcAbort`. ``metadata`` is the invocation metadata
    as a dict; ``time_remaining`` the RPC deadline's seconds left. With
    a ``batcher`` requests coalesce; without one they run one at a time
    under a lock through ``engine.infer``. Needs no grpcio."""
    lock = threading.Lock()
    # Per-request width validation BEFORE coalescing.
    expected_dim = getattr(getattr(engine, "model", None), "input_dim", None)
    # Rows land in the engine's own compute dtype (the port's Engine
    # declares float32); the float64 wire contract stops at the socket.
    wire_dtype = getattr(engine, "numpy_dtype", np.float64)

    def process(request_bytes: bytes, metadata: dict | None = None,
                time_remaining: float | None = None):
        _RPC_REQUESTS.labels(method="Process").inc()
        md = metadata or {}
        span, budget = _request_span(md, time_remaining, "Process")
        trailing = ((_trace.TRACE_ID_HEADER, span.ctx.trace_id),)
        # SLO class rides x-tdn-class (missing/unknown -> standard).
        slo_class = normalize_class(md.get(CLASS_HEADER))
        try:
            try:
                # Structure probe only on the fast path: a WireMatrix
                # carries the shape while the payload stays untouched
                # until the batcher lands it in a staging buffer.
                with _trace.TRACER.span("decode", span.ctx):
                    x = decode_matrix_lazy(request_bytes, dtype=wire_dtype)
            except ValueError as e:
                span.annotate(f"abort INVALID_ARGUMENT: bad Matrix: {e}")
                _abort("Process", "INVALID_ARGUMENT", f"bad Matrix: {e}", trailing)
            span.set("rows", len(x))
            span.set("slo_class", slo_class)
            if md.get(SESSION_HEADER):
                span.set("session", md[SESSION_HEADER])
            if budget is not None:
                span.set("budget_ms", int(budget * 1000))
            span.set("dim", int(x.shape[1]))
            if batcher is not None and expected_dim is not None \
                    and x.shape[1] != expected_dim:
                # The reference's dim check (grpc_node.py:149-153).
                span.annotate("abort INVALID_ARGUMENT: width mismatch")
                _abort("Process", "INVALID_ARGUMENT",
                       f"expected input of shape (N, {expected_dim}), got "
                       f"{tuple(x.shape)}", trailing)
            try:
                if batcher is not None:
                    out = batcher.submit(x, timeout=budget, ctx=span.ctx,
                                         slo_class=slo_class)
                else:
                    with lock, _trace.TRACER.activate(span):
                        out = engine.infer(x)
            except Exception as e:  # noqa: BLE001 — mapped to status codes
                span.annotate(f"error: {type(e).__name__}: {e}")
                _abort_for_exception(e, "inference", "Process", trailing)
            with _trace.TRACER.span("encode", span.ctx):
                # The codec casts to wire float64 per stripe.
                return encode_matrix(out), trailing
        finally:
            span.end()

    return process


def _grpc_service(grpc, process):
    """The socket adapter: invocation metadata and deadline in,
    trailing metadata and ``grpc.StatusCode`` out."""

    def handler(request_bytes: bytes, context) -> bytes:
        md = dict(context.invocation_metadata() or ())
        try:
            reply, trailing = process(request_bytes, md, context.time_remaining())
        except RpcAbort as e:
            context.set_trailing_metadata(e.trailing)
            context.abort(grpc.StatusCode[e.code], e.message)
        context.set_trailing_metadata(trailing)
        return reply

    rpc = grpc.unary_unary_rpc_method_handler(
        handler,
        request_deserializer=bytes,   # raw bytes in, our codec decodes
        response_serializer=bytes,
    )
    return grpc.method_handlers_generic_handler(SERVICE_NAME, {"Process": rpc})


def _new_grpc_server(grpc):
    """The reference's server shape: a 10-thread pool + unlimited
    messages (grpc_node.py:169, run_grpc_inference.py:124-127)."""
    from concurrent import futures

    return grpc.server(
        futures.ThreadPoolExecutor(max_workers=10),
        options=[
            ("grpc.max_send_message_length", -1),
            ("grpc.max_receive_message_length", -1),
        ],
    )


def _bind_or_close(server, host: str, port: int, batcher) -> int:
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        if batcher is not None:
            batcher.close()
        raise OSError(f"could not bind gRPC server to port {port}")
    return bound


def _wrap_server_stop(server, batcher) -> None:
    """server.stop() also stops the batcher, but only AFTER the grace
    drain: closing at once would turn in-flight RPCs that have not
    reached submit() yet into UNAVAILABLE during the window the caller
    asked to protect. ``server.join_closed(timeout)`` waits for that
    close (its thread, then the batcher's dispatch and drain threads):
    a caller that tears CUDA down afterwards finds no serving thread
    still inside the engine."""
    closers: list[threading.Thread] = []

    def join_closed(timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout

        def left():
            return None if deadline is None else max(0.0, deadline - time.monotonic())

        for t in closers:
            t.join(timeout=left())
        done = not any(t.is_alive() for t in closers)
        return (batcher.join(left()) if batcher is not None else True) and done

    server.join_closed = join_closed
    if batcher is None:
        return
    inner_stop = server.stop

    def stop(grace=None):
        ev = inner_stop(grace)
        if grace:
            def _close_after_drain():
                ev.wait()
                batcher.close()

            t = threading.Thread(target=_close_after_drain, name="tdn-serve-close",
                                 daemon=True)
            closers.append(t)
            t.start()
        else:
            batcher.close()
        return ev

    server.stop = stop


def serve_engine(engine, port: int, *, host: str = "0.0.0.0",
                 coalesce: bool = True, warm_rows: int = 0,
                 pipeline_depth: int = 2,
                 max_pending_rows: int | None = None,
                 class_watermarks: dict | None = None):
    """Start a gRPC server bound to ``host:port``; returns ``(server,
    bound_port)`` (``port=0`` picks an ephemeral port; ``host=
    "127.0.0.1"`` keeps self-checks off the network).

    The server runs the reference's 10-thread pool
    (``grpc_node.py:169``). ``coalesce=True`` batches concurrent
    requests (:class:`Batcher`, exposed as ``server.batcher``);
    ``False`` runs one request at a time under an engine lock.
    ``warm_rows > 0`` runs the bucket ladder (powers of two up to
    ``warm_rows``) through ``engine.warm_buckets`` before the port
    opens. ``pipeline_depth`` is the batcher's launch-ahead window (1 =
    serial); ``max_pending_rows`` the admission watermark past which a
    request is shed RESOURCE_EXHAUSTED; ``class_watermarks`` the
    per-class fractions of it. ``server.stop()`` also closes the
    batcher, after the grace drain. Needs grpcio.
    """
    grpc = _import_grpc()
    server = _new_grpc_server(grpc)
    batcher = (
        Batcher(engine, pipeline_depth=pipeline_depth,
                max_pending_rows=max_pending_rows,
                class_watermarks=class_watermarks)
        if coalesce else None
    )
    if coalesce and warm_rows > 0:
        # Bucket shapes only exist on the coalescing path.
        engine.warm_buckets(warm_rows)
    server.add_generic_rpc_handlers(
        (_grpc_service(grpc, make_process_handler(engine, batcher)),)
    )
    bound = _bind_or_close(server, host, port, batcher)
    server.batcher = batcher
    _wrap_server_stop(server, batcher)
    server.start()
    slog.info("server.start", method="Process", port=bound,
              coalesce=coalesce, pipeline_depth=pipeline_depth,
              warm_rows=warm_rows, max_pending_rows=max_pending_rows)
    return server, bound


_CLIENT_DEFAULT = object()  # "use the built-in default" sentinel


class GrpcClient:
    """Client for the Process RPC — the ``infer --target`` transport
    (the reference client's ``run_batch_inference``,
    ``run_grpc_inference.py:112-158``: one persistent channel, unlimited
    message sizes, float64 rows).

    A transient failure (UNAVAILABLE / DEADLINE_EXCEEDED) or a shed is
    retried under a :class:`RetryPolicy` with capped jittered backoff
    (a shed's ``x-tdn-retry-after-ms`` is the backoff floor), every
    attempt's deadline carved from the REMAINING ``timeout``; a
    per-target :class:`CircuitBreaker` fails fast with
    :class:`UnavailableError` while the target is known-dead. Pass
    ``retry=None`` / ``breaker=None`` for one attempt.
    ``wait_for_ready=True`` blocks construction on channel readiness
    for up to ``ready_timeout`` seconds. ``session_key`` and
    ``slo_class`` ride every call as ``x-tdn-session`` / ``x-tdn-class``
    (per-call override in :meth:`process`). Needs grpcio.
    """

    def __init__(self, target: str, timeout: float = 30.0, *,
                 retry=_CLIENT_DEFAULT, breaker=_CLIENT_DEFAULT,
                 wait_for_ready: bool = False, ready_timeout: float = 5.0,
                 session_key: str | None = None,
                 slo_class: str | None = None):
        grpc = self._grpc = _import_grpc()
        self.target = target
        self.timeout = timeout
        self.session_key = session_key
        self.slo_class = slo_class
        self._retry = RetryPolicy() if retry is _CLIENT_DEFAULT else retry
        self._breaker = (
            CircuitBreaker.for_target(target)
            if breaker is _CLIENT_DEFAULT else breaker
        )
        self._channel = grpc.insecure_channel(
            target,
            options=[
                ("grpc.max_send_message_length", -1),
                ("grpc.max_receive_message_length", -1),
            ],
        )
        if wait_for_ready:
            fut = grpc.channel_ready_future(self._channel)
            try:
                fut.result(timeout=ready_timeout)
            except grpc.FutureTimeoutError:
                fut.cancel()
                self._channel.close()
                raise UnavailableError(
                    f"server at {target} not ready within {ready_timeout}s "
                    "(readiness poll timed out; is it up?)"
                ) from None
        self._call = self._channel.unary_unary(
            PROCESS_METHOD,
            request_serializer=bytes,
            response_deserializer=bytes,
        )

    @staticmethod
    def _enrich(e, span) -> tuple:
        """Attach ``server_trace_id`` / ``retry_after_ms`` to a failed
        RPC and return its status code and trace id."""
        trace_id = span.ctx.trace_id  # the id we propagated
        retry_after = None
        try:
            for k, v in e.trailing_metadata() or ():
                if k == _trace.TRACE_ID_HEADER:
                    trace_id = v  # the server's own root, if any
                elif k == RETRY_AFTER_HEADER:
                    try:
                        retry_after = int(v)
                    except (TypeError, ValueError):
                        pass  # a garbled hint is no hint
        except Exception:  # noqa: BLE001 — best-effort enrichment
            pass
        e.server_trace_id = trace_id
        e.retry_after_ms = retry_after
        code = None
        try:
            code = e.code()
        except Exception:  # noqa: BLE001
            pass
        return code, trace_id

    def _traced_call(self, payload: bytes, session_key=_CLIENT_DEFAULT,
                     slo_class=_CLIENT_DEFAULT) -> bytes:
        """One LOGICAL call (original attempt + bounded retries) under
        one client span; a final failure names the server-side trace
        (``e.server_trace_id``)."""
        method = "Process"
        policy, breaker = self._retry, self._breaker
        session = (
            self.session_key if session_key is _CLIENT_DEFAULT
            else session_key
        )
        cls = self.slo_class if slo_class is _CLIENT_DEFAULT else slo_class
        span = _trace.TRACER.start(f"client.{method}")
        deadline = (
            time.monotonic() + self.timeout if self.timeout is not None
            else None
        )
        attempt = 0
        last_err = None
        try:
            while True:
                attempt += 1
                if breaker is not None and not breaker.allow():
                    span.annotate(f"breaker open for {self.target}: fail-fast")
                    raise UnavailableError(
                        f"circuit breaker open for {self.target} (too many "
                        "consecutive failures; cooling down)"
                    )
                remaining = None
                if deadline is not None:
                    # This attempt gets whatever the ORIGINAL call has left.
                    remaining = deadline - time.monotonic()
                    if last_err is not None and remaining <= 0.001:
                        span.annotate(
                            f"retry budget exhausted before attempt {attempt}"
                        )
                        raise last_err
                metadata = ((_trace.TRACE_HEADER, span.ctx.header()),)
                if session is not None:
                    metadata += ((SESSION_HEADER, session),)
                if cls is not None:
                    metadata += ((CLASS_HEADER, cls),)
                if remaining is not None:
                    metadata += (
                        (_trace.TIMEOUT_HEADER,
                         str(max(0, int(remaining * 1000)))),
                    )
                try:
                    reply = self._call(payload, timeout=remaining,
                                       metadata=metadata)
                    if breaker is not None:
                        breaker.record_success()
                    if attempt > 1:
                        span.annotate(f"succeeded on attempt {attempt}")
                    return reply
                except self._grpc.RpcError as e:
                    code, trace_id = self._enrich(e, span)
                    last_err = e
                    # Only TRANSIENT statuses say anything about target
                    # health; any other status proves the target answered.
                    transient = (
                        policy.retryable(code) if policy is not None
                        else _code_name(code) in RETRYABLE_CODES
                    )
                    if breaker is not None:
                        if transient:
                            breaker.record_failure()
                        else:
                            breaker.record_success()
                    # A shed is retryable (the server asked for a paced
                    # retry) but never counts against the breaker.
                    shed = _code_name(code) == "RESOURCE_EXHAUSTED"
                    retryable = policy is not None and (transient or shed)
                    out_of_attempts = (
                        policy is None or attempt >= policy.max_attempts
                    )
                    floor = (
                        e.retry_after_ms / 1000.0
                        if getattr(e, "retry_after_ms", None) else None
                    )
                    delay = (
                        0.0 if out_of_attempts
                        else policy.backoff(attempt, floor=floor)
                    )
                    out_of_budget = (
                        deadline is not None
                        and time.monotonic() + delay >= deadline
                    )
                    if not retryable or out_of_attempts or out_of_budget:
                        why = (
                            "not retryable" if not retryable
                            else "attempts exhausted" if out_of_attempts
                            else "retry budget exhausted"
                        )
                        span.annotate(
                            f"rpc error {code} on attempt {attempt} ({why}): "
                            f"server trace {trace_id}"
                        )
                        slog.warning(
                            "client.rpc_failed", method=method,
                            target=self.target, code=str(code),
                            attempt=attempt, why=why, trace_id=trace_id,
                        )
                        raise
                    CLIENT_RETRIES.labels(method=method).inc()
                    span.annotate(
                        f"retry {attempt} after {code}: backoff {delay:.4f}s"
                    )
                    policy.sleep(delay)
        finally:
            span.end()

    def process(self, x, session_key=_CLIENT_DEFAULT,
                slo_class=_CLIENT_DEFAULT) -> np.ndarray:
        """``(N, D)`` rows -> ``(N, out_dim)`` float64 outputs."""
        reply = self._traced_call(encode_matrix(x), session_key=session_key,
                                  slo_class=slo_class)
        return decode_matrix(reply)

    def close(self) -> None:
        self._channel.close()
