"""The reference's ``Process`` RPC in front of the port's Engine, and LM
generation (``Generate``, ``GenerateStream``).

Port of :mod:`tpu_dist_nn.serving.server` (the pipelined decoder behind
``num_stages > 1`` waits for its slice):
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
numeric-guard failure ``DATA_LOSS`` (only the requests whose rows are
non-finite: ``Engine.fetch`` leaves the launch's row mask on its
handle), anything else ``INTERNAL``.

Generation (:func:`serve_lm_generate`): the continuous scheduler
(:mod:`~tpu_dist_nn_torch.serving.continuous`) or the run-to-completion
:class:`Batcher` over ``generate`` behind ``Generate`` (prompts ``(N,
T)`` of token ids as doubles in, ``(N, T + max_new_tokens)`` out) and,
on the continuous scheduler, ``GenerateStream`` (one prompt in, TOKENS /
END frames out as the scheduler produces tokens). Their handler bodies,
like ``Process``'s, need no grpcio.
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
from tpu_dist_nn_torch.serving.stream import note_stream_resumed
from tpu_dist_nn_torch.serving.wire import (
    CLASS_HEADER,
    GENERATE_METHOD,
    GENERATE_STREAM_METHOD,
    PROCESS_METHOD,
    RETRY_AFTER_HEADER,
    SERVICE_NAME,
    SESSION_HEADER,
    STREAM_RESUME_HEADER,
    STREAM_RESUME_MAX_TOKENS,
    WireMatrix,
    decode_frame,
    decode_matrix,
    decode_matrix_lazy,
    encode_end_frame,
    encode_matrix,
    encode_token_frame,
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


def _to_host(out) -> np.ndarray:
    """A run function's result as host numpy: a (device) tensor is
    copied back, the one host sync of its launch."""
    return out.cpu().numpy() if hasattr(out, "cpu") else np.asarray(out)


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
    strictly serial loop (dispatch fetches inline). ``run_fn`` replaces
    the engine by any ``rows -> rows`` launch (the static Generate arm),
    ``method`` names the RPC in the metrics, ``account_fn`` books each
    drained launch (goodput).
    Arrival during an in-flight batch is the coalescing window: no
    delay is ever added.
    """

    def __init__(self, engine, submit_timeout: float | None = 120.0,
                 pipeline_depth: int = 2, max_pending_rows: int | None = None,
                 class_watermarks: dict | None = None, *, run_fn=None,
                 method: str = "Process", account_fn=None):
        # The device launch the batcher owns, split into a dispatch half
        # (launch, ideally without a host sync) and a fetch half (the
        # sync): engine.infer_async / engine.fetch, or any ``rows (n,
        # ...) -> rows (n, ...)`` closure (the static Generate endpoint
        # passes its decode runner; a device tensor it returns is
        # fetched by the drain stage). Coalescing, bucketing,
        # abandonment and error fan-out are the same either way.
        # An engine whose infer_async takes ``useful_rows`` is told each
        # launch's pre-padding row count, so the goodput plane books
        # bucket pad exactly (a fake with a one-argument infer_async
        # keeps working).
        self._useful_aware = False
        if run_fn is not None:
            self._dispatch_fn, self._fetch_fn = run_fn, _to_host
        else:
            self._dispatch_fn, self._fetch_fn = engine.infer_async, engine.fetch
            try:
                import inspect

                self._useful_aware = "useful_rows" in inspect.signature(
                    engine.infer_async).parameters
            except (TypeError, ValueError):
                pass
        # Post-fetch accounting seam: (materialized output, useful_rows,
        # launched_rows, dead_rows=) after each drain — the static
        # Generate path's goodput record. Never fails a request.
        self._account_fn = account_fn
        self.method = method
        self._core = SchedCore(
            method, max_pending_rows=max_pending_rows,
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
        # Launches issued while a previously launched batch had not
        # finished draining (tdn_batcher_overlap_ratio =
        # overlapped_total / batches_total), and the rows launched and
        # not yet drained (the sampler's in-flight gauge).
        self.overlapped_total = 0
        self.inflight_rows = 0
        self.inflight_batches = 0
        self._stats_lock = threading.Lock()
        self._m_submits = _SUBMITS.labels(method=method)
        self._m_abandoned = _ABANDONED.labels(method=method)
        self._m_launches = _LAUNCHES.labels(method=method)
        self._m_rows = _BATCH_ROWS.labels(method=method)
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

    def queue_depth(self) -> int:
        """Entries queued (lock-free; the runtime sampler's per-tick read)."""
        return self._core.queue_depth()

    def pending_by_class(self) -> dict:
        return self._core.pending_by_class()

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
                    out = self._fetch_fn(handle)
            else:
                out = self._fetch_fn(handle)
            # Per-row integrity verdict (Engine.fetch leaves a bad-row
            # mask on the handle when the numeric guard tripped): only
            # the requests with a corrupt row fail, with INTEGRITY, and
            # every other request of the launch ships its slice as is.
            bad = getattr(handle, "bad_rows", None)
            ofs = 0
            for it in group:
                k = len(it["x"])
                if bad is not None and bad[ofs:ofs + k].any():
                    it["err"] = IntegrityError(
                        f"numeric guard: {int(bad[ofs:ofs + k].sum())} "
                        f"of this request's {k} rows carried non-finite "
                        f"or out-of-magnitude activations"
                    )
                else:
                    it["out"] = out[ofs:ofs + k]
                ofs += k
            if self._account_fn is not None:
                # Best effort: accounting never fails a request that
                # already has its result. Rows whose waiter abandoned
                # after dispatch are booked as pad (dead_waiter).
                try:
                    dead = sum(len(it["x"]) for it in group if it["abandoned"])
                    self._account_fn(out, ofs, launched_rows, dead_rows=dead)
                except Exception:  # noqa: BLE001 — accounting only
                    slog.exception("batcher.account_failed", method=self.method)
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
            with self._stats_lock:
                self.inflight_batches -= 1
                self.inflight_rows -= launched_rows
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
                    kw = {"useful_rows": group_rows} if self._useful_aware else {}
                    if traced:
                        with _trace.annotation_sink() as notes:
                            handle = self._dispatch_fn(xs, **kw)
                    else:
                        handle = self._dispatch_fn(xs, **kw)
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
                with self._stats_lock:
                    if self.inflight_batches:
                        # A prior batch is still materializing while
                        # this one launched: that IS the overlap.
                        self.overlapped_total += 1
                    self.inflight_batches += 1
                    self.inflight_rows += len(xs)
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


def _grpc_service(grpc, process, method: str = "Process"):
    """The socket adapter of a unary body (``process`` or
    ``generate``): invocation metadata and deadline in, trailing
    metadata and ``grpc.StatusCode`` out."""

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
    return grpc.method_handlers_generic_handler(SERVICE_NAME, {method: rpc})


def _new_grpc_server(grpc, max_workers: int = 10):
    """The reference's server shape: a 10-thread pool + unlimited
    messages (grpc_node.py:169, run_grpc_inference.py:124-127)."""
    from concurrent import futures

    return grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
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


# ------------------------------------------------------------ generation


def _check_prompts(x, shape_ok: bool, shape_msg: str, vocab_size: int, method: str,
                   span, trailing) -> np.ndarray:
    """The Generate methods' request checks, in the JAX server's order
    and texts: the prompt shape, then integer token ids in range."""
    if not shape_ok:
        span.annotate("abort INVALID_ARGUMENT: prompt shape")
        _abort(method, "INVALID_ARGUMENT", shape_msg, trailing)
    ids = x.astype(np.int64)
    if (ids != x).any() or (ids < 0).any() or (ids >= vocab_size).any():
        span.annotate("abort INVALID_ARGUMENT: token id range")
        _abort(method, "INVALID_ARGUMENT",
               f"prompts must be integer token ids in [0, {vocab_size})", trailing)
    return ids


def _annotate_request(span, md: dict, slo_class: str, budget, *, prompt_len=None,
                      max_new_tokens=None, stream: bool = False) -> None:
    """The handler root span's request attributes (class, session,
    prompt length, budget), as the JAX server records them."""
    span.set("slo_class", slo_class)
    if md.get(SESSION_HEADER):
        span.set("session", md[SESSION_HEADER])
    if prompt_len is not None:
        span.set("prompt_len", int(prompt_len))
    if max_new_tokens is not None:
        span.set("max_new_tokens", int(max_new_tokens))
    if budget is not None:
        span.set("budget_ms", int(budget * 1000))
    if stream:
        span.set("stream", True)


def make_generate_handler(run_submit, prompt_len: int, vocab_size: int,
                          max_new_tokens: int | None = None):
    """The ``Generate`` handler's body: a Matrix of token ids ``(N,
    prompt_len)`` -> a Matrix ``(N, prompt_len + max_new_tokens)``, with
    the Process RPC's wire format and status taxonomy.
    ``generate(request_bytes, metadata=None, time_remaining=None) ->
    (reply_bytes, trailing)``, raising :class:`RpcAbort`. ``run_submit(ids,
    budget, ctx, slo_class)`` serves the int32 prompts. Needs no
    grpcio."""

    def generate(request_bytes: bytes, metadata: dict | None = None,
                 time_remaining: float | None = None):
        _RPC_REQUESTS.labels(method="Generate").inc()
        md = metadata or {}
        span, budget = _request_span(md, time_remaining, "Generate")
        trailing = ((_trace.TRACE_ID_HEADER, span.ctx.trace_id),)
        slo_class = normalize_class(md.get(CLASS_HEADER))
        _annotate_request(span, md, slo_class, budget, prompt_len=prompt_len,
                          max_new_tokens=max_new_tokens)
        try:
            try:
                with _trace.TRACER.span("decode", span.ctx):
                    x = decode_matrix(request_bytes)
            except ValueError as e:
                span.annotate(f"abort INVALID_ARGUMENT: bad Matrix: {e}")
                _abort("Generate", "INVALID_ARGUMENT", f"bad Matrix: {e}", trailing)
            span.set("rows", len(x))
            # One static prompt length per endpoint; clients pad to it.
            ids = _check_prompts(
                x, x.ndim == 2 and x.shape[1] == prompt_len,
                f"expected prompts of shape (N, {prompt_len}), got {tuple(x.shape)}",
                vocab_size, "Generate", span, trailing)
            try:
                out = run_submit(ids.astype(np.int32), budget, span.ctx, slo_class)
            except Exception as e:  # noqa: BLE001 — mapped to status codes
                span.annotate(f"error: {type(e).__name__}: {e}")
                _abort_for_exception(e, "generation", "Generate", trailing)
            with _trace.TRACER.span("encode", span.ctx):
                return encode_matrix(out), trailing
        finally:
            span.end()

    return generate


# The gRPC status code names a stream's END frame may carry.
_STATUS_NAMES = frozenset((
    "CANCELLED", "UNKNOWN", "INVALID_ARGUMENT", "DEADLINE_EXCEEDED", "NOT_FOUND",
    "ALREADY_EXISTS", "PERMISSION_DENIED", "RESOURCE_EXHAUSTED", "FAILED_PRECONDITION",
    "ABORTED", "OUT_OF_RANGE", "UNIMPLEMENTED", "INTERNAL", "UNAVAILABLE", "DATA_LOSS",
    "UNAUTHENTICATED",
))


def _status_from_code(name: str) -> str:
    """A stream terminal's error code name -> the gRPC status name it
    ends with: the framework's ``INTEGRITY`` is ``DATA_LOSS`` on the
    wire (as :func:`_abort_for_exception` maps it), an unknown name
    ``INTERNAL``."""
    if name == "INTEGRITY":
        return "DATA_LOSS"
    return name if name in _STATUS_NAMES else "INTERNAL"


def make_generate_stream_handler(run_submit_stream, prompt_len: int, vocab_size: int,
                                 max_new_tokens: int | None = None):
    """The ``GenerateStream`` handler's body: ONE prompt row in, wire
    frames out — TOKENS deltas as the continuous scheduler publishes
    them, then exactly one END frame naming the terminal (eos /
    max_tokens). ``generate_stream(request_bytes, metadata=None,
    time_remaining=None, send_initial=None, on_cancel=None)`` is a
    generator of frame bytes that raises :class:`RpcAbort`;
    ``send_initial(pairs)`` sends initial metadata (the server's trace
    id, so a stream wedged mid-flight can be traced before it ends) and
    ``on_cancel(fn)`` registers the client-gone callback (it frees the
    decode slot). A ``x-tdn-stream-resume`` header of already-delivered
    token ids rides the scheduler's replay path; more than
    ``STREAM_RESUME_MAX_TOKENS`` of them is ``OUT_OF_RANGE``.
    ``run_submit_stream(ids, budget, ctx, slo_class, resume)`` returns
    the :class:`~tpu_dist_nn_torch.serving.stream.TokenStream`. Needs no
    grpcio."""
    method = "GenerateStream"

    def generate_stream(request_bytes: bytes, metadata: dict | None = None,
                        time_remaining: float | None = None, send_initial=None,
                        on_cancel=None):
        _RPC_REQUESTS.labels(method=method).inc()
        md = metadata or {}
        span, budget = _request_span(md, time_remaining, method)
        trailing = ((_trace.TRACE_ID_HEADER, span.ctx.trace_id),)
        slo_class = normalize_class(md.get(CLASS_HEADER))
        _annotate_request(span, md, slo_class, budget, prompt_len=prompt_len,
                          max_new_tokens=max_new_tokens, stream=True)
        stream = None
        try:
            try:
                with _trace.TRACER.span("decode", span.ctx):
                    x = decode_matrix(request_bytes)
            except ValueError as e:
                span.annotate(f"abort INVALID_ARGUMENT: bad Matrix: {e}")
                _abort(method, "INVALID_ARGUMENT", f"bad Matrix: {e}", trailing)
            # One stream = one sequence; a client streams N prompts over
            # N concurrent RPCs.
            _check_prompts(
                x, x.ndim == 2 and x.shape == (1, prompt_len),
                f"GenerateStream takes ONE prompt of shape (1, {prompt_len}), "
                f"got {tuple(x.shape)}", vocab_size, method, span, trailing)
            resume = None
            raw = md.get(STREAM_RESUME_HEADER)
            if raw:
                try:
                    resume = [int(t) for t in raw.split(",")]
                except ValueError:
                    span.annotate("abort INVALID_ARGUMENT: resume header")
                    _abort(method, "INVALID_ARGUMENT",
                           f"bad {STREAM_RESUME_HEADER}: expected comma-separated token ids",
                           trailing)
                if len(resume) > STREAM_RESUME_MAX_TOKENS:
                    # Bit-exact resume needs EVERY delivered token; a
                    # clamped suffix would replay against K/V state this
                    # replica does not have.
                    span.annotate("abort OUT_OF_RANGE: resume too long")
                    _abort(method, "OUT_OF_RANGE",
                           f"{STREAM_RESUME_HEADER} carries {len(resume)} tokens; the "
                           f"metadata-borne resume path is bounded at "
                           f"{STREAM_RESUME_MAX_TOKENS}", trailing)
            if send_initial is not None:
                send_initial(trailing)
            try:
                stream = run_submit_stream(x.astype(np.int32), budget, span.ctx, slo_class,
                                           resume)
            except Exception as e:  # noqa: BLE001 — mapped to status codes
                span.annotate(f"error: {type(e).__name__}: {e}")
                _abort_for_exception(e, "stream admission", method, trailing)
            if resume:
                note_stream_resumed()
                span.set("resume_tokens", len(resume))
            if on_cancel is not None:
                on_cancel(stream.cancel)
            ntok = 0
            while True:
                # The budget bounds each next-token gap (admission +
                # prefill before the first frame, decode cadence after),
                # not the stream's whole duration.
                ev = stream.next_event(budget)
                if ev is None:
                    stream.cancel()
                    span.annotate("abort DEADLINE_EXCEEDED: token gap")
                    _abort(method, "DEADLINE_EXCEEDED",
                           f"no token within the {budget:.3f}s stream gap budget", trailing)
                kind, data = ev
                if kind == "tokens":
                    ntok += len(data)
                    yield encode_token_frame(data)
                    continue
                if data["reason"] == "error":
                    span.annotate(f"stream error {data['code']}: {data['message']}")
                    _abort(method, _status_from_code(data["code"]),
                           data["message"] or "stream failed", trailing)
                span.set("tokens", ntok)
                yield encode_end_frame(data["reason"], data["code"], data["message"])
                return
        finally:
            if stream is not None:
                stream.cancel()  # a no-op after a clean terminal
            span.end()

    return generate_stream


def _grpc_stream_service(grpc, generate_stream):
    """The socket adapter of the stream body: initial metadata and the
    cancel callback through the context, ``RpcAbort`` to a status."""

    def handler(request_bytes: bytes, context):
        md = dict(context.invocation_metadata() or ())
        frames = generate_stream(request_bytes, md, context.time_remaining(),
                                 send_initial=context.send_initial_metadata,
                                 on_cancel=context.add_callback)
        try:
            yield from frames
        except RpcAbort as e:
            context.set_trailing_metadata(e.trailing)
            context.abort(grpc.StatusCode[e.code], e.message)

    rpc = grpc.unary_stream_rpc_method_handler(
        handler, request_deserializer=bytes, response_serializer=bytes)
    return grpc.method_handlers_generic_handler(SERVICE_NAME, {"GenerateStream": rpc})


def serve_lm_generate(params, cfg, port: int, *, max_new_tokens: int, prompt_len: int,
                      num_stages: int = 1, num_groups: int | None = None,
                      temperature: float = 0.0, top_k: int | None = None,
                      top_p: float | None = None, seed: int = 0, host: str = "0.0.0.0",
                      max_workers: int = 10, coalesce: bool = True, warm_rows: int = 0,
                      submit_timeout: float | None = 120.0, pipeline_depth: int = 2,
                      max_pending_rows: int | None = None, scheduler: str = "auto",
                      gen_slots: int = 8, eos_id: int | None = None,
                      prefix_cache_blocks: int = 0, prefill_chunk: int | None = None,
                      class_watermarks: dict | None = None, device=None):
    """Serve LM GENERATION over the reference wire (``Generate``, and
    ``GenerateStream`` on the continuous scheduler). Needs grpcio.

    ``scheduler`` picks the decode scheduling policy:

    * ``"continuous"`` — iteration-level continuous batching
      (:class:`~tpu_dist_nn_torch.serving.continuous.ContinuousScheduler`):
      ``gen_slots`` KV-cache slots, requests admitted at decode-STEP
      granularity and retired early on ``eos_id`` or their budget, with
      ``prefix_cache_blocks`` / ``prefill_chunk`` and preemption. One
      device.
    * ``"static"`` — the run-to-completion coalescing :class:`Batcher`
      in front of :func:`~tpu_dist_nn_torch.models.generate.generate`
      (the A/B control arm). It has no step-granular tokens to stream:
      ``GenerateStream`` stays unregistered (UNIMPLEMENTED).
    * ``"auto"`` (default) — continuous when ``coalesce`` is on, else
      static (``coalesce=False`` is the lock-serialized legacy arm,
      ``server.batcher is None``).

    ``num_stages > 1`` serves the static arm through the pipelined
    overlapped decoder
    (:func:`~tpu_dist_nn_torch.parallel.pp_generate.make_pipeline_generate_overlapped`):
    the blocks over ``num_stages`` stage slots of the serving device,
    ``num_groups`` (default ``max(num_stages, 2)``) request groups into
    which a launch's rows coalesce; no continuous scheduler and no
    ``eos_id`` there, as in the JAX server. One endpoint = one decode
    configuration (prompt length, budget, sampling knobs), validated
    whole at construction with the JAX package's texts. ``eos_id``
    gives both schedulers the same freeze/pad rule, so their greedy
    outputs are identical. ``device``: where generation runs (None =
    the card). Returns ``(server, bound_port)``; ``server.batcher``
    exposes the scheduling counters and ``server.scheduler`` names the
    continuous scheduler (None on the static path). ``warm_rows > 0``
    runs the continuous kernels once (:meth:`ContinuousScheduler.warm`),
    or the static bucket ladder, before the port opens.
    """
    import torch

    from tpu_dist_nn_torch.models.generate import generate, validate_generate_args
    from tpu_dist_nn_torch.models.transformer import tree_map
    from tpu_dist_nn_torch.obs.goodput import GOODPUT, LMFlopModel
    from tpu_dist_nn_torch.utils.device import resolve_device

    if scheduler not in ("auto", "static", "continuous"):
        raise ValueError(
            f"scheduler must be 'auto', 'static' or 'continuous', got {scheduler!r}"
        )
    if scheduler == "continuous" and num_stages > 1:
        raise ValueError(
            "scheduler='continuous' is single-chip (its slot cache "
            "lives on one device); the pipelined placement's overlapped "
            "round-robin decoder already schedules groups — use "
            "scheduler='static' (or 'auto') with num_stages > 1"
        )
    if scheduler == "continuous" and not coalesce:
        raise ValueError(
            "coalesce=False is the lock-serialized legacy arm of the "
            "STATIC scheduler; the continuous scheduler owns the device "
            "by construction — drop coalesce=False or use "
            "scheduler='static'"
        )
    if scheduler == "auto":
        scheduler = "static" if num_stages > 1 or not coalesce else "continuous"
    if scheduler != "continuous" and (prefix_cache_blocks or prefill_chunk is not None):
        raise ValueError(
            "prefix_cache_blocks / prefill_chunk are continuous-"
            "scheduler features (the static run-to-completion decode "
            "has no slot cache to reuse or chunk into); drop them or "
            "serve scheduler='continuous'"
        )
    dev = resolve_device(device)
    N, T = int(max_new_tokens), int(prompt_len)
    generator = torch.Generator(device=dev).manual_seed(int(seed))
    # The WHOLE decode contract, once, at construction: a bad
    # combination fails here, not as a per-RPC INTERNAL.
    validate_generate_args(cfg, T, N, temperature, top_k, top_p,
                           generator if temperature > 0 else None, eos_id)
    if num_stages > 1:
        if eos_id is not None:
            raise ValueError(
                "eos_id is not supported by the pipelined overlapped "
                "decoder (its round-robin loop has no done-mask); "
                "serve num_stages == 1 for stop-token semantics"
            )
    grpc = _import_grpc()

    if scheduler == "continuous":
        from tpu_dist_nn_torch.serving.continuous import ContinuousScheduler

        sched = ContinuousScheduler(
            params, cfg, slots=gen_slots, prompt_len=T, max_new_tokens=N,
            temperature=temperature, top_k=top_k, top_p=top_p, eos_id=eos_id, seed=seed,
            submit_timeout=submit_timeout, max_pending_rows=max_pending_rows,
            prefix_cache_blocks=prefix_cache_blocks, prefill_chunk=prefill_chunk,
            class_watermarks=class_watermarks, device=dev,
        )
        if warm_rows > 0:
            sched.warm()

        def run_submit(ids, time_remaining, ctx=None, slo_class="standard"):
            return sched.submit(ids, timeout=time_remaining, ctx=ctx, slo_class=slo_class)

        def run_submit_stream(ids, time_remaining, ctx=None, slo_class="standard",
                              resume=None):
            return sched.submit_stream(ids, timeout=time_remaining, ctx=ctx,
                                       slo_class=slo_class, resume_tokens=resume)

        server = _new_grpc_server(grpc, max_workers)
        server.add_generic_rpc_handlers((
            _grpc_service(grpc, make_generate_handler(run_submit, T, cfg.vocab_size,
                                                      max_new_tokens=N), "Generate"),
            _grpc_stream_service(grpc, make_generate_stream_handler(
                run_submit_stream, T, cfg.vocab_size, max_new_tokens=N)),
        ))
        bound = _bind_or_close(server, host, port, sched)
        # The scheduler fulfils the batcher's counter and close
        # contract: stop-wrapping and GracefulDrain work unchanged.
        server.batcher = sched
        server.scheduler = sched
        _wrap_server_stop(server, sched)
        server.start()
        slog.info("server.start", method="Generate", scheduler="continuous", port=bound,
                  gen_slots=gen_slots, prompt_len=T, max_new_tokens=N, eos_id=eos_id,
                  prefix_cache_blocks=prefix_cache_blocks, prefill_chunk=prefill_chunk)
        return server, bound

    params_served = tree_map(lambda a: a.detach().to(dev), params)
    n_devices = 1
    if num_stages > 1:
        from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
        from tpu_dist_nn_torch.parallel.pp_generate import make_pipeline_generate_overlapped
        from tpu_dist_nn_torch.parallel.transformer_pipeline import shard_blocks

        S = int(num_stages)
        G = int(num_groups) if num_groups is not None else max(S, 2)
        # The stage slots: every stage on the serving device (one card's
        # streams), as the pipelined trainer places them on one card.
        mesh = build_mesh(MeshSpec(stage=S), [dev] * S)
        n_devices = len(mesh.devices)
        params_served = dict(params_served, blocks=shard_blocks(params_served["blocks"], S))
        fn = make_pipeline_generate_overlapped(mesh, cfg, S, N, G, temperature=temperature,
                                               top_k=top_k, top_p=top_p)

        def run(rows: np.ndarray):
            n = len(rows)
            bg = -(-n // G)  # ceil: the batcher's bucket already padded
            grid = bg * G
            if grid != n:
                rows = np.concatenate([rows, np.zeros((grid - n, T), rows.dtype)])
            prompts = torch.as_tensor(np.asarray(rows), device=dev).long().reshape(G, -1, T)
            out = fn(params_served, prompts, generator if temperature > 0 else None)
            # A device tensor: the drain stage pays the one host sync.
            return out.reshape(-1, T + N)[:n]
    else:
        def run(rows: np.ndarray):
            prompts = torch.as_tensor(np.asarray(rows), device=dev).long()
            out = generate(params_served, cfg, prompts, N, temperature=temperature, top_k=top_k,
                           top_p=top_p, generator=generator if temperature > 0 else None,
                           eos_id=eos_id)
            # A device tensor: the batcher's drain stage pays the one host
            # sync, so dispatch can launch the next batch meanwhile.
            return torch.cat([prompts, out], dim=1)

    # Goodput for the run-to-completion decode: one record a coalesced
    # launch, at drain (EOS-frozen positions exist only in the fetched
    # sequences). The coalesce=False lock path stays unaccounted.
    gp_model = LMFlopModel.from_config(cfg, T + N - 1 if N > 1 else T)
    # The peak counts the distinct devices decoded on: the pipelined
    # placement's stage slots share the serving device.
    GOODPUT.ensure_peak(device_count=n_devices, dtype=cfg.compute_dtype)

    def account(out, useful_rows, launched_rows, dead_rows=0):
        GOODPUT.record_static_generate(gp_model, out, useful_rows, launched_rows, T, eos_id,
                                       dead_rows=dead_rows)

    batcher = (
        Batcher(None, submit_timeout, pipeline_depth, max_pending_rows, class_watermarks,
                run_fn=run, method="Generate", account_fn=account)
        if coalesce else None
    )
    lock = threading.Lock()

    def run_submit(ids, time_remaining, ctx=None, slo_class="standard"):
        if batcher is not None:
            return batcher.submit(ids, timeout=time_remaining, ctx=ctx, slo_class=slo_class)
        with lock:
            return _to_host(run(ids))

    if warm_rows > 0:
        n = 1
        while n <= warm_rows:
            _to_host(run(np.zeros((n, T), np.int32)))
            n *= 2
    server = _new_grpc_server(grpc, max_workers)
    server.add_generic_rpc_handlers((
        _grpc_service(grpc, make_generate_handler(run_submit, T, cfg.vocab_size,
                                                  max_new_tokens=N), "Generate"),
    ))
    bound = _bind_or_close(server, host, port, batcher)
    server.batcher = batcher
    server.scheduler = None
    _wrap_server_stop(server, batcher)
    server.start()
    slog.info("server.start", method="Generate", scheduler="static", port=bound,
              num_stages=num_stages, prompt_len=T, max_new_tokens=N, coalesce=coalesce)
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
        self._call_generate = self._channel.unary_unary(
            GENERATE_METHOD, request_serializer=bytes, response_deserializer=bytes)
        self._call_generate_stream = self._channel.unary_stream(
            GENERATE_STREAM_METHOD, request_serializer=bytes, response_deserializer=bytes)

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

    def _traced_call(self, call, method: str, payload: bytes, session_key=_CLIENT_DEFAULT,
                     slo_class=_CLIENT_DEFAULT) -> bytes:
        """One LOGICAL call of ``method`` (original attempt + bounded
        retries) under one client span; a final failure names the
        server-side trace (``e.server_trace_id``)."""
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
                    reply = call(payload, timeout=remaining, metadata=metadata)
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
        reply = self._traced_call(self._call, "Process", encode_matrix(x),
                                  session_key=session_key, slo_class=slo_class)
        return decode_matrix(reply)

    def generate(self, prompts, session_key=_CLIENT_DEFAULT,
                 slo_class=_CLIENT_DEFAULT) -> np.ndarray:
        """Token-id prompts ``(N, prompt_len)`` -> full sequences ``(N,
        prompt_len + max_new_tokens)`` int64 (ids ride the Matrix wire as
        exact doubles), with the Process call's retries and breaker."""
        reply = self._traced_call(self._call_generate, "Generate", encode_matrix(prompts),
                                  session_key=session_key, slo_class=slo_class)
        return decode_matrix(reply, dtype=np.int64)

    def generate_stream(self, prompt, *, session_key=_CLIENT_DEFAULT,
                        slo_class=_CLIENT_DEFAULT, timeout: float | None = None,
                        gap_timeout: float | None = None,
                        resume_tokens=None) -> "StreamReply":
        """Stream ONE prompt's tokens as the server produces them.

        ``prompt`` is one sequence of token ids, ``(prompt_len,)`` or
        ``(1, prompt_len)``. Iterate the returned :class:`StreamReply`
        for token ids at decode-step granularity. ``timeout`` bounds the
        WHOLE stream (gRPC deadline; None = unbounded); ``gap_timeout``
        is the stream-aware budget: the server bounds the wait for the
        first token and then every next-token gap by it.
        ``resume_tokens``: ids already received (the resume header); the
        server replays them and streams only what follows. A stream is
        not retried: tokens already delivered make it non-idempotent."""
        x = np.asarray(prompt)
        if x.ndim == 1:
            x = x[None, :]
        session = self.session_key if session_key is _CLIENT_DEFAULT else session_key
        cls = self.slo_class if slo_class is _CLIENT_DEFAULT else slo_class
        span = _trace.TRACER.start("client.GenerateStream")
        metadata = ((_trace.TRACE_HEADER, span.ctx.header()),)
        if session is not None:
            metadata += ((SESSION_HEADER, session),)
        if cls is not None:
            metadata += ((CLASS_HEADER, cls),)
        if gap_timeout is not None:
            metadata += ((_trace.TIMEOUT_HEADER, str(max(0, int(gap_timeout * 1000)))),)
        if resume_tokens:
            metadata += ((STREAM_RESUME_HEADER, ",".join(str(int(t)) for t in resume_tokens)),)
        call = self._call_generate_stream(encode_matrix(x), timeout=timeout, metadata=metadata)
        return StreamReply(call, span, self._grpc)

    def close(self) -> None:
        self._channel.close()


class StreamReply:
    """One streamed generation (:meth:`GrpcClient.generate_stream`).

    Iterate to receive token ids as the server publishes them; when
    iteration ends normally, ``finish`` holds the terminal frame
    (``{"reason": "eos" | "max_tokens", ...}``). ``trace_id`` carries the
    server's trace id from INITIAL metadata, available as soon as the
    stream opens. ``cancel()`` tears the RPC down; the server frees the
    decode slot on its next scheduler iteration. A broken stream raises
    ``grpc.RpcError`` (with ``server_trace_id``) from the iterator."""

    def __init__(self, call, span, grpc):
        self._call = call
        self._span = span
        self._grpc = grpc
        self._ended = False
        self.finish: dict | None = None
        self.trace_id: str | None = None

    def cancel(self) -> None:
        self._call.cancel()

    def _end_span(self) -> None:
        if not self._ended:
            self._ended = True
            self._span.end()

    def __iter__(self):
        try:
            try:
                for k, v in self._call.initial_metadata() or ():
                    if k == _trace.TRACE_ID_HEADER:
                        self.trace_id = v
            except Exception:  # noqa: BLE001 — metadata is best-effort
                pass
            for frame in self._call:
                kind, data = decode_frame(frame)
                if kind == "tokens":
                    yield from data
                else:
                    self.finish = data
                    self._span.annotate(f"end: {data['reason']}")
                    return
            # Closed OK without an END frame: a server that died between
            # its last TOKENS flush and the terminal.
            raise self._grpc.RpcError("stream closed without a terminal END frame")
        except self._grpc.RpcError as e:
            code, trace_id = GrpcClient._enrich(e, self._span)
            if trace_id is not None:
                self.trace_id = trace_id
            self._span.annotate(f"stream failed {code}: server trace {trace_id}")
            raise
        finally:
            self._end_span()
