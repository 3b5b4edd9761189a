"""Request-scoped tracing: span recorder.

Port of :mod:`tpu_dist_nn.obs.trace` (Dapper-style span trees, Sigelman
et al., 2010). The trace context crosses the gRPC hop in the
``x-tdn-trace`` metadata header, in the JAX package's format, so a
client of either package joins a server of the other into one trace.
The serving pipeline records one span per stage of a request (the
handler's ``rpc.Process`` root, ``decode``, ``queue_wait``, ``stage``,
``launch``, ``fetch``, ``encode``); :meth:`Tracer.snapshot` returns
them, and ``chip_smoke.py`` takes each stage's median from it.

* **Stdlib-only.** A span is a small ``__slots__`` object; recording
  one is an id draw and a list append under a lock.
* **Head sampling.** The root of a trace decides once
  (``sample_rate``) and the decision rides the wire. Rate 0 records
  nothing.
* **Bounded memory.** Completed spans live in a ring buffer
  (``capacity``); eviction ticks ``dropped_total``.
* **Cross-thread spans.** The pipeline starts a request on one thread
  and finishes its stages on others, so :meth:`Tracer.record_span`
  records an already-measured span.
"""

from __future__ import annotations

import os
import random
import threading
import time
import uuid

# Wire header carrying the trace context across the gRPC hop
# (lowercase: gRPC metadata keys must be). Value format:
# "<32-hex trace_id>-<16-hex span_id>-<2-digit flags>", flags 01 =
# sampled (a W3C-traceparent-shaped triple without the version field).
TRACE_HEADER = "x-tdn-trace"
# Server -> client trailing metadata naming the server-side trace, so
# a client-side failure can name the server's trace.
TRACE_ID_HEADER = "x-tdn-trace-id"
# Client -> server remaining-budget hint in milliseconds (the
# grpc-timeout analogue a proxy cannot strip silently): the batcher
# bounds its wait by min(grpc deadline, this hint).
TIMEOUT_HEADER = "x-tdn-timeout-ms"

def _new_trace_id() -> str:
    return uuid.uuid4().hex  # 32 hex chars


def _new_span_id() -> str:
    return os.urandom(8).hex()  # 16 hex chars


_HEX_DIGITS = frozenset("0123456789abcdefABCDEF")


def _is_hex(s: str) -> bool:
    # Strict bare-hex: int(s, 16) would tolerate '0x' prefixes,
    # underscores, and signs — ids must be canonical hex or rejected.
    return bool(s) and all(c in _HEX_DIGITS for c in s)


class SpanContext:
    """The propagatable identity of a span: what crosses the wire."""

    __slots__ = ("trace_id", "span_id", "sampled", "remote")

    def __init__(self, trace_id: str, span_id: str, sampled: bool,
                 remote: bool = False):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled
        self.remote = remote

    def header(self) -> str:
        return f"{self.trace_id}-{self.span_id}-" \
               f"{'01' if self.sampled else '00'}"

    @classmethod
    def from_header(cls, value: str | None) -> "SpanContext | None":
        """Parse an ``x-tdn-trace`` value; None on anything malformed
        (a bad header must degrade to local sampling, never abort the
        RPC that carried it)."""
        if not value:
            return None
        parts = value.strip().split("-")
        if len(parts) != 3:
            return None
        tid, sid, flags = parts
        if len(tid) != 32 or len(sid) != 16 or len(flags) != 2:
            return None
        if not (_is_hex(tid) and _is_hex(sid) and _is_hex(flags)):
            return None
        return cls(tid, sid, sampled=bool(int(flags, 16) & 1), remote=True)


class Span:
    """One recorded operation. Live spans are created by
    :meth:`Tracer.start` / :meth:`Tracer.span` and closed by ``end()``
    (or the ``with`` block); ``annotate()`` adds timestamped notes that
    export as instant events inside the span."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "parent_remote", "t0", "dur", "tid", "tname", "attrs",
                 "annotations", "_ended")

    def __init__(self, tracer, name, trace_id, span_id, parent_id,
                 parent_remote, t0, attrs=None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.parent_remote = parent_remote
        self.t0 = t0
        self.dur = None
        th = threading.current_thread()
        self.tid = th.ident or 0
        self.tname = th.name
        self.attrs = dict(attrs) if attrs else {}
        self.annotations: list[tuple[float, str]] = []
        self._ended = False

    @property
    def sampled(self) -> bool:
        return True

    @property
    def ctx(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, sampled=True)

    def annotate(self, text: str) -> None:
        self.annotations.append((time.monotonic(), text))

    def set(self, key: str, value) -> None:
        self.attrs[key] = value

    def end(self) -> None:
        if self._ended:  # idempotent: finally blocks + with blocks mix
            return
        self._ended = True
        self.dur = time.monotonic() - self.t0
        self._tracer._finish(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class _NoopSpan:
    """The unsampled span: carries real ids (so the not-sampled
    decision propagates coherently downstream and trailing metadata can
    still name the trace) but records nothing."""

    __slots__ = ("ctx",)

    def __init__(self, ctx: SpanContext):
        self.ctx = ctx

    @property
    def sampled(self) -> bool:
        return False

    def annotate(self, text: str) -> None:
        pass

    def set(self, key: str, value) -> None:
        pass

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


# Ambient span/sink for annotation attachment (utils like the engine
# annotate "whatever request is active on this thread" without
# threading a context through every signature). threading.local, not
# contextvars: the serving pipeline is plain threads.
_ACTIVE = threading.local()


def annotate(text: str) -> None:
    """Attach a timestamped note to the thread's active span (or
    collection sink); silently a no-op when tracing is off."""
    span = getattr(_ACTIVE, "span", None)
    if span is not None:
        span.annotate(text)
        return
    sink = getattr(_ACTIVE, "sink", None)
    if sink is not None:
        sink.append((time.monotonic(), text))


class _Activation:
    """``with tracer.activate(span):`` — the thread's ambient span for
    the duration (annotations from called code attach to it)."""

    __slots__ = ("_span", "_prev")

    def __init__(self, span):
        self._span = span

    def __enter__(self):
        self._prev = getattr(_ACTIVE, "span", None)
        _ACTIVE.span = self._span if getattr(
            self._span, "sampled", False
        ) else None
        return self._span

    def __exit__(self, *exc):
        _ACTIVE.span = self._prev


class _AnnotationSink:
    """``with annotation_sink() as notes:`` — collect annotations from
    called code into a plain list, for retroactive spans that do not
    exist yet while the work runs (the batcher's per-batch launch,
    recorded per-request afterwards)."""

    __slots__ = ("_notes", "_prev")

    def __enter__(self) -> list:
        self._notes: list[tuple[float, str]] = []
        self._prev = getattr(_ACTIVE, "sink", None)
        _ACTIVE.sink = self._notes
        return self._notes

    def __exit__(self, *exc):
        _ACTIVE.sink = self._prev


def annotation_sink() -> _AnnotationSink:
    return _AnnotationSink()


class Tracer:
    """Span recorder: head sampling and a bounded ring buffer."""

    def __init__(self, capacity: int = 4096, sample_rate: float = 1.0):
        self.configure(sample_rate=sample_rate)
        self._capacity = int(capacity)
        self._lock = threading.Lock()
        # ring: index _head is the oldest entry
        self._buf: list[Span] = []  # guarded-by: _lock
        self._head = 0  # guarded-by: _lock
        self.dropped_total = 0  # guarded-by: _lock

    def configure(self, sample_rate: float) -> None:
        rate = float(sample_rate)
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"sample_rate must be in [0, 1], got {rate}")
        self.sample_rate = rate

    def reset(self) -> None:
        """Drop recorded spans; configuration survives."""
        with self._lock:
            self._buf = []
            self._head = 0
            self.dropped_total = 0

    def start(self, name: str, parent: SpanContext | None = None,
              attrs=None) -> "Span | _NoopSpan":
        """Begin a span. No ``parent``: a new trace whose sampling this
        tracer decides (head sampling). With a ``parent`` (local or
        parsed off the wire): the parent's trace id AND sampling
        decision are inherited, except that rate 0 records nothing
        whatever the caller asked (ids still propagate)."""
        if parent is None:
            sampled = self.sample_rate > 0.0 and \
                random.random() < self.sample_rate
            trace_id = _new_trace_id()
            parent_id = None
            parent_remote = False
        else:
            sampled = parent.sampled and self.sample_rate > 0.0
            trace_id = parent.trace_id
            parent_id = parent.span_id
            parent_remote = parent.remote
        span_id = _new_span_id()
        if not sampled:
            return _NoopSpan(SpanContext(trace_id, span_id, sampled=False))
        return Span(self, name, trace_id, span_id, parent_id, parent_remote,
                    time.monotonic(), attrs)

    def span(self, name: str, parent: SpanContext, attrs=None):
        """Child-span shorthand for ``with`` blocks."""
        return self.start(name, parent=parent, attrs=attrs)

    def activate(self, span) -> _Activation:
        return _Activation(span)

    def record_span(self, name: str, parent: SpanContext | None,
                    t0: float, dur: float, attrs=None,
                    annotations=None) -> Span | None:
        """Record an already-measured span retroactively — the
        cross-thread form (start time observed on one thread, completion
        on another). ``t0``/``dur`` are ``time.monotonic()`` values."""
        if parent is None or not parent.sampled:
            return None
        sp = Span(self, name, parent.trace_id, _new_span_id(),
                  parent.span_id, parent.remote, t0, attrs)
        if annotations:
            sp.annotations.extend(annotations)
        sp._ended = True
        sp.dur = float(dur)
        self._finish(sp)
        return sp

    def _finish(self, span: Span) -> None:
        with self._lock:
            if len(self._buf) < self._capacity:
                self._buf.append(span)
            else:
                # Ring overwrite: the oldest span falls out.
                self._buf[self._head] = span
                self._head = (self._head + 1) % self._capacity
                self.dropped_total += 1

    def snapshot(self, trace_id: str | None = None) -> list[Span]:
        """Completed spans, oldest first (only ``trace_id``'s when
        given)."""
        with self._lock:
            spans = self._buf[self._head:] + self._buf[:self._head]
        if trace_id is not None:
            spans = [s for s in spans if s.trace_id == trace_id]
        return spans


# The process-wide tracer every instrumentation site of the port
# records into.
TRACER = Tracer()
