"""Request-scoped distributed tracing: span recorder + Chrome export.

Port of :mod:`tpu_dist_nn.obs.trace`, in the JAX package's wire and
export formats, so a client of either package joins a server of the
other into one trace. Metrics answer "how is the fleet doing" in
aggregate; they cannot answer "where did THIS slow request spend its time" — the exact
question the pipelined batcher raises (queue wait vs. staging vs.
launch vs. device vs. fetch). Following Dapper (Sigelman et al., 2010)
this module records per-request span trees, propagates the trace
context across the gRPC hop in an ``x-tdn-trace`` metadata header, and
exports completed spans in Chrome trace-event JSON — the format
Perfetto / ``chrome://tracing`` load directly, so request spans land
in the same timeline as ``torch.profiler`` device captures (whose
Chrome export ``/debug/profile`` serves).

Design constraints (same discipline as the registry):

* **Stdlib-only** — no numpy, no torch, no protobuf. A span is a tiny
  ``__slots__`` object; recording one is an id draw + a deque append.
* **Head sampling** — the root of a trace decides once
  (``sample_rate``); the decision rides the wire so every process in a
  chain keeps or drops the SAME requests. Rate 0 reduces every hot-path
  call to an id draw and a boolean check (the bench ``--overlap``
  no-regression bar).
* **Bounded memory** — completed spans live in a ring buffer
  (``capacity``); eviction ticks ``dropped_total``. A fixed set of
  *exemplar slots* always keeps the slowest locally-rooted traces seen
  so the worst-case evidence survives any amount of fast traffic.
* **Cross-thread spans** — the serving pipeline starts a span on one
  thread (submit) and finishes it on another (dispatch/drain), so the
  recorder accepts retroactive ``record_span(name, parent, t0, dur)``
  in addition to the ``with``-style live span.
"""

from __future__ import annotations

import json
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
# a client-side failure can name the exact trace to pull via /trace.
TRACE_ID_HEADER = "x-tdn-trace-id"
# Client -> server remaining-budget hint in milliseconds (the
# grpc-timeout analogue a proxy cannot strip silently): the batcher
# bounds its wait by min(grpc deadline, this hint).
TIMEOUT_HEADER = "x-tdn-timeout-ms"

# Anchor mapping time.monotonic() spans onto the epoch microsecond
# timeline Chrome trace events use: one offset captured at import, so
# every ts in an export shares a consistent (and monotonic) base.
_EPOCH_OFFSET = time.time() - time.monotonic()


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
                 "annotations", "_ended", "seq")

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
        # Completion sequence number, assigned by the tracer at finish
        # time: the /trace?since= cursor (0 = not yet finished).
        self.seq = 0

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


def active() -> bool:
    """True when an annotation would land somewhere — guard any
    f-string formatting behind this so rate-0 paths pay nothing."""
    return getattr(_ACTIVE, "span", None) is not None or \
        getattr(_ACTIVE, "sink", None) is not None


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


def _env_sample_rate() -> float:
    """TDN_TRACE_SAMPLE_RATE, parsed defensively: the process-wide
    TRACER is constructed at import time, so a garbled or out-of-range
    value must degrade to the default with a visible warning — it must
    NOT take down every ``tdn`` command with a float() traceback."""
    raw = os.environ.get("TDN_TRACE_SAMPLE_RATE")
    if raw is None:
        return 1.0
    try:
        rate = float(raw)
    except ValueError:
        rate = -1.0
    if not 0.0 <= rate <= 1.0:
        import logging

        logging.getLogger(__name__).warning(
            "TDN_TRACE_SAMPLE_RATE=%r is not a number in [0, 1]; "
            "tracing at the default rate 1.0", raw,
        )
        return 1.0
    return rate


class Tracer:
    """Span recorder: head sampling, bounded ring buffer, slowest-trace
    exemplar slots, Chrome trace-event export."""

    def __init__(self, capacity: int = 4096, sample_rate: float | None = None,
                 exemplar_slots: int = 4):
        if sample_rate is None:
            sample_rate = _env_sample_rate()
        self.configure(sample_rate=sample_rate)
        self._capacity = int(capacity)
        self._lock = threading.Lock()
        # ring: index _head is the oldest entry
        self._buf: list[Span] = []  # guarded-by: _lock
        self._head = 0  # guarded-by: _lock
        self._exemplar_slots = int(exemplar_slots)
        # [(dur, trace_id, [spans of the whole trace])] — the slowest
        # locally-rooted traces ever seen, immune to ring eviction; at
        # most one slot per trace id (a loopback client root and its
        # wire-joined handler must not burn two slots on one trace).
        self._exemplars: list[tuple[float, str, list[Span]]] = []  # guarded-by: _lock
        self.dropped_total = 0  # guarded-by: _lock
        # Monotonic completion counter: every finished span gets the
        # next value, and /trace?since=N returns only spans with
        # seq > N — an incremental poller re-downloads nothing. Never
        # reset (a cursor must stay monotonic for the process life).
        self.seq = 0

    # ------------------------------------------------------------ config

    def configure(self, sample_rate: float) -> None:
        rate = float(sample_rate)
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"sample_rate must be in [0, 1], got {rate}")
        self.sample_rate = rate

    def reset(self) -> None:
        """Drop recorded state (tests); configuration survives."""
        with self._lock:
            self._buf = []
            self._head = 0
            self._exemplars = []
            self.dropped_total = 0

    # ------------------------------------------------------------ record

    def start(self, name: str, parent: SpanContext | None = None,
              attrs=None) -> "Span | _NoopSpan":
        """Begin a span. No ``parent``: a new trace whose sampling this
        tracer decides (head sampling). With a ``parent`` (local or
        parsed off the wire): the parent's trace id AND sampling
        decision are inherited — one decision per trace, everywhere.

        Exception: rate 0 is this PROCESS's kill switch. A remote
        caller's sampled flag is a request, not a mandate — honoring it
        at rate 0 would let any stock client (whose own tracer defaults
        to 1.0) force recording onto a server that explicitly disabled
        it, handing clients control of server memory and lock traffic.
        Ids still propagate so the chain stays coherent downstream.
        """
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
        buf_copy = None
        with self._lock:
            self.seq += 1
            span.seq = self.seq
            if len(self._buf) < self._capacity:
                self._buf.append(span)
            else:
                # Ring overwrite: the oldest span falls out.
                self._buf[self._head] = span
                self._head = (self._head + 1) % self._capacity
                self.dropped_total += 1
            # A locally-rooted span completing is the moment the whole
            # trace is known (children end before their root): consider
            # it for an exemplar slot. Only the cheap qualification
            # check and a C-level list copy run under the lock — the
            # O(buffer) trace_id scan happens outside it, so other
            # threads' span completion never serializes behind it.
            if (
                (span.parent_id is None or span.parent_remote)
                and self._exemplar_slots > 0
                and self._qualifies_locked(span.dur or 0.0)
            ):
                buf_copy = list(self._buf)
        if buf_copy is not None:
            self._keep_exemplar(span, buf_copy)

    def _qualifies_locked(self, dur: float) -> bool:  # caller-holds: _lock
        return (
            len(self._exemplars) < self._exemplar_slots
            or dur > min(d for d, _, _ in self._exemplars)
        )

    def _keep_exemplar(self, root: Span, buf_copy: list[Span]) -> None:
        """Keep the slowest locally-rooted traces whole, outside the
        ring (lock NOT held during the scan). Re-checks qualification
        under the lock before inserting: a concurrent slower root may
        have taken the slot while we scanned. One slot per trace id —
        a same-process client root and its wire-joined handler span
        replace (never duplicate) each other's entry, keeping the
        slot's span list the outermost/fullest capture."""
        dur = root.dur or 0.0
        trace = [s for s in buf_copy if s.trace_id == root.trace_id]
        with self._lock:
            for i, (d, tid, _) in enumerate(self._exemplars):
                if tid == root.trace_id:
                    if dur > d:
                        self._exemplars[i] = (dur, tid, trace)
                        self._exemplars.sort(
                            key=lambda e: e[0], reverse=True
                        )
                    return
            if not self._qualifies_locked(dur):
                return
            self._exemplars.append((dur, root.trace_id, trace))
            self._exemplars.sort(key=lambda e: e[0], reverse=True)
            del self._exemplars[self._exemplar_slots:]

    # ------------------------------------------------------------ export

    def snapshot(self, limit: int | None = None,
                 trace_id: str | None = None,
                 since: int | None = None) -> list[Span]:
        """Completed spans, oldest first: the ring's last ``limit``
        spans (all when None) plus every exemplar-trace span not
        already present. ``trace_id`` keeps only that trace — the
        "pull one slow exemplar without dumping the whole ring" path
        (the filter applies AFTER the limit window, so an explicit id
        is never crowded out of an unlimited pull by later traffic).
        ``since`` keeps only spans that FINISHED after that cursor
        value (:attr:`seq`) — the incremental-poll form; exemplar
        extras obey it too, so a poller is never re-sent the same
        slow trace every tick."""
        with self._lock:
            spans = self._buf[self._head:] + self._buf[:self._head]
            if limit is not None and limit >= 0:
                spans = spans[-limit:] if limit else []
            seen = {id(s) for s in spans}
            extra = [
                s for _, _, tr in self._exemplars for s in tr
                if id(s) not in seen
            ]
        out = extra + spans
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        if since is not None:
            out = [s for s in out if s.seq > since]
        return out

    def buffer_len(self) -> int:
        with self._lock:
            return len(self._buf)

    def chrome_trace(self, limit: int | None = None,
                     trace_id: str | None = None,
                     since: int | None = None) -> dict:
        """The buffer as a Chrome trace-event JSON object —
        ``json.dump`` it and open in Perfetto / ``chrome://tracing``.
        Spans become complete (``ph: "X"``) events with epoch-anchored
        microsecond ``ts``, annotations become thread-scoped instant
        (``ph: "i"``) events, and thread names come along as metadata
        so the serving pipeline's stages are labelled tracks.
        ``trace_id`` exports just that trace (``/trace?trace_id=``);
        ``since`` exports only spans finished after that cursor. The
        document carries a top-level ``cursor`` (the newest completion
        sequence number) to pass back as the next ``since`` — an extra
        key Perfetto ignores."""
        # Cursor read BEFORE the snapshot: a span finishing in between
        # is then re-sent on the next poll (pollers dedupe by span_id)
        # rather than silently skipped forever.
        with self._lock:
            cursor = self.seq
        spans = self.snapshot(limit, trace_id=trace_id, since=since)
        events: list[dict] = []
        pid = os.getpid()
        threads: dict[int, str] = {}
        for s in spans:
            ts = (s.t0 + _EPOCH_OFFSET) * 1e6
            args = {"trace_id": s.trace_id, "span_id": s.span_id}
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            for k, v in s.attrs.items():
                args[str(k)] = v
            events.append({
                "ph": "X", "cat": "tdn", "name": s.name,
                "ts": ts, "dur": (s.dur or 0.0) * 1e6,
                "pid": pid, "tid": s.tid, "args": args,
            })
            threads.setdefault(s.tid, s.tname)
            for (at, text) in s.annotations:
                events.append({
                    "ph": "i", "cat": "tdn", "name": text, "s": "t",
                    "ts": (at + _EPOCH_OFFSET) * 1e6,
                    "pid": pid, "tid": s.tid,
                    "args": {"trace_id": s.trace_id, "span_id": s.span_id},
                })
        # Monotonic ts within (and across) tracks: sorted globally.
        events.sort(key=lambda e: e["ts"])
        meta = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": f"tdn[{pid}]"},
        }]
        for tid, tname in sorted(threads.items()):
            meta.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": tname},
            })
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "cursor": cursor}

    def render_json(self, limit: int | None = None,
                    trace_id: str | None = None,
                    since: int | None = None) -> str:
        return json.dumps(self.chrome_trace(limit, trace_id=trace_id,
                                            since=since))


# The process-wide tracer every built-in instrumentation site records
# into and the ``/trace`` route exports from (mirrors REGISTRY).
TRACER = Tracer()
