"""Structured JSON logging: trace-correlated, rate-limited, stdlib-only.

Port of :mod:`tpu_dist_nn.obs.log`: the same records, JSON lines and
ring. The serving path's operational events (server start, shed storms,
client retry exhaustion, decode-step faults, int8 regressions) were
free-form ``%``-formatted strings — grep-able by a human, opaque to a
log pipeline, and unbounded under a fault storm. This module is the
structured channel the serving/engine modules log through:

* **One event, many fields.** ``slog.info("server.start", port=5101,
  method="Process")`` — the event name is a stable key (dashboards and
  alerts match on it), the fields are data, not prose.
* **Trace correlation.** When the calling thread has an active sampled
  span (:func:`tpu_dist_nn_torch.obs.trace.annotate`'s ambient span), its
  ``trace_id``/``span_id`` are stamped onto the record automatically —
  a log line and the ``/trace`` span tree name each other.
* **Rate limiting.** A token bucket per ``(logger, event)``: a fault
  storm logs its first ``burst`` occurrences then ``rate`` per second,
  and the next emitted record carries ``suppressed=N`` so the gap is
  visible instead of silent. Events that fire once (startup) are never
  affected.
* **Bounded in-memory ring.** Every record that passes the limiter
  also lands in the process-wide :data:`LOG_RING` (default 4096
  records), so the recent log tail is queryable AFTER the fact —
  ``GET /logs?window=S&level=L`` on the metrics endpoint, and the
  flight recorder (:mod:`tpu_dist_nn_torch.obs.incident`) freezes it into
  every diagnostic bundle. stderr never leaves the box; the ring does.
* **Readable either way.** Through the default CLI handler a record
  renders ``event key=value ...``; with :func:`setup_json_logging`
  (``tdn --log-json`` / ``TDN_LOG_JSON=1``) the same record renders as
  one JSON object per line.

Stdlib-only (``json`` + ``logging`` + ``threading``), no handler is
installed implicitly: importing this module never changes process-wide
logging config.
"""

from __future__ import annotations

import json
import logging
import threading
import time

# Record attributes the structured path sets; JsonFormatter reads them.
_EVENT_ATTR = "tdn_event"
_FIELDS_ATTR = "tdn_fields"

# Keys the formatter owns; a field with one of these names is nested
# under "fields" instead of silently clobbering the envelope.
_RESERVED = frozenset(("ts", "level", "logger", "event", "exc"))


def current_trace_ids() -> tuple[str, str] | None:
    """(trace_id, span_id) of the calling thread's active sampled span,
    or None — the correlation hook (reads the tracer's ambient slot,
    never records anything)."""
    from tpu_dist_nn_torch.obs import trace as _trace

    span = getattr(_trace._ACTIVE, "span", None)
    if span is not None and getattr(span, "sampled", False):
        return span.trace_id, span.span_id
    return None


class JsonFormatter(logging.Formatter):
    """One JSON object per line. Structured records (emitted through
    :class:`StructuredLogger`) keep their event/fields; plain records
    from any other logger in the process degrade to ``{"event":
    <message>}`` so a mixed stream stays machine-parseable."""

    def format(self, record: logging.LogRecord) -> str:
        doc: dict = {
            "ts": round(record.created, 6),
            "level": record.levelname.lower(),
            "logger": record.name,
            "event": getattr(record, _EVENT_ATTR, None)
            or record.getMessage(),
        }
        fields = getattr(record, _FIELDS_ATTR, None)
        if fields:
            for k, v in fields.items():
                if k in _RESERVED:
                    doc.setdefault("fields", {})[k] = v
                else:
                    doc[k] = v
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc, default=repr)


class _TokenBucket:
    """Per-key token bucket; also counts what it suppressed so the
    next allowed record can report the gap."""

    __slots__ = ("_rate", "_burst", "_lock", "_state")

    def __init__(self, rate: float, burst: int):
        self._rate = float(rate)
        self._burst = float(burst)
        self._lock = threading.Lock()
        # key -> [tokens, last_refill, suppressed_since_last_emit]
        # guarded-by: _lock
        self._state: dict = {}

    def allow(self, key, now: float | None = None) -> tuple[bool, int]:
        """-> (allowed, suppressed_count_to_report)."""
        t = time.monotonic() if now is None else now
        with self._lock:
            st = self._state.get(key)
            if st is None:
                st = self._state[key] = [self._burst, t, 0]
            tokens, last, suppressed = st
            tokens = min(self._burst, tokens + (t - last) * self._rate)
            if tokens >= 1.0:
                st[0] = tokens - 1.0
                st[1] = t
                st[2] = 0
                return True, suppressed
            st[0] = tokens
            st[1] = t
            st[2] = suppressed + 1
            return False, 0


class LogRing:
    """Bounded ring of structured log records (plain dicts), the
    queryable tail behind ``GET /logs`` and the incident bundles.

    Appends sit BEHIND the rate limiter (a storm costs the ring its
    ``rate``-per-second trickle, not one append per suppressed call)
    and are one dict build + deque append under a lock — cheap enough
    for every emitted record. ``dropped_total`` counts ring evictions
    so "the window you wanted is gone" is visible, the tracer-ring
    convention."""

    __slots__ = ("_buf", "_lock", "capacity", "dropped_total")

    def __init__(self, capacity: int = 4096):
        import collections

        self.capacity = int(capacity)
        # guarded-by: _lock
        self._buf: "collections.deque" = collections.deque(
            maxlen=self.capacity
        )
        self._lock = threading.Lock()
        self.dropped_total = 0  # guarded-by: _lock

    def append(self, record: dict) -> None:
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped_total += 1
            self._buf.append(record)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def snapshot(self, window: float | None = None,
                 level: str | None = None,
                 limit: int | None = None) -> list[dict]:
        """Records oldest-first; ``window`` keeps the last S seconds,
        ``level`` is a MINIMUM severity name (``warning`` returns
        warnings and errors), ``limit`` keeps the newest N after the
        filters."""
        cutoff = None if window is None else time.time() - float(window)
        floor = None
        if level is not None:
            floor = logging.getLevelName(str(level).upper())
            if not isinstance(floor, int):
                raise ValueError(f"unknown log level {level!r}")
        with self._lock:
            records = list(self._buf)
        out = [
            r for r in records
            if (cutoff is None or r.get("ts", 0.0) >= cutoff)
            and (floor is None
                 or logging.getLevelName(
                     str(r.get("level", "info")).upper()
                 ) >= floor)
        ]
        if limit is not None and limit >= 0:
            out = out[-limit:] if limit else []
        return out

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped_total = 0


# The process-wide ring every StructuredLogger feeds (mirrors REGISTRY
# and TRACER: one per process, served by the metrics endpoint).
LOG_RING = LogRing()


class StructuredLogger:
    """Event-shaped logging facade over one stdlib logger.

    ``info/warning/error/debug(event, **fields)`` and
    ``exception(event, **fields)`` (which attaches the active
    exception). The plain-handler rendering is ``event key=value ...``;
    under :class:`JsonFormatter` the record is a JSON object.
    """

    def __init__(self, logger: logging.Logger, limiter: _TokenBucket):
        self._logger = logger
        self._limiter = limiter

    def _log(self, level: int, event: str, exc_info=False, /,
             **fields) -> None:
        # Positional-only parameters: a caller's field legitimately
        # named `level` or `event` must land in **fields, not collide.
        if not self._logger.isEnabledFor(level):
            return
        allowed, suppressed = self._limiter.allow((self._logger.name, event))
        if not allowed:
            return
        ids = current_trace_ids()
        if ids is not None:
            fields.setdefault("trace_id", ids[0])
            fields.setdefault("span_id", ids[1])
        if suppressed:
            fields["suppressed"] = suppressed
        LOG_RING.append({
            "ts": time.time(),
            "level": logging.getLevelName(level).lower(),
            "logger": self._logger.name,
            "event": event,
            "fields": dict(fields),
        })
        msg = event + "".join(
            f" {k}={self._render(v)}" for k, v in fields.items()
        )
        self._logger.log(
            level, msg, exc_info=exc_info,
            extra={_EVENT_ATTR: event, _FIELDS_ATTR: fields},
        )

    @staticmethod
    def _render(v) -> str:
        if isinstance(v, float):
            return f"{v:.6g}"
        s = str(v)
        return repr(s) if " " in s else s

    def debug(self, event: str, **fields) -> None:
        self._log(logging.DEBUG, event, **fields)

    def info(self, event: str, **fields) -> None:
        self._log(logging.INFO, event, **fields)

    def warning(self, event: str, **fields) -> None:
        self._log(logging.WARNING, event, **fields)

    def error(self, event: str, **fields) -> None:
        self._log(logging.ERROR, event, **fields)

    def exception(self, event: str, **fields) -> None:
        self._log(logging.ERROR, event, True, **fields)


def get_logger(name: str, *, rate: float = 1.0,
               burst: int = 10) -> StructuredLogger:
    """The structured logger for ``name`` (wraps
    ``logging.getLogger(name)``; level/handler config stays the stdlib
    logger's). ``rate``/``burst`` shape the per-event token bucket —
    the defaults allow 10 back-to-back occurrences of one event, then
    1/s, with the suppressed count surfacing on the next emission."""
    return StructuredLogger(logging.getLogger(name), _TokenBucket(rate, burst))


def setup_json_logging(level: int | None = None, stream=None) -> None:
    """Install :class:`JsonFormatter` on the root logger (replacing its
    handlers — the ``tdn --log-json`` switch). Every logger in the
    process then emits one JSON object per line, structured or not."""
    handler = logging.StreamHandler(stream)
    handler.setFormatter(JsonFormatter())
    root = logging.getLogger()
    root.handlers[:] = [handler]
    if level is not None:
        root.setLevel(level)
