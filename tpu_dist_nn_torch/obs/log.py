"""Structured logging: trace-correlated, rate-limited, stdlib-only.

Port of the event channel of :mod:`tpu_dist_nn.obs.log`:
``slog.info("server.start", port=5101, method="Process")`` logs the
event name as a stable key and the fields as data, renders as
``event key=value ...`` through the standard ``logging`` handlers,
stamps the calling thread's active sampled span
(:mod:`tpu_dist_nn_torch.obs.trace`) onto the record, and rate-limits
each ``(logger, event)`` with a token bucket (a fault storm logs its
first ``burst`` occurrences, then ``rate`` per second; the next emitted
record carries ``suppressed=N``). Importing this module changes no
logging configuration.
"""

from __future__ import annotations

import logging
import threading
import time


def current_trace_ids() -> tuple[str, str] | None:
    """(trace_id, span_id) of the calling thread's active sampled span,
    or None — the correlation hook (reads the tracer's ambient slot,
    never records anything)."""
    from tpu_dist_nn_torch.obs import trace as _trace

    span = getattr(_trace._ACTIVE, "span", None)
    if span is not None and getattr(span, "sampled", False):
        return span.trace_id, span.span_id
    return None


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


class StructuredLogger:
    """Event-shaped logging facade over one stdlib logger.

    ``info/warning/error/debug(event, **fields)`` and
    ``exception(event, **fields)`` (which attaches the active
    exception). The record renders as ``event key=value ...``; the event
    and the fields also ride the record as ``tdn_event`` / ``tdn_fields``.
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
        msg = event + "".join(
            f" {k}={self._render(v)}" for k, v in fields.items()
        )
        self._logger.log(
            level, msg, exc_info=exc_info,
            extra={"tdn_event": event, "tdn_fields": fields},
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
