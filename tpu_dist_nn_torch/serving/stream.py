"""Per-request token streaming channel.

Port of :mod:`tpu_dist_nn.serving.stream`. The continuous scheduler
(:mod:`~tpu_dist_nn_torch.serving.continuous`) produces one token per
resident row per device step; :class:`TokenStream` carries those tokens
OUT at step granularity: a bounded, lock-protected channel between the
scheduler thread (producer) and the ``GenerateStream`` handler thread
(consumer).

Contract:

* **The producer never blocks.** The scheduler publishes from its
  decode loop; a slow consumer must not stall every other resident
  row. Past ``max_buffer`` undelivered tokens the stream flips to
  cancelled (backpressure by cancellation) and the scheduler frees the
  slot on its next iteration, as if the client had disconnected.
* **Publish is idempotent over the known-token list.** The scheduler
  hands the FULL ``occ["tokens"]`` list each time; the channel's
  ``sent`` cursor enqueues only the unseen suffix. That one cursor makes
  preemption and failover replay exactly-once: a re-bound row rebuilds
  its token list from scratch (forced-token replay) and republishes
  tokens the stream already delivered, which the cursor suppresses.
* **Exactly one terminal.** ``finish()`` is idempotent; the first call
  wins. Every scheduler exit path (retire, expiry, device fault, close
  sweep) reaches it through :class:`StreamDone`, the ``item["done"]``
  Event subclass that turns the item's terminal state into the END
  frame as a side effect of ``set()``.

The frames themselves (TOKENS / END) live in
:mod:`~tpu_dist_nn_torch.serving.wire` with every other byte format.
"""

from __future__ import annotations

import threading
import time

from tpu_dist_nn_torch.obs.registry import REGISTRY

_STREAM_REQUESTS = REGISTRY.counter(
    "tdn_gen_stream_requests_total",
    "GenerateStream requests admitted to the continuous scheduler",
)
_STREAM_FRAMES = REGISTRY.counter(
    "tdn_gen_stream_frames_total",
    "stream frames flushed to clients, by kind (tokens / end)",
    labels=("kind",),
)
_STREAM_CANCELLED = REGISTRY.counter(
    "tdn_gen_stream_cancelled_total",
    "streams cancelled before their terminal frame (client abandon, "
    "gRPC cancellation, or buffer-overflow backpressure)",
)
_STREAM_RESUMED = REGISTRY.counter(
    "tdn_gen_stream_resumed_total",
    "GenerateStream requests admitted WITH a resume prefix (router "
    "mid-stream failover replaying already-delivered tokens)",
)
# Observed at PUBLISH time (the scheduler's token cadence), so a slow
# consumer shows up in the buffer depth, not here.
_INTERTOKEN = REGISTRY.histogram(
    "tdn_gen_intertoken_seconds",
    "gap between consecutive published tokens of one stream (after "
    "the first token; TTFT owns submit -> first)",
)


class TokenStream:
    """Bounded single-producer / single-consumer token channel for one
    GenerateStream request."""

    def __init__(self, max_buffer: int = 4096):
        self._cond = threading.Condition()
        self._max = int(max_buffer)
        self._pending: list[int] = []  # guarded-by: _cond
        self._sent = 0  # guarded-by: _cond
        self._terminal: dict | None = None  # guarded-by: _cond
        self._cancelled = False  # guarded-by: _cond
        self._last_publish: float | None = None  # guarded-by: _cond
        _STREAM_REQUESTS.inc()

    # ---------------------------------------------------- producer side

    def seed(self, n: int) -> None:
        """Advance the sent cursor past ``n`` tokens the CLIENT already
        holds (failover resume): the scheduler republishes the whole
        replayed prefix and the cursor swallows it."""
        with self._cond:
            self._sent = max(self._sent, int(n))

    def publish(self, tokens) -> bool:
        """Enqueue the unseen suffix of the full known-token list. Never
        blocks. Returns False once the stream is cancelled (client gone
        or buffer overflowed): the scheduler's cue to free the slot."""
        with self._cond:
            if self._cancelled or self._terminal is not None:
                return not self._cancelled
            fresh = tokens[self._sent:]
            if not fresh:
                return True
            now = time.monotonic()
            if self._last_publish is not None:
                _INTERTOKEN.observe(now - self._last_publish)
            self._last_publish = now
            self._sent += len(fresh)
            self._pending.extend(int(t) for t in fresh)
            if len(self._pending) > self._max:
                # The consumer stopped draining: the producer must never
                # block the shared decode loop, so the stream dies.
                self._cancelled = True
                _STREAM_CANCELLED.inc()
                self._cond.notify_all()
                return False
            self._cond.notify_all()
            return True

    def finish(self, reason: str, code: str = "", message: str = "") -> None:
        """Idempotent terminal: "eos" / "max_tokens", or "error" with the
        canonical code name + message. The first call wins."""
        with self._cond:
            if self._terminal is not None:
                return
            self._terminal = {"reason": reason, "code": code, "message": message}
            self._cond.notify_all()

    # ---------------------------------------------------- consumer side

    def cancel(self) -> None:
        """Consumer-side teardown (client gone, handler exiting early):
        the next publish returns False and the scheduler reaps the
        slot."""
        with self._cond:
            if self._cancelled or self._terminal is not None:
                return
            self._cancelled = True
            _STREAM_CANCELLED.inc()
            self._cond.notify_all()

    @property
    def cancelled(self) -> bool:
        with self._cond:
            return self._cancelled

    @property
    def delivered(self) -> int:
        """Tokens handed to the consumer so far (the resume ledger)."""
        with self._cond:
            return self._sent - len(self._pending)

    def next_event(self, timeout: float | None = None):
        """Block for the next thing to flush: ``("tokens", [ids])`` (the
        whole buffered delta, one frame), ``("end", {...})`` after the
        buffer drains, or ``None`` on timeout (the handler's
        per-token-gap deadline)."""
        with self._cond:
            deadline = None if timeout is None else time.monotonic() + timeout
            while True:
                if self._pending:
                    batch = self._pending
                    self._pending = []
                    _STREAM_FRAMES.labels(kind="tokens").inc()
                    return "tokens", batch
                if self._terminal is not None:
                    _STREAM_FRAMES.labels(kind="end").inc()
                    return "end", dict(self._terminal)
                if self._cancelled:
                    return "end", {"reason": "error", "code": "CANCELLED",
                                   "message": "stream cancelled"}
                if deadline is None:
                    self._cond.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)


class StreamDone(threading.Event):
    """The ``item["done"]`` Event of a streaming request.

    Every terminal path of the scheduler and the admission core already
    calls ``item["done"].set()`` after stamping ``item["err"]`` /
    ``item["finish_reason"]``; this subclass turns that into the
    stream's END frame: ``set()`` reads the item's terminal state and
    finishes the channel."""

    def __init__(self, item: dict, stream: TokenStream):
        super().__init__()
        self._item = item
        self._stream = stream

    def set(self) -> None:  # noqa: A003 — threading.Event's name
        err = self._item.get("err")
        if err is not None:
            self._stream.finish("error", getattr(err, "code", "INTERNAL"), str(err))
        else:
            self._stream.finish(self._item.get("finish_reason") or "max_tokens")
        super().set()


def note_stream_resumed() -> None:
    """Tick the failover-resume counter (at admission, when a resume
    prefix rides in)."""
    _STREAM_RESUMED.inc()
