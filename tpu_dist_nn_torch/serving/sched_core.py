"""Scheduling core: the admission / shed / close contract of the
serving batcher.

Port of :class:`tpu_dist_nn.serving.sched_core.SchedCore` and its class
table, with the continuous scheduler's row pop and the stream-aware
deadline slide (the burn-rate governor waits for the fleet planes):

* **SLO classes.** Every entry carries a class (``critical`` /
  ``standard`` / ``best_effort``, the ``x-tdn-class`` header end to
  end). The queue is class-priority FIFO: critical pops first,
  best_effort last, FIFO within a class.
* **Class-aware shedding.** Each class sheds at its own fraction of the
  ``max_pending_rows`` watermark (``class_watermarks``; default
  best_effort 0.5, standard and critical 1.0). An oversized request
  against an EMPTY queue is always admitted: the watermark bounds
  backlog, not request size.
* **Deadline-aware expiry.** An entry whose caller budget (gRPC deadline
  or ``x-tdn-timeout-ms`` hint) ran out while it queued is failed
  DEADLINE_EXCEEDED at pop instead of riding a launch.
* **Backoff hints.** Every shed carries ``retry_after_ms`` derived from
  the current drain rate; the server returns it as
  ``x-tdn-retry-after-ms`` trailing metadata and
  :class:`~tpu_dist_nn_torch.serving.resilience.RetryPolicy` honors it
  as its backoff floor.
* **Close sweep.** Entries still queued at close fail over UNAVAILABLE.
"""

from __future__ import annotations

import collections
import threading
import time

from tpu_dist_nn_torch.obs.log import get_logger
from tpu_dist_nn_torch.obs.registry import REGISTRY
from tpu_dist_nn_torch.utils.errors import (
    DeadlineExceededError,
    ResourceExhaustedError,
    UnavailableError,
)

slog = get_logger(__name__)

# The service classes, best first. Rank is the pop order (critical
# pops first).
SLO_CLASSES = ("critical", "standard", "best_effort")
CLASS_RANK = {cls: i for i, cls in enumerate(SLO_CLASSES)}

# Watermark fraction per class: a class sheds when admitting would push
# pending_rows past fraction * max_pending_rows. standard/critical at
# 1.0 keep a single watermark for them;
# best_effort sheds first at half the queue.
DEFAULT_CLASS_WATERMARKS = {
    "critical": 1.0,
    "standard": 1.0,
    "best_effort": 0.5,
}

# Bounds on the shed reply's backoff hint. With no drain observed in
# the window (a wedged device) the hint is the cap — the backlog is
# not moving, retrying sooner cannot help.
RETRY_AFTER_MIN_MS = 50
RETRY_AFTER_MAX_MS = 5000
_DRAIN_WINDOW_S = 10.0

# Scheduler metric families (the JAX package's names and labels).
SHED = REGISTRY.counter(
    "tdn_batcher_shed_total",
    "submits fast-failed RESOURCE_EXHAUSTED at the pending-rows "
    "watermark (admission control)",
    labels=("method",),
)
WAIT = REGISTRY.histogram(
    "tdn_batch_wait_seconds",
    "time a request spent in the batcher (submit to result)",
    labels=("method",),
)
CLASS_SHED = REGISTRY.counter(
    "tdn_sched_class_shed_total",
    "admission sheds per SLO class (best_effort absorbing the "
    "overload is the degradation ladder working; critical sheds page)",
    labels=("method", "slo_class"),
)
CLASS_WAIT = REGISTRY.histogram(
    "tdn_sched_class_wait_seconds",
    "request time in the scheduler (submit to result) per SLO class "
    "— the per-class latency family the mixed-class A/B gates",
    labels=("method", "slo_class"),
)
EXPIRED = REGISTRY.counter(
    "tdn_batcher_expired_total",
    "queued entries failed DEADLINE_EXCEEDED at stage/bind time "
    "because their caller budget was already exhausted (work the "
    "device never burned a launch on)",
    labels=("method", "slo_class"),
)


def normalize_class(value) -> str:
    """Map a wire value to a known class: missing/unknown -> standard
    (forward-compatible — a typo'd class must degrade to the default,
    not fail the RPC)."""
    if isinstance(value, str):
        v = value.strip().lower()
        if v in CLASS_RANK:
            return v
    return "standard"


def slide_stream_deadline(item: dict, gap: float | None) -> None:
    """Stream-aware deadline semantics.

    A unary entry's ``deadline`` bounds submit-to-RETIREMENT: the caller
    is blocked until the whole result exists. A STREAMING entry delivers
    incrementally, so the same absolute deadline would expire a healthy
    long generation mid-stream; what the client needs bounded is the
    NEXT-TOKEN gap. The scheduler calls this after every published
    token: the deadline slides forward by ``gap`` (the caller's budget),
    so expiry and the preemption victim picker only ever kill a stream
    that has STALLED for a full budget.

    Plain dict write, GIL-atomic: the scheduler loop is the only writer
    after admission, and readers tolerate either value.
    """
    if gap is not None:
        item["deadline"] = time.monotonic() + gap


def validate_class_watermarks(fractions: dict) -> dict:
    """Fail-fast validation for ``--class-watermarks``: known classes,
    fractions in [0, 1], returned as a full table over DEFAULTS."""
    table = dict(DEFAULT_CLASS_WATERMARKS)
    for cls, frac in (fractions or {}).items():
        if cls not in CLASS_RANK:
            raise ValueError(
                f"unknown SLO class {cls!r} (choose from "
                f"{', '.join(SLO_CLASSES)})"
            )
        f = float(frac)
        if not 0.0 <= f <= 1.0:
            raise ValueError(
                f"class watermark fraction for {cls} must be in "
                f"[0, 1], got {frac}"
            )
        table[cls] = f
    return table


class SchedCore:
    """The queue + admission + close contract for one scheduler.

    The scheduler's device loop holds ``self.cond`` around its pops; the
    ``caller-holds`` methods below
    document which side of the lock each operation runs on. Expired
    entries are finalized (err + done) under the lock — cheap flag
    flips — while their structured log evidence is deferred to
    :meth:`drain_deferred`, called by the loops OUTSIDE the lock (one
    stalled log consumer must never wedge admission).
    """

    def __init__(self, method: str, *,
                 max_pending_rows: int | None = None,
                 submit_timeout: float | None = 120.0,
                 class_watermarks: dict | None = None):
        self.method = method
        self._max_pending_rows = (
            int(max_pending_rows) if max_pending_rows is not None else None
        )
        self._submit_timeout = submit_timeout
        self._fractions = validate_class_watermarks(class_watermarks)
        self.cond = threading.Condition()
        # One FIFO per class, popped in rank order (critical first).
        self._queues: dict[str, collections.deque] = {
            cls: collections.deque() for cls in SLO_CLASSES
        }  # guarded-by: cond
        self.pending_rows = 0  # guarded-by: cond
        self.closed = False  # guarded-by: cond
        self.requests_total = 0  # guarded-by: cond
        self.shed_total = 0  # guarded-by: cond
        self.expired_total = 0  # guarded-by: cond
        # Drain-rate window for the shed replies' retry-after hint:
        # (monotonic, rows) completions over the last _DRAIN_WINDOW_S.
        self._drained: collections.deque = collections.deque()  # guarded-by: _drain_lock
        self._drain_lock = threading.Lock()
        # Deferred expiry log events: (slo_class, rows, waited_s).
        self._deferred: list[tuple] = []  # guarded-by: cond
        self._m_shed = SHED.labels(method=method)
        self._m_wait = WAIT.labels(method=method)
        self._m_class_shed = {
            cls: CLASS_SHED.labels(method=method, slo_class=cls)
            for cls in SLO_CLASSES
        }
        self._m_class_wait = {
            cls: CLASS_WAIT.labels(method=method, slo_class=cls)
            for cls in SLO_CLASSES
        }
        self._m_expired = {
            cls: EXPIRED.labels(method=method, slo_class=cls)
            for cls in SLO_CLASSES
        }

    # ------------------------------------------------------------ admit

    def effective_watermark(self, slo_class: str) -> float | None:
        """The class's shed threshold (None = unbounded)."""
        if self._max_pending_rows is None:
            return None
        return self._fractions[slo_class] * self._max_pending_rows

    def has_pending(self) -> bool:  # caller-holds: cond
        return any(self._queues[cls] for cls in SLO_CLASSES)

    def pending_items(self) -> list:
        """Flattened queue snapshot in pop order (tests)."""
        with self.cond:
            return [
                item for cls in SLO_CLASSES for item in self._queues[cls]
            ]

    def admit(self, item: dict, timeout: float | None = None) -> None:
        """Admit one entry or shed it. ``item`` must carry ``x`` (the
        rows), ``done``/``err``/``abandoned``, ``t_submit`` and
        ``slo_class``; this sets ``item["deadline"]`` (absolute
        monotonic expiry of the caller's budget — the wait bound and
        the stage-time expiry check read the same number) and
        ``item["_wait"]``. Raises
        :class:`~tpu_dist_nn_torch.utils.errors.UnavailableError` after
        close and :class:`~tpu_dist_nn_torch.utils.errors
        .ResourceExhaustedError` (with ``retry_after_ms``) at the
        class watermark."""
        cls = item.setdefault("slo_class", "standard")
        if cls not in CLASS_RANK:
            cls = item["slo_class"] = normalize_class(cls)
        n = len(item["x"])
        bounds = [
            t for t in (self._submit_timeout, timeout) if t is not None
        ]
        item["_wait"] = min(bounds) if bounds else None
        # Expiry tracks the CALLER's budget only: submit_timeout is the
        # server's bound on holding a worker thread, not evidence the
        # client stopped waiting.
        item["deadline"] = (
            item["t_submit"] + timeout if timeout is not None else None
        )
        shed_pending = None
        with self.cond:
            if self.closed:
                raise UnavailableError("server is shutting down")
            watermark = self.effective_watermark(cls)
            # Admission control: past the class watermark, shed NOW
            # with a back-off signal instead of queueing work the
            # device is already minutes behind on. An oversized request
            # against an EMPTY queue is admitted — it could otherwise
            # never run; the watermark bounds backlog, not batch size.
            if (watermark is not None and self.has_pending()
                    and self.pending_rows + n > watermark):
                self.shed_total += 1
                self._m_shed.inc()
                self._m_class_shed[cls].inc()
                shed_pending = self.pending_rows
            else:
                self._queues[cls].append(item)
                self.pending_rows += n
                self.requests_total += 1
                self.cond.notify()
        if shed_pending is not None:
            retry_after = self.retry_after_ms()
            # Emitted OUTSIDE cond: the record write blocks on stderr,
            # and one stalled log consumer holding the admission lock
            # would wedge every submit and the device loop behind it.
            slog.warning(
                "batcher.shed", method=self.method, slo_class=cls,
                pending_rows=shed_pending, rows=n,
                watermark=watermark, retry_after_ms=retry_after,
            )
            e = ResourceExhaustedError(
                f"serving queue at capacity for class {cls} "
                f"({shed_pending} rows pending, watermark "
                f"{watermark:g}); back off and retry"
            )
            # The backoff hint rides the exception to
            # _abort_for_exception, which turns it into
            # x-tdn-retry-after-ms trailing metadata.
            e.retry_after_ms = retry_after
            raise e

    def wait(self, item: dict, what: str = "batch") -> None:
        """Block the submitting thread on ``item["done"]`` under the
        bound computed at admit; marks the entry abandoned and raises
        DEADLINE_EXCEEDED on expiry, re-raises a recorded error, and
        observes the wait histograms (method + class) on success."""
        wait = item["_wait"]
        # Bounded wait: if the engine wedges mid-batch, the gRPC
        # worker thread must get back to the client with
        # DEADLINE_EXCEEDED instead of blocking forever — an unbounded
        # wait would eventually strand every worker thread.
        if not item["done"].wait(wait):
            # Mark abandoned under the lock so the consumer discards
            # it at pop time: without this, a long wedge accumulates
            # dead requests unboundedly and the recovered engine burns
            # its first launches computing rows nobody is waiting for.
            with self.cond:
                item["abandoned"] = True
            raise DeadlineExceededError(
                f"{what} did not complete within {wait}s "
                "(engine wedged or request backlogged?)"
            )
        # Observed before the error re-raise (the legacy order): a
        # served-with-error entry still spent its time in the queue.
        waited = time.monotonic() - item["t_submit"]
        self._m_wait.observe(waited)
        self._m_class_wait[item["slo_class"]].observe(waited)
        if item["err"] is not None:
            raise item["err"]

    # ------------------------------------------------------------- pop

    def _expire(self, item: dict, now: float) -> None:  # caller-holds: cond
        """Finalize one entry whose caller budget ran out while it
        queued: DEADLINE_EXCEEDED without a launch."""
        cls = item["slo_class"]
        self.expired_total += 1
        self._m_expired[cls].inc()
        if item["err"] is None:
            item["err"] = DeadlineExceededError(
                "request budget exhausted while queued "
                f"(waited {now - item['t_submit']:.3f}s); not launched"
            )
            item["done"].set()
        self._deferred.append(
            (cls, len(item["x"]), now - item["t_submit"])
        )

    def _dead(self, item: dict, now: float) -> bool:  # caller-holds: cond
        """Is this popped entry not worth launching? Abandoned/errored
        entries are discarded silently (the waiter already raised);
        budget-expired ones are failed over via :meth:`_expire`."""
        if item["abandoned"] or item["err"] is not None:
            return True
        if item["deadline"] is not None and now >= item["deadline"]:
            self._expire(item, now)
            return True
        return False

    def _head_class(self):  # caller-holds: cond
        for cls in SLO_CLASSES:
            if self._queues[cls]:
                return cls
        return None

    def peek_rank(self) -> int | None:  # caller-holds: cond
        """Rank of the first non-empty class queue (liveness of the
        head entry is only known at pop time)."""
        cls = self._head_class()
        return None if cls is None else CLASS_RANK[cls]

    def pop_group(self, max_rows: int) -> tuple[list, int]:  # caller-holds: cond
        """Batcher-style pop: whole entries up to ``max_rows`` rows in
        class-priority order (the first entry is always taken even if
        oversized). Dead entries leave the ledger without joining the
        batch."""
        now = time.monotonic()
        batch: list = []
        rows = 0
        while True:
            cls = self._head_class()
            if cls is None:
                break
            head = self._queues[cls][0]
            n = len(head["x"])
            if batch and rows + n > max_rows:
                break
            self._queues[cls].popleft()
            # Popped (computed OR dropped): either way these rows
            # leave the admission ledger.
            self.pending_rows -= n
            if self._dead(head, now):
                continue
            rows += n
            batch.append(head)
        return batch, rows

    def pop_row(self, max_rank: int | None = None):  # caller-holds: cond
        """Row-granular pop (the continuous scheduler's admission
        unit): the next ``(item, row_index)`` in class-priority order,
        or None. ``max_rank`` restricts to classes at least that good
        (0 = critical only, the preemption path's pop)."""
        now = time.monotonic()
        while True:
            cls = self._head_class()
            if cls is None or (
                max_rank is not None and CLASS_RANK[cls] > max_rank
            ):
                return None
            item = self._queues[cls][0]
            if self._dead(item, now):
                self._queues[cls].popleft()
                self.pending_rows -= len(item["x"]) - item.get("next_row", 0)
                continue
            row = item.get("next_row", 0)
            item["next_row"] = row + 1
            self.pending_rows -= 1
            if item["next_row"] >= len(item["x"]):
                self._queues[cls].popleft()
            return item, row

    def drain_deferred(self) -> None:
        """Emit the expiry evidence accumulated under the lock (called
        by the device loops after releasing it; rate-limited by the
        structured-log channel)."""
        with self.cond:
            events, self._deferred = self._deferred, []
        for cls, rows, waited in events:
            slog.warning(
                "batcher.expired", method=self.method, slo_class=cls,
                rows=rows, waited_s=round(waited, 3),
            )

    # ----------------------------------------------------------- close

    def close_begin(self) -> None:
        with self.cond:
            self.closed = True
            self.cond.notify_all()

    def sweep_leftovers(self) -> None:
        """Fail everything STILL queued over as UNAVAILABLE (a wedged
        loop never popped it): its waiters would otherwise sit out
        their full submit timeout against a scheduler that is already
        gone. Pops under the lock, so a still-alive loop thread and
        this sweep never double-serve an entry."""
        leftovers = []
        with self.cond:
            for cls in SLO_CLASSES:
                q = self._queues[cls]
                while q:
                    item = q.popleft()
                    self.pending_rows -= (
                        len(item["x"]) - item.get("next_row", 0)
                    )
                    if not item["abandoned"] and item["err"] is None:
                        leftovers.append(item)
        for item in leftovers:
            item["err"] = UnavailableError(
                "server shut down before this request was served"
            )
            item["done"].set()

    # ------------------------------------------------------ retry-after

    def note_drained(self, rows: int) -> None:
        """Record ``rows`` completions (drain fan-out / slot retire):
        the drain-rate window behind the shed replies' backoff hint."""
        now = time.monotonic()
        with self._drain_lock:
            self._drained.append((now, int(rows)))
            cutoff = now - _DRAIN_WINDOW_S
            while self._drained and self._drained[0][0] < cutoff:
                self._drained.popleft()

    def retry_after_ms(self) -> int:
        """The shed reply's backoff hint: how long the CURRENT backlog
        needs at the CURRENT drain rate, clamped to
        [RETRY_AFTER_MIN_MS, RETRY_AFTER_MAX_MS]. No drain observed in
        the window (wedged or idle-then-burst device) pins the cap —
        the backlog is not moving, retrying sooner cannot help."""
        now = time.monotonic()
        with self._drain_lock:
            cutoff = now - _DRAIN_WINDOW_S
            while self._drained and self._drained[0][0] < cutoff:
                self._drained.popleft()
            drained = sum(r for _, r in self._drained)
            oldest = self._drained[0][0] if self._drained else None
        if not drained:
            return RETRY_AFTER_MAX_MS
        with self.cond:
            backlog = self.pending_rows
        span = max(now - oldest, 0.25)
        rate = drained / span  # rows per second
        ms = int(backlog / rate * 1000.0)
        return max(RETRY_AFTER_MIN_MS, min(RETRY_AFTER_MAX_MS, ms))
