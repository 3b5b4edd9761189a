"""Client/server resilience: retries, circuit breaking, graceful drain.

Port of :mod:`tpu_dist_nn.serving.resilience`. The reference's failure
story is status propagation plus "the channel is dead, clients may
retry elsewhere" (``grpc_node.py:136-158``); these are the pieces that
make a transient fault cost a client one backoff instead of a failed
request:

* :class:`RetryPolicy` — capped exponential backoff with FULL jitter
  (``uniform(0, min(cap, base * 2^attempt))``), applied only to
  transient statuses (``UNAVAILABLE``, ``DEADLINE_EXCEEDED``) and to
  sheds. Every attempt's deadline is carved from the caller's
  REMAINING timeout.
* :class:`CircuitBreaker` — per-target closed → open after N
  consecutive transient failures, one half-open probe after a cooldown.
  While open, calls fail fast with
  :class:`~tpu_dist_nn_torch.utils.errors.UnavailableError`.
* :class:`GracefulDrain` — the shutdown sequence of ``up``: SIGTERM →
  the gRPC server stops accepting new calls → in-flight RPCs drain
  within the grace window → the serve loop exits.

The policy's jitter RNG is seedable and its sleep injectable; the
breaker's clock is injectable: tests drive both without sleeping.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import signal
import threading
import time
import uuid

from tpu_dist_nn_torch.obs.registry import REGISTRY

log = logging.getLogger(__name__)

# Retries the CLIENT issued, per method — the acceptance signal that a
# faulty run recovered through the policy rather than by luck.
# Stable for the life of this process, different every boot: /healthz
# carries it (GracefulDrain.wrap_health) so a poller can tell a
# restarted server on a reused address from the same process answering.
BOOT_ID = uuid.uuid4().hex

CLIENT_RETRIES = REGISTRY.counter(
    "tdn_client_retries_total",
    "retry attempts issued by GrpcClient after a retryable status",
    labels=("method",),
)
# Breaker state per target: 0 closed, 1 half-open, 2 open (higher =
# less traffic flows). Alert on ==2 sustained.
BREAKER_STATE = REGISTRY.gauge(
    "tdn_breaker_state",
    "circuit breaker state per target (0=closed, 1=half-open, 2=open)",
    labels=("target",),
)
# 1 while this process is draining (SIGTERM received, in-flight work
# finishing) — what explains a refusing-but-alive server.
SERVER_DRAINING = REGISTRY.gauge(
    "tdn_server_draining",
    "1 while graceful drain is in progress (new work refused)",
)

# Status names the policy treats as transient. DEADLINE_EXCEEDED is
# retryable because the server carves it from a bounded submit wait (a
# wedged batch), which a fresh attempt may miss; INVALID_ARGUMENT /
# INTERNAL are deterministic and retrying them only doubles the damage.
RETRYABLE_CODES = frozenset({"UNAVAILABLE", "DEADLINE_EXCEEDED"})


def _code_name(code) -> str:
    """Accept a grpc.StatusCode, a FrameworkError code string, or an
    exception carrying ``.code`` — one classifier for every caller."""
    name = getattr(code, "name", None)
    if name is not None:
        return name
    if isinstance(code, str):
        return code
    inner = getattr(code, "code", None)
    if inner is not None and not callable(inner):
        return _code_name(inner)
    return "UNKNOWN"


@dataclasses.dataclass
class RetryPolicy:
    """Capped exponential backoff with full jitter, budget-aware.

    ``backoff(attempt)`` draws ``uniform(0, min(max_delay, base_delay *
    2^(attempt-1)))`` from a seedable RNG — full jitter, so a burst of
    clients that failed together does not retry together (the thundering
    herd the deterministic schedule would re-create). ``max_attempts``
    counts the ORIGINAL call: 3 means at most 2 retries; 1 disables
    retrying while keeping the classification/enrichment path.

    The caller (``GrpcClient._traced_call``) owns the total budget:
    each attempt's RPC deadline is the caller's remaining timeout, and
    a backoff that would sleep past the budget raises the last error
    instead — retries never extend the original deadline.
    """

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    retryable_codes: frozenset = RETRYABLE_CODES
    seed: int | None = None
    sleep: object = time.sleep  # injectable for deterministic tests

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}"
            )
        if self.base_delay < 0 or self.max_delay < 0:
            raise ValueError("delays must be >= 0")
        self._rng = random.Random(self.seed)

    def retryable(self, code) -> bool:
        return _code_name(code) in self.retryable_codes

    def backoff(self, attempt: int, floor: float | None = None) -> float:
        """Jittered delay BEFORE retry number ``attempt`` (1-based:
        attempt 1 is the delay after the first failed call).

        ``floor`` is a server-provided minimum (the shed replies'
        ``x-tdn-retry-after-ms`` hint, in seconds): the draw is
        clamped UP to it — jitter still spreads the herd above the
        floor, but nobody retries before the server said the backlog
        could have moved. The floor may exceed ``max_delay`` (the
        server knows its own drain rate better than the client's cap).
        """
        cap = min(self.max_delay, self.base_delay * (2 ** max(0, attempt - 1)))
        delay = self._rng.uniform(0.0, cap)
        if floor is not None and floor > 0:
            # Full jitter ON TOP of the floor (up to 25%): a uniform
            # clamp would stack every shed client on the exact floor
            # tick — the synchronized storm the hint exists to break.
            return max(delay, floor * self._rng.uniform(1.0, 1.25))
        return delay


class CircuitBreaker:
    """Per-target closed → open → half-open breaker.

    ``record_failure`` counts CONSECUTIVE retryable failures (the
    caller classifies; deterministic errors like INVALID_ARGUMENT must
    not trip the breaker — they say nothing about target health). At
    ``failure_threshold`` the breaker opens: ``allow()`` returns False
    (callers fail fast) until ``cooldown_seconds`` elapse, then exactly
    ONE probe call is let through half-open. The probe's outcome
    decides: success closes the breaker, failure re-opens it for
    another cooldown.

    Thread-safe; ``clock`` is injectable so tests drive the cooldown
    without sleeping. State is published to ``tdn_breaker_state``
    (0 closed / 1 half-open / 2 open) per target.
    """

    CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
    _STATE_VALUE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}

    # Shared per-target instances: every GrpcClient to the same target
    # in this process sees the same breaker (the point — N clients must
    # not each pay the full failure run before backing off).
    _registry: dict[str, "CircuitBreaker"] = {}  # guarded-by: _registry_lock
    _registry_lock = threading.Lock()

    def __init__(self, target: str = "", *, failure_threshold: int = 10,
                 cooldown_seconds: float = 1.0, clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        self.target = target
        self.failure_threshold = int(failure_threshold)
        self.cooldown_seconds = float(cooldown_seconds)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED  # guarded-by: _lock
        self._consecutive = 0  # guarded-by: _lock
        self._opened_at = 0.0  # guarded-by: _lock
        self._probing = False  # guarded-by: _lock
        self._probe_started = 0.0  # guarded-by: _lock
        self._gauge = BREAKER_STATE.labels(target=target)
        self._gauge.set(0.0)

    @classmethod
    def for_target(cls, target: str, **kwargs) -> "CircuitBreaker":
        """The process-wide breaker for ``target`` (first caller's
        config wins). Construct directly for a private instance with
        guaranteed tuning — a registry hit cannot honor ``kwargs``."""
        with cls._registry_lock:
            br = cls._registry.get(target)
            if br is None:
                br = cls._registry[target] = cls(target, **kwargs)
            elif kwargs:
                mismatched = {
                    k: v for k, v in kwargs.items()
                    if k != "clock" and getattr(br, k, None) != v
                }
                if mismatched:
                    log.warning(
                        "breaker for %s already registered; ignoring "
                        "differing config %s (pass a CircuitBreaker "
                        "instance for per-client tuning)",
                        target, mismatched,
                    )
            return br

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _set_state(self, state: str) -> None:  # caller-holds: _lock
        self._state = state
        self._gauge.set(self._STATE_VALUE[state])

    def allow(self) -> bool:
        """May a call proceed right now? Transitions open → half-open
        when the cooldown has elapsed (this caller becomes the probe)."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            now = self._clock()
            if self._state == self.OPEN:
                if now - self._opened_at >= self.cooldown_seconds:
                    self._set_state(self.HALF_OPEN)
                    self._probing = True
                    self._probe_started = now
                    return True
                return False
            # HALF_OPEN: one probe in flight at a time — but a probe
            # slot AGES OUT after a cooldown. A prober that vanished
            # without recording its outcome (process bug, an exception
            # between allow() and the call) must not wedge the breaker
            # into fail-fast forever.
            if (self._probing
                    and now - self._probe_started < self.cooldown_seconds):
                return False
            self._probing = True
            self._probe_started = now
            return True

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._probing = False
            if self._state != self.CLOSED:
                log.info("breaker %s: probe succeeded, closing", self.target)
            self._set_state(self.CLOSED)

    def record_failure(self) -> None:
        """Count one RETRYABLE failure (caller classifies first)."""
        with self._lock:
            self._probing = False
            if self._state == self.HALF_OPEN:
                # The probe failed: back to open for a fresh cooldown.
                self._opened_at = self._clock()
                self._set_state(self.OPEN)
                return
            self._consecutive += 1
            if (self._state == self.CLOSED
                    and self._consecutive >= self.failure_threshold):
                log.warning(
                    "breaker %s: %d consecutive retryable failures, "
                    "opening for %.1fs", self.target, self._consecutive,
                    self.cooldown_seconds,
                )
                self._opened_at = self._clock()
                self._set_state(self.OPEN)


class GracefulDrain:
    """The drain sequence for one serving process.

    Wire-up (``cmd_up`` / ``cmd_lm`` do exactly this):

    1. construct BEFORE the metrics endpoint, so :meth:`wrap_health`
       can gate ``/healthz``;
    2. ``add_server(server)`` for each gRPC server (whose wrapped
       ``stop`` already closes its batcher after the grace window —
       :func:`~tpu_dist_nn_torch.serving.server._wrap_server_stop`);
    3. ``install_signal_handler()`` (best-effort: signal handlers only
       install from the main thread; tests call :meth:`begin` directly).

    On SIGTERM / ``begin()``: ``tdn_server_draining`` → 1 and
    ``/healthz`` flips NOT_SERVING *first* (a load balancer must stop
    routing before the port refuses), then every
    server stops accepting new RPCs while in-flight calls get
    ``grace_seconds`` to finish; ``drained`` is set when they have.
    ``begin`` is idempotent — the signal handler and the teardown path
    can both call it.
    """

    def __init__(self, grace_seconds: float = 5.0):
        self.grace_seconds = float(grace_seconds)
        self.draining = threading.Event()
        self.drained = threading.Event()
        self._servers: list = []  # guarded-by: _lock
        # RLock: the SIGTERM handler runs ON the main thread — if the
        # signal lands while that thread is already inside begin()'s
        # critical section, a plain Lock would self-deadlock the whole
        # drain. Reentrancy + the _begun latch make the interrupted
        # case collapse to a no-op instead.
        self._lock = threading.RLock()
        self._begun = False  # guarded-by: _lock

    def add_server(self, server) -> None:
        with self._lock:
            self._servers.append(server)

    def wrap_health(self, health_fn=None):
        """Wrap a ``/healthz`` closure: while draining, ``ready`` is
        forced False (HTTP 503, NOT_SERVING) and ``draining: true``
        names why, whatever the engine underneath reports. Every payload
        also carries this process's ``boot_id``."""

        def health():
            if self.draining.is_set():
                # Draining is the headline; a probe failing mid-drain
                # (the engine may already be down) must not erase it.
                base = {}
                try:
                    if health_fn is not None:
                        base = dict(health_fn())
                except Exception as e:  # noqa: BLE001 — drain wins
                    base = {"error": repr(e)}
                base["ready"] = False
                base["draining"] = True
                base.setdefault("boot_id", BOOT_ID)
                return base
            base = dict(health_fn()) if health_fn is not None else {"ready": True}
            base.setdefault("draining", False)
            base.setdefault("boot_id", BOOT_ID)
            return base

        return health

    def install_signal_handler(self, signals=(signal.SIGTERM,)) -> bool:
        """Route SIGTERM (by default) to :meth:`begin`. Best-effort:
        only the main thread may install handlers — in-process callers
        (tests, embedding apps) call ``begin()`` themselves."""
        try:
            for s in signals:
                signal.signal(s, lambda *_: self.begin())
            return True
        except ValueError:
            log.warning(
                "not in the main thread: graceful-drain signal handler "
                "not installed; call GracefulDrain.begin() to drain"
            )
            return False

    def begin(self) -> threading.Event:
        """Start (or join) the drain; returns the ``drained`` event.
        Idempotent and signal-safe: the teardown path and the SIGTERM
        handler may both call it (even nested on one thread)."""
        # fast path, no lock: signal-handler friendly (benign race —
        # the locked re-check below arbitrates)
        if self._begun:
            return self.drained
        with self._lock:
            if self._begun:
                return self.drained
            self._begun = True
            self.draining.set()
            SERVER_DRAINING.set(1.0)
            servers = list(self._servers)
        log.info(
            "graceful drain: refusing new work, %.1fs grace for "
            "in-flight RPCs", self.grace_seconds,
        )
        events = [srv.stop(grace=self.grace_seconds) for srv in servers]

        def waiter():
            for ev in events:
                ev.wait()
            SERVER_DRAINING.set(0.0)
            self.drained.set()
            log.info("graceful drain complete")

        if events:
            threading.Thread(
                target=waiter, name="tdn-drain-wait", daemon=True
            ).start()
        else:
            SERVER_DRAINING.set(0.0)
            self.drained.set()
        return self.drained

    def wait(self, timeout: float | None = None) -> bool:
        return self.drained.wait(timeout)
