"""Flight recorder: anomaly-triggered incident bundles.

Port of :mod:`tpu_dist_nn.obs.incident` (the same bundle members,
manifest keys and routes; the manifest's ``versions`` name torch and
CUDA). The rest of the plane is the SENSOR half — metrics,
``x-tdn-trace`` distributed tracing, ``/profile`` attribution, the
``/timeseries`` ring, SLO burn rates. Detection and diagnosis stayed
disconnected: every one of those surfaces is a bounded ring, so by the
time a human reacts to a ``slo.burn`` page the slow exemplar traces,
the log lines, and the timeseries window around the anomaly have been
evicted, and a crash leaves nothing at all. This module is the
black-box flight recorder closing that gap:

* **Detectors** (:class:`SLOBurnDetector`, :class:`SpikeDetector`,
  :class:`BreakerOpenDetector`, :class:`DrainFailoverDetector`) are
  evaluated on the EXISTING runtime-sampler tick
  (:meth:`~tpu_dist_nn_torch.obs.runtime.RuntimeSampler
  .add_incident_recorder`) — never on a request path. Arming the
  recorder costs the serving hot path nothing: detectors read the
  time-series ring, the SLO tracker's last verdict, and registry
  gauges, all host-side dict reads, once per tick on the sampler's
  daemon thread.
* **Bundles** (:func:`capture_bundle`): on trigger, one zip snapshots
  everything a post-incident debug needs — the Chrome trace ring
  (slowest exemplars included), ``/profile`` attribution, the
  ``/timeseries`` window bracketing the trigger, the structured-log
  ring (:class:`~tpu_dist_nn_torch.obs.log.LogRing`), ``/slo`` state, the
  full ``/metrics`` exposition, and a ``manifest.json`` naming the
  trigger, reason, process identity, and versions.
* **Bounded on-disk store** (:class:`IncidentStore`): bundles land in
  ``--incident-dir`` as ``<id>.zip``; the oldest are pruned past
  ``--incident-max`` (default 20) so a flapping detector can never
  fill a disk. Per-detector cooldowns (default 300s) bound capture
  frequency the same way.
* **Crash hook** (:func:`install_crash_hook`): ``sys.excepthook`` /
  ``threading.excepthook`` capture a bundle naming an unhandled
  exception before the process dies; fatal signals (SIGABRT by
  default) capture-then-rethrow through the default handler; and
  ``faulthandler`` is enabled into ``<incident-dir>/faulthandler.log``
  so even a C-level death that outruns Python leaves its stack next
  to the bundles.
* **Fleet capture** (the router's recorder fanning ``GET
  /debug/bundle`` out to every replica and stitching their traces)
  waits for the router plane: a recorder here captures its own process,
  and the router-side detectors (:class:`DrainFailoverDetector`,
  :class:`AutoscaleFlapDetector`) stay inert until those families exist.

Surfaces: ``GET /debug/bundle`` (on-demand capture, built into every
metrics endpoint), ``GET /incidents`` + ``GET /incidents/get?id=``
(:func:`incident_routes`), ``tdn incident ls|show|pull``, ``tdn debug
bundle``, and ``--incident-dir``/``--incident-max`` on
``up``/``lm``. Stdlib-only; docs/OBSERVABILITY.md
"Incidents & flight recorder" is the operator guide.
"""

from __future__ import annotations

import io
import json
import logging
import os
import re
import signal
import sys
import threading
import time
import traceback
import zipfile

from tpu_dist_nn_torch.obs.log import LOG_RING, get_logger

log = logging.getLogger(__name__)
slog = get_logger(__name__)

DEFAULT_MAX_INCIDENTS = 20
DEFAULT_COOLDOWN_SECONDS = 300.0
# The timeseries/log window a bundle brackets around its trigger.
DEFAULT_WINDOW_SECONDS = 600.0

_ID_SAFE = re.compile(r"[^A-Za-z0-9._-]+")
# The minted incident-id shape (new_incident_id): the store only
# lists/prunes files matching it, so a foreign zip dropped in the
# directory (an operator's pulled copy, a stray artifact) neither
# masquerades as an incident nor costs a max_incidents slot — pruning
# must never delete real evidence to make room for a copy.
_BUNDLE_NAME = re.compile(
    r"^\d{8}T\d{6}_[A-Za-z0-9._-]+_[0-9a-f]{6}\.zip$"
)


def _safe(text: str, limit: int = 48) -> str:
    return (_ID_SAFE.sub("-", str(text)).strip("-") or "x")[:limit]


def new_incident_id(trigger: str, now: float | None = None) -> str:
    t = time.time() if now is None else now
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(t))
    return f"{stamp}_{_safe(trigger)}_{os.urandom(3).hex()}"


# --------------------------------------------------------------- store


class IncidentStore:
    """Bounded on-disk incident directory: ``<dir>/<incident_id>.zip``.

    ``save`` prunes the OLDEST bundles past ``max_incidents`` (by the
    sortable timestamp prefix of the id, mtime as the tiebreak), so a
    misbehaving detector bounds its own disk damage. Listing reads each
    zip's ``manifest.json`` — at N <= max_incidents that is a handful
    of small reads, not a scan worth indexing.
    """

    def __init__(self, directory: str,
                 max_incidents: int = DEFAULT_MAX_INCIDENTS):
        if max_incidents < 1:
            raise ValueError(
                f"max_incidents must be >= 1, got {max_incidents}"
            )
        self.directory = directory
        self.max_incidents = int(max_incidents)
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)

    def _path(self, incident_id: str) -> str:
        # The id came off the wire for reads: never let it traverse.
        return os.path.join(self.directory, _safe(incident_id, 120) + ".zip")

    def save(self, incident_id: str, data: bytes) -> str:
        path = self._path(incident_id)
        with self._lock:
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)  # a reader never sees a half bundle
            self._prune_locked()
        return path

    def _entries(self) -> list[str]:
        """Bundle filenames (minted-id shape only — see _BUNDLE_NAME),
        oldest first: mtime then name, so ids minted within the same
        second still prune in arrival order."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []

        def key(n):
            try:
                mt = os.path.getmtime(os.path.join(self.directory, n))
            except OSError:
                mt = 0.0
            return (mt, n)

        return sorted((n for n in names if _BUNDLE_NAME.match(n)),
                      key=key)

    def _prune_locked(self) -> None:
        entries = self._entries()
        for name in entries[: max(len(entries) - self.max_incidents, 0)]:
            try:
                os.remove(os.path.join(self.directory, name))
            except OSError:  # already gone / perms: pruning is advisory
                pass

    def ids(self) -> list[str]:
        return [n[:-4] for n in self._entries()]

    def manifest(self, incident_id: str) -> dict | None:
        path = self._path(incident_id)
        try:
            with zipfile.ZipFile(path) as z:
                doc = json.loads(z.read("manifest.json"))
        except (OSError, KeyError, ValueError, zipfile.BadZipFile):
            return None
        if isinstance(doc, dict):
            doc.setdefault("bytes", os.path.getsize(path))
        return doc if isinstance(doc, dict) else None

    def read(self, incident_id: str) -> bytes | None:
        try:
            with open(self._path(incident_id), "rb") as f:
                return f.read()
        except OSError:
            return None

    def list(self) -> list[dict]:
        """Newest first: each incident's manifest (or a stub naming an
        unreadable bundle — a truncated crash-time write is itself
        evidence, not a listing failure)."""
        out = []
        for incident_id in reversed(self.ids()):
            doc = self.manifest(incident_id)
            if doc is None:
                doc = {"incident_id": incident_id,
                       "error": "unreadable bundle"}
            out.append(doc)
        return out


# ------------------------------------------------------- bundle capture


def _versions() -> dict:
    v = {"python": sys.version.split()[0]}
    torch = sys.modules.get("torch")  # never IMPORT torch for a bundle:
    if torch is not None:             # a process that never loaded it
        v["torch"] = getattr(torch, "__version__", "?")  # has no card
        v["cuda"] = getattr(getattr(torch, "version", None), "cuda", None)
    return v


def _boot_id() -> str | None:
    # The same boot_id /healthz reports (resilience.BOOT_ID) when the
    # serving stack is loaded; None in processes that never imported it
    # (importing grpc from here would break obs/'s stdlib-only rule).
    res = sys.modules.get("tpu_dist_nn_torch.serving.resilience")
    return getattr(res, "BOOT_ID", None) if res is not None else None


def capture_bundle(trigger: str, reason: str = "", details=None, *,
                   tracer=None, registry=None, ring=None, slo=None,
                   log_ring=None, window: float = DEFAULT_WINDOW_SECONDS,
                   extra_files: dict | None = None,
                   extra_manifest: dict | None = None,
                   incident_id: str | None = None) -> tuple[str, bytes]:
    """One diagnostic bundle as ``(incident_id, zip_bytes)``.

    Sections degrade independently: a source that is absent (no ring
    attached) is skipped, a source that RAISES is recorded in the
    manifest's ``section_errors`` — a crash-time capture must salvage
    whatever it can reach, never abort on the first broken surface.
    """
    if tracer is None:
        from tpu_dist_nn_torch.obs.trace import TRACER as tracer  # noqa: N813
    if registry is None:
        from tpu_dist_nn_torch.obs.registry import REGISTRY as registry
    if log_ring is None:
        log_ring = LOG_RING
    iid = incident_id or new_incident_id(trigger)
    files: dict[str, bytes] = {}
    errors: dict[str, str] = {}

    def section(name, fn):
        try:
            body = fn()
        except Exception as e:  # noqa: BLE001 — salvage the rest
            errors[name] = repr(e)
            return
        if body is not None:
            files[name] = body

    section("trace.json", lambda: json.dumps(
        tracer.chrome_trace()
    ).encode())
    section("profile.json", lambda: _profile_json(tracer))
    section("metrics.txt", lambda: _metrics_text(registry))
    if ring is not None:
        section("timeseries.json", lambda: json.dumps({
            "resolution_seconds": ring.resolution,
            "retention_seconds": ring.retention,
            "window_seconds": window,
            "series": ring.series(window=window),
        }).encode())
    if slo is not None:
        section("slo.json", lambda: json.dumps(slo.status()).encode())
    if log_ring is not None:
        # default=repr, like the /logs route: StructuredLogger fields
        # are arbitrary objects, and one numpy scalar in the ring must
        # not cost the bundle its ENTIRE log section.
        section("logs.json", lambda: json.dumps({
            "window_seconds": window,
            "dropped_total": log_ring.dropped_total,
            "records": log_ring.snapshot(window=window),
        }, default=repr).encode())
    if extra_files:
        files.update(extra_files)
    manifest = {
        "incident_id": iid,
        "trigger": trigger,
        "reason": reason,
        "captured_at": time.time(),
        "captured_at_iso": time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
        ),
        "pid": os.getpid(),
        "boot_id": _boot_id(),
        "argv": list(sys.argv),
        "versions": _versions(),
        "window_seconds": window,
        "sections": sorted(files),
    }
    if details:
        manifest["details"] = details
    if errors:
        manifest["section_errors"] = errors
    if extra_manifest:
        manifest.update(extra_manifest)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("manifest.json", json.dumps(manifest, default=repr))
        for name, body in sorted(files.items()):
            z.writestr(name, body)
    return iid, buf.getvalue()


def _profile_json(tracer) -> bytes:
    from tpu_dist_nn_torch.obs.profile import profile_snapshot

    return json.dumps(profile_snapshot(tracer)).encode()


def _metrics_text(registry) -> bytes:
    from tpu_dist_nn_torch.obs.exposition import render

    return render(registry).encode()


# ------------------------------------------------------------ detectors


class SLOBurnDetector:
    """Fires while any objective's FAST window burns above
    ``threshold`` (the page condition — Site Reliability Workbook ch.5
    fast-burn). Reads the SLO tracker's LAST verdict: the sampler
    evaluates trackers earlier in the same tick, so the view is this
    tick's, and the detector never recomputes windows itself."""

    name = "slo.burn"

    def __init__(self, threshold: float = 1.0):
        self.threshold = float(threshold)

    def check(self, rec, now=None) -> str | None:
        if rec.slo is None:
            return None
        doc = rec.slo.status()
        burning = []
        for obj in doc.get("objectives", ()):
            fast = (obj.get("windows") or {}).get("fast") or {}
            if (fast.get("burn_rate", 0.0) > self.threshold
                    and fast.get("total", 0.0) > 0):
                burning.append(
                    f"{obj.get('name')} fast burn "
                    f"{fast.get('burn_rate'):g} "
                    f"({obj.get('objective', '')})"
                )
        return "; ".join(burning) if burning else None


class SpikeDetector:
    """Fires when a cumulative family's windowed ring delta crosses
    ``min_count`` — the shed-storm / error-spike shape. ``exclude``
    drops label matches from the sum (router outcomes: everything but
    ``ok`` is an error)."""

    def __init__(self, name: str, family: str, *, window: float = 60.0,
                 min_count: float = 5.0, match: dict | None = None,
                 exclude: dict | None = None):
        self.name = name
        self.family = family
        self.window = float(window)
        self.min_count = float(min_count)
        self.match = dict(match or {})
        self.exclude = dict(exclude or {})

    def check(self, rec, now=None) -> str | None:
        if rec.ring is None:
            return None
        from tpu_dist_nn_torch.obs.exposition import split_series

        total = 0.0
        for key in rec.ring.keys(family=self.family):
            sname, labels = split_series(key)
            if sname != self.family:
                continue
            if any(labels.get(k) != str(v) for k, v in self.match.items()):
                continue
            if self.exclude and all(
                labels.get(k) == str(v) for k, v in self.exclude.items()
            ):
                continue
            total += rec.ring.delta(key, self.window, now)[0]
        if total >= self.min_count:
            return (f"{self.family} +{total:g} in the last "
                    f"{self.window:g}s (threshold {self.min_count:g})")
        return None


class BreakerOpenDetector:
    """Fires on a breaker TRANSITION to open (``tdn_breaker_state`` ==
    2): edge-triggered on the per-target state seen last tick, so a
    breaker that stays open across many ticks is one incident, and the
    next open after recovery is a new one."""

    name = "breaker.open"
    _OPEN = 2.0

    def __init__(self):
        self._last: dict[tuple, float] = {}

    def check(self, rec, now=None) -> str | None:
        fam = rec.registry.get("tdn_breaker_state")
        if fam is None:
            return None
        opened = []
        seen: dict[tuple, float] = {}
        for values, child in fam.samples():
            seen[values] = child.value
            if (child.value == self._OPEN
                    and self._last.get(values) != self._OPEN):
                opened.append(",".join(values) or "default")
        self._last = seen
        if opened:
            return f"circuit breaker opened for {'; '.join(opened)}"
        return None


class DrainFailoverDetector:
    """Router-side: fires when the pool's membership/drain choreography
    moved (a replica began draining, was removed, crashed and is being
    respawned) or the router re-placed requests onto another replica
    (``tdn_router_failovers_total`` rose since last tick) — the fleet
    absorbing a replica loss is exactly the moment its state is worth
    freezing."""

    name = "drain.failover"

    def __init__(self):
        self._transitions: float | None = None
        self._failovers: float | None = None

    def check(self, rec, now=None) -> str | None:
        reasons = []
        pool = rec.pool
        if pool is not None:
            cur = float(getattr(pool, "transitions_total", 0))
            if self._transitions is not None and cur > self._transitions:
                states = {
                    s["target"]: s["state"] for s in pool.snapshot()
                    if s["state"] != "active"
                }
                reasons.append(
                    f"{cur - self._transitions:g} replica state "
                    f"transition(s); non-active: {states or 'none now'}"
                )
            self._transitions = cur
        fam = rec.registry.get("tdn_router_failovers_total")
        if fam is not None:
            cur = sum(child.value for _, child in fam.samples())
            if self._failovers is not None and cur > self._failovers:
                reasons.append(
                    f"{cur - self._failovers:g} failover(s) since last "
                    f"tick"
                )
            self._failovers = cur
        return "; ".join(reasons) if reasons else None


class AutoscaleFlapDetector:
    """Router-side: fires when the autoscaler muted itself
    (``tdn_autoscale_flaps_total`` rose since last tick) — scale
    decisions reversing direction inside the flap window mean the
    policy's inputs are oscillating (crash-respawn storm, thrashing
    load, mis-tuned hysteresis), exactly the moment the fleet's state
    is worth freezing alongside the decision history in the log ring."""

    name = "autoscale.flap"

    def __init__(self):
        self._flaps: float | None = None

    def check(self, rec, now=None) -> str | None:
        fam = rec.registry.get("tdn_autoscale_flaps_total")
        if fam is None:
            return None
        cur = sum(child.value for _, child in fam.samples())
        reason = None
        if self._flaps is not None and cur > self._flaps:
            reason = (
                f"{cur - self._flaps:g} autoscaler flap "
                f"suppression(s) since last tick (scale decisions "
                f"reversing; automatic scaling muted)"
            )
        self._flaps = cur
        return reason


def default_detectors(*, router: bool = False) -> list:
    """The standard detector set ``--incident-dir`` arms: SLO fast
    burn, error/shed spikes, breaker opens — plus the drain/failover
    and autoscaler-flap detectors on a router."""
    dets: list = [
        SLOBurnDetector(),
        BreakerOpenDetector(),
    ]
    if router:
        dets += [
            SpikeDetector("router.error_spike",
                          "tdn_router_requests_total",
                          exclude={"outcome": "ok"}),
            DrainFailoverDetector(),
            AutoscaleFlapDetector(),
        ]
    else:
        dets += [
            SpikeDetector("rpc.error_spike", "tdn_rpc_errors_total"),
            SpikeDetector("batcher.shed_spike", "tdn_batcher_shed_total",
                          min_count=1.0),
        ]
    return dets


# ------------------------------------------------------------- recorder


class FlightRecorder:
    """The armed recorder: sources + detectors + store.

    ``check()`` runs on the runtime sampler's tick (after the SLO
    trackers evaluated): each detector returning a reason outside its
    cooldown triggers :meth:`capture`. Nothing here ever runs on a
    request thread, and a capture (or a broken detector) can never
    break sampling — every failure is logged and swallowed.
    """

    def __init__(self, store: IncidentStore | None = None, *,
                 detectors=(), tracer=None, registry=None, ring=None,
                 slo=None, log_ring=None, pool=None,
                 cooldown: float = DEFAULT_COOLDOWN_SECONDS,
                 window: float = DEFAULT_WINDOW_SECONDS,
                 fleet_timeout: float = 5.0):
        if tracer is None:
            from tpu_dist_nn_torch.obs.trace import TRACER as tracer  # noqa: N813
        if registry is None:
            from tpu_dist_nn_torch.obs.registry import REGISTRY as registry
        self.store = store
        self.detectors = list(detectors)
        self.tracer = tracer
        self.registry = registry
        self.ring = ring
        self.slo = slo
        self.log_ring = log_ring if log_ring is not None else LOG_RING
        self.pool = pool
        self.cooldown = float(cooldown)
        self.window = float(window)
        self.fleet_timeout = float(fleet_timeout)
        self.captured_total = 0
        self._last_fired: dict[str, float] = {}
        # One capture at a time: a detector storm plus a manual
        # /debug/bundle must serialize, not interleave store writes.
        self._capture_lock = threading.Lock()

    # ---------------------------------------------------------- capture

    def bundle(self, trigger: str, reason: str = "", details=None, *,
               fleet: bool | None = None) -> tuple[str, bytes]:
        """Build one bundle in memory (no store write): the
        ``/debug/bundle`` on-demand body. ``fleet`` defaults to "this
        recorder fronts a pool"."""
        if fleet is None:
            fleet = self.pool is not None
        extra_files: dict[str, bytes] = {}
        extra_manifest: dict = {}
        if fleet and self.pool is not None:
            extra_files, extra_manifest = self._fleet_sections()
        return capture_bundle(
            trigger, reason, details,
            tracer=self.tracer, registry=self.registry, ring=self.ring,
            slo=self.slo, log_ring=self.log_ring, window=self.window,
            extra_files=extra_files, extra_manifest=extra_manifest,
        )

    def capture(self, trigger: str, reason: str = "", details=None, *,
                fleet: bool | None = None) -> tuple[str, str | None]:
        """Capture AND persist: ``(incident_id, path)`` (path None
        without a store — the bundle still existed long enough to be
        returned, but detector-triggered captures without a store are
        refused upstream)."""
        with self._capture_lock:
            iid, data = self.bundle(trigger, reason, details, fleet=fleet)
            path = self.store.save(iid, data) if self.store else None
        self.captured_total += 1
        slog.warning(
            "incident.captured", incident_id=iid, trigger=trigger,
            reason=reason, bytes=len(data),
            path=path or "(not persisted)",
        )
        return iid, path

    def _fleet_sections(self) -> tuple[dict, dict]:
        """The router's fleet capture (every replica's bundle and the
        stitched fleet trace) needs the router plane and
        ``obs/collect.py``, which the port does not have yet."""
        raise NotImplementedError(
            "fleet capture needs the router plane (obs/collect.py), which "
            "is not ported; capture this process with fleet=0")

    # --------------------------------------------------------- checking

    def check(self, now: float | None = None) -> list[str]:
        """One detector pass (the sampler tick): returns the incident
        ids captured. Without a store there is nowhere durable to put
        a triggered bundle, so detector checks are skipped entirely —
        "armed" means store + detectors."""
        if self.store is None or not self.detectors:
            return []
        t = time.monotonic() if now is None else float(now)
        captured = []
        for det in self.detectors:
            try:
                reason = det.check(self, now)
            except Exception:  # noqa: BLE001 — one bad detector only
                log.exception("incident detector %s failed",
                              getattr(det, "name", det))
                continue
            if not reason:
                continue
            name = getattr(det, "name", type(det).__name__)
            cooldown = float(getattr(det, "cooldown", self.cooldown))
            last = self._last_fired.get(name)
            if last is not None and t - last < cooldown:
                continue
            try:
                iid, _ = self.capture(name, reason)
                captured.append(iid)
                # Stamped on SUCCESS: a failed capture (transient
                # ENOSPC, a wedged fleet pull) must not silence the
                # detector for the whole cooldown with nothing on disk
                # — the evidence windows would evict before the next
                # attempt. Failures back off ~30s instead, so a
                # persistent failure doesn't rebuild (and fleet-fan-
                # out) the bundle every single tick either.
                self._last_fired[name] = t
            except Exception:  # noqa: BLE001 — capture must not kill ticks
                log.exception("incident capture for %s failed", name)
                self._last_fired[name] = t - max(cooldown - 30.0, 0.0)
        return captured


# ----------------------------------------------------------- crash hook


def install_crash_hook(recorder: FlightRecorder, *,
                       signals=(signal.SIGABRT,),
                       enable_faulthandler: bool = True) -> None:
    """Arm the hard-death paths: an unhandled exception (main thread or
    any serving thread) captures a ``crash.exception`` /
    ``crash.thread_exception`` bundle before the previous hook runs; a
    listed signal captures ``crash.signal`` then re-raises through the
    default handler so the process still dies with the right status;
    and ``faulthandler`` writes C-level stacks into the incident
    directory for deaths Python never sees. Crash captures never fan
    out to the fleet (the process is dying — spend nothing)."""
    prev_hook = sys.excepthook

    def excepthook(tp, value, tb):
        _crash_capture(
            recorder, "crash.exception",
            f"{getattr(tp, '__name__', tp)}: {value}", tp, value, tb,
        )
        prev_hook(tp, value, tb)

    sys.excepthook = excepthook

    prev_thread_hook = threading.excepthook

    def thread_hook(args):
        if args.exc_type is not SystemExit:
            _crash_capture(
                recorder, "crash.thread_exception",
                f"{args.exc_type.__name__}: {args.exc_value} "
                f"(thread {getattr(args.thread, 'name', '?')})",
                args.exc_type, args.exc_value, args.exc_traceback,
            )
        prev_thread_hook(args)

    threading.excepthook = thread_hook

    if enable_faulthandler and recorder.store is not None:
        import faulthandler

        try:
            # Deliberately leaked: faulthandler holds the fd for the
            # process lifetime — closing it would crash the crash path.
            f = open(  # noqa: SIM115
                os.path.join(recorder.store.directory,
                             "faulthandler.log"), "a",
            )
            faulthandler.enable(f)
        except OSError:
            log.warning("faulthandler file unavailable", exc_info=True)

    # AFTER faulthandler.enable: it installs its own C-level handler
    # for SIGABRT (among others), and for the listed signals the
    # bundle-capturing Python handler must be the one that wins —
    # faulthandler keeps SIGSEGV/SIGBUS/SIGILL, where Python cannot
    # safely run anyway.
    for sig in signals:
        def handler(signum, frame, _sig=sig):
            try:
                name = signal.Signals(signum).name
            except ValueError:
                name = str(signum)
            _crash_capture(recorder, "crash.signal", name, None, None,
                           None)
            signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)

        try:
            signal.signal(sig, handler)
        except (ValueError, OSError):  # non-main thread / exotic signal
            log.warning("could not install crash handler for %s", sig)


def _crash_capture(recorder, trigger, reason, tp, value, tb) -> None:
    try:
        details = None
        if tp is not None:
            details = {"traceback": "".join(
                traceback.format_exception(tp, value, tb)
            )[-16000:]}
        recorder.capture(trigger, reason, details, fleet=False)
    except Exception:  # noqa: BLE001 — the death in progress wins
        log.exception("crash-path incident capture failed")


# --------------------------------------------------------------- routes


def incident_routes(recorder: FlightRecorder) -> dict:
    """Extra GET routes for the metrics endpoint
    (:meth:`~tpu_dist_nn_torch.obs.exposition.MetricsServer.add_routes`):

    * ``/incidents`` — manifest list, newest first (404 with a hint
      when no ``--incident-dir`` store exists);
    * ``/incidents/get?id=`` — one bundle zip;
    * ``/debug/bundle`` — on-demand capture through THIS recorder
      (``?fleet=0|1`` overrides the pool default, ``?persist=1`` also
      saves it to the store; the stock MetricsServer route captures
      process-local state only — mounting this one upgrades a router's
      endpoint to fleet capture).
    """

    def incidents(query: str):
        if recorder.store is None:
            return 404, "application/json", (
                b'{"error": "no incident store (start the serving '
                b'command with --incident-dir)"}\n'
            )
        return 200, "application/json", json.dumps({
            "directory": recorder.store.directory,
            "max_incidents": recorder.store.max_incidents,
            "captured_total": recorder.captured_total,
            "incidents": recorder.store.list(),
        }).encode() + b"\n"

    def incident_get(query: str):
        import urllib.parse

        if recorder.store is None:
            return 404, "application/json", (
                b'{"error": "no incident store (start the serving '
                b'command with --incident-dir)"}\n'
            )
        q = urllib.parse.parse_qs(query)
        iid = (q.get("id") or [None])[0]
        if not iid:
            return 400, "application/json", \
                b'{"error": "id= query parameter required"}\n'
        data = recorder.store.read(iid)
        if data is None:
            return 404, "application/json", json.dumps(
                {"error": f"no incident {iid!r}"}
            ).encode() + b"\n"
        return 200, "application/zip", data

    def debug_bundle(query: str):
        import urllib.parse

        q = urllib.parse.parse_qs(query)
        fleet = None
        raw = (q.get("fleet") or [None])[0]
        if raw is not None:
            fleet = raw not in ("0", "false", "no")
        reason = (q.get("reason") or ["on-demand capture"])[0]
        persist = (q.get("persist") or ["0"])[0] not in ("0", "", "false")
        if persist:
            if recorder.store is None:
                # Silently returning an unpersisted bundle would break
                # the documented ?persist=1 contract; the operator
                # finds out only when `tdn incident ls` is empty.
                return 409, "application/json", (
                    b'{"error": "persist=1 needs an incident store '
                    b'(start the serving command with '
                    b'--incident-dir)"}\n'
                )
            iid, _path = recorder.capture("manual", reason, fleet=fleet)
            data = recorder.store.read(iid)
            if data is None:
                return 500, "application/json", json.dumps({
                    "error": f"bundle {iid} persisted but unreadable",
                }).encode() + b"\n"
        else:
            _iid, data = recorder.bundle("manual", reason, fleet=fleet)
        return 200, "application/zip", data

    return {
        "/incidents": incidents,
        "/incidents/get": incident_get,
        "/debug/bundle": debug_bundle,
    }
