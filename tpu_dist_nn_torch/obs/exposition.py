"""Prometheus text-format exposition + the stdlib /metrics endpoint.

Port of :mod:`tpu_dist_nn.obs.exposition`: the same routes, status
codes and JSON documents. Serves the process registry in text format
0.0.4 (the format every scraper speaks;
:func:`~tpu_dist_nn_torch.obs.registry.render`) from a ``http.server``
daemon thread —
no web framework, no asyncio, startable NEXT TO the gRPC server on a
second port (``tdn up --grpc-port 5101 --metrics-port 9100``).

``/healthz`` mirrors :meth:`tpu_dist_nn_torch.api.engine.Engine.health`
(structured readiness, the reference's TCP poll as JSON): HTTP 200
when ``ready``, 503 when not — so the same probe a human curls is the
one a load balancer gates on.

``/profile`` serves the per-stage self-time breakdown
(:func:`tpu_dist_nn_torch.obs.profile.profile_snapshot`); ``/debug/profile``
runs an on-demand ``torch.profiler`` capture (CPU activity, plus CUDA
kernels when the process has a card) and returns its Chrome trace in a
zip (a JSON 503 when the profiler cannot start), where the JAX package
returns a ``jax.profiler`` TensorBoard directory.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

# render lives beside the registry in the port; re-exported here, where
# the JAX package defines it.
from tpu_dist_nn_torch.obs.registry import REGISTRY, Registry, render  # noqa: F401

log = logging.getLogger(__name__)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def parse_prometheus_text(text: str) -> dict:
    """Text format -> ``{series_name_with_labels: float}`` (plus
    ``__type__:<name>`` entries). The inverse of :func:`render` for the
    ``tdn metrics`` pretty-printer and tests — not a general parser,
    but it round-trips everything render emits."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            out[f"__type__:{name}"] = kind
            continue
        if line.startswith("#"):
            continue
        series, _, value = line.rpartition(" ")
        try:
            out[series] = float(value)
        except ValueError:
            continue
    return out


def split_series(series: str) -> tuple[str, dict[str, str]]:
    """``'name{a="x",b="y"}'`` -> ``("name", {"a": "x", "b": "y"})`` —
    the inverse of :func:`render`'s label formatting, for consumers of
    :func:`parse_prometheus_text` keys (the SLO evaluator's label
    matching, ``tdn top``'s per-replica views). Handles the escaping
    render emits; a malformed tail degrades to no labels rather than
    raising mid-scrape."""
    name, brace, rest = series.partition("{")
    if not brace or not rest.endswith("}"):
        return series, {}
    labels: dict[str, str] = {}
    body = rest[:-1]
    i = 0
    while i < len(body):
        eq = body.find('="', i)
        if eq < 0:
            break
        key = body[i:eq]
        j = eq + 2
        val: list[str] = []
        while j < len(body):
            c = body[j]
            if c == "\\" and j + 1 < len(body):
                nxt = body[j + 1]
                val.append({"n": "\n"}.get(nxt, nxt))
                j += 2
                continue
            if c == '"':
                break
            val.append(c)
            j += 1
        labels[key] = "".join(val)
        i = j + 1
        if i < len(body) and body[i] == ",":
            i += 1
    return name, labels


def parsed_histogram_quantile(parsed: dict, family: str, q: float,
                              **labels) -> float | None:
    """Quantile estimate for one histogram family out of a
    :func:`parse_prometheus_text` scrape — the SCRAPE-SIDE twin of
    ``Histogram.quantile`` (same interpolation, via the shared
    :func:`~tpu_dist_nn_torch.obs.registry.histogram_quantile`), so ``tdn
    top`` and fleet SLO views estimate exactly what the serving process
    itself would. ``labels`` is a SUBSET constraint; series matching it
    are summed bucket-wise first (e.g. all ``method`` series when no
    method is pinned). Returns None when no matching buckets exist."""
    from tpu_dist_nn_torch.obs.registry import histogram_quantile

    prefix = family + "_bucket"
    cum: dict[float, float] = {}
    inf = 0.0
    for series, value in parsed.items():
        s = str(series)
        if not s.startswith(prefix):
            continue
        name, lbl = split_series(s)
        if name != prefix or "le" not in lbl:
            continue
        if any(lbl.get(k) != str(v) for k, v in labels.items()):
            continue
        if lbl["le"] == "+Inf":
            inf += float(value)
        else:
            try:
                edge = float(lbl["le"])
            except ValueError:
                continue
            cum[edge] = cum.get(edge, 0.0) + float(value)
    if not cum and inf <= 0:
        return None
    edges = sorted(cum)
    # Cumulative le-series -> per-bucket counts (+Inf tail last).
    counts = []
    prev = 0.0
    for e in edges:
        counts.append(max(cum[e] - prev, 0.0))
        prev = cum[e]
    counts.append(max(inf - prev, 0.0))
    return histogram_quantile(edges, counts, q)


class MetricsServer:
    """The /metrics + /healthz + /trace + /profile + /timeseries +
    /slo + /goodput + /logs + /debug/bundle endpoint on a daemon
    thread.

    ``GET /goodput`` serves the attached
    :class:`~tpu_dist_nn_torch.obs.goodput.GoodputTracker`'s per-stage
    useful/pad FLOP breakdown (404 with a hint until attached).

    ``GET /logs?window=S&level=L&limit=N`` serves the process log ring
    (:data:`tpu_dist_nn_torch.obs.log.LOG_RING`); ``GET /debug/bundle``
    captures an on-demand diagnostic bundle zip (trace ring, profile,
    timeseries window, SLO state, log ring, /metrics text + manifest —
    :mod:`tpu_dist_nn_torch.obs.incident`).

    ``health_fn`` is polled per /healthz request (``Engine.health`` in
    the serving wiring); omit it for processes with no engine — the
    endpoint then reports ``{"ready": true}`` for liveness.

    ``GET /trace?limit=N&trace_id=ID`` exports the process tracer's
    completed spans (plus its slowest-trace exemplars) as Chrome
    trace-event JSON — save the body and open it in Perfetto /
    ``chrome://tracing``, or let ``tdn trace`` do both; ``trace_id``
    pulls ONE trace (a slow exemplar named by a log line or trailing
    metadata) without dumping the whole ring. ``tracer`` overrides the
    process-wide :data:`tpu_dist_nn_torch.obs.trace.TRACER` (tests).

    ``GET /timeseries?family=F&window=S`` serves the attached
    :class:`~tpu_dist_nn_torch.obs.timeseries.TimeSeriesRing`'s recent
    samples; ``GET /slo`` the attached
    :class:`~tpu_dist_nn_torch.obs.slo.SLOTracker`'s objective/burn-rate
    status. Both 404 with a JSON reason until :meth:`attach` wires the
    sources in (the endpoint binds BEFORE the sampler exists on the
    serving bring-up path).

    ``GET /profile?window=S&top=N`` serves the per-stage self-time
    breakdown over the same tracer (``tdn profile`` pretty-prints it).
    ``GET /debug/profile?seconds=N`` captures a ``torch.profiler``
    trace for N seconds and returns its Chrome trace as one zip body;
    one capture at a time (409 while busy), 503 with a JSON error where
    the profiler cannot start.
    """

    # On-demand device captures are bounded: a typo'd ?seconds= must
    # not pin the profiler (and its buffer growth) for an hour.
    MAX_CAPTURE_SECONDS = 60.0

    def __init__(self, port: int = 0, host: str = "0.0.0.0", *,
                 registry: Registry | None = None, health_fn=None,
                 tracer=None, routes=None, timeseries=None, slo=None,
                 goodput=None, post_routes=None):
        reg = registry if registry is not None else REGISTRY
        outer = self
        # Extra GET routes, ``{path: fn(query) -> (status, content_type,
        # body_bytes)}`` — the admin seam (the router mounts its
        # /router/* drain + fleet-introspection paths here). A raising
        # route degrades to a JSON 500, never a handler traceback.
        # ``post_routes`` is the same shape for state-CHANGING admin
        # verbs (the router's /router/scale manual override): a scraper
        # sweeping every GET path must not be able to actuate the fleet.
        self._routes = dict(routes or {})
        self._post_routes = dict(post_routes or {})

        class Handler(BaseHTTPRequestHandler):
            def _run_route(self, fn, query):
                try:
                    return fn(query)
                except Exception as e:  # noqa: BLE001 — degrade
                    log.warning("route %s failed: %r", self.path, e)
                    return (
                        500, "application/json",
                        json.dumps({"error": repr(e)}).encode() + b"\n",
                    )

            def do_POST(self):  # noqa: N802 — http.server API
                path, _, query = self.path.partition("?")
                # Any request body is drained (keep-alive hygiene) but
                # unused: the admin verbs are query-parameter shaped.
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    self.rfile.read(length)
                if path in outer._post_routes:
                    status, ctype, body = self._run_route(
                        outer._post_routes[path], query
                    )
                    self._reply(status, ctype, body)
                elif path in outer._routes:
                    self._reply(405, "application/json",
                                b'{"error": "use GET for this path"}\n')
                else:
                    self._reply(404, "text/plain", b"not found\n")

            def do_GET(self):  # noqa: N802 — http.server API
                path, _, query = self.path.partition("?")
                if path in outer._post_routes and path not in outer._routes:
                    self._reply(405, "application/json",
                                b'{"error": "use POST for this path"}\n')
                    return
                if path in outer._routes:
                    status, ctype, body = self._run_route(
                        outer._routes[path], query
                    )
                    self._reply(status, ctype, body)
                elif path == "/metrics":
                    body = render(reg).encode()
                    self._reply(200, CONTENT_TYPE, body)
                elif path == "/healthz":
                    status, body = outer._health_body()
                    self._reply(status, "application/json", body)
                elif path == "/trace":
                    status, body = outer._trace_body(query)
                    self._reply(status, "application/json", body)
                elif path == "/logs":
                    status, body = outer._logs_body(query)
                    self._reply(status, "application/json", body)
                elif path == "/debug/bundle":
                    status, ctype, body = outer._debug_bundle_body(query)
                    self._reply(status, ctype, body)
                elif path == "/profile":
                    status, body = outer._profile_body(query)
                    self._reply(status, "application/json", body)
                elif path == "/timeseries":
                    status, body = outer._timeseries_body(query)
                    self._reply(status, "application/json", body)
                elif path == "/slo":
                    status, body = outer._slo_body(query)
                    self._reply(status, "application/json", body)
                elif path == "/goodput":
                    status, body = outer._goodput_body(query)
                    self._reply(status, "application/json", body)
                elif path == "/debug/profile":
                    status, ctype, body = outer._debug_profile_body(query)
                    self._reply(status, ctype, body)
                else:
                    self._reply(404, "text/plain", b"not found\n")

            def _reply(self, status, ctype, body):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # scrapes are not news
                log.debug("metrics http: " + fmt, *args)

        self._registry = reg
        self._health_fn = health_fn
        self._tracer = tracer
        self._timeseries = timeseries
        self._slo = slo
        self._goodput = goodput
        # One device capture at a time: the profiler (CUPTI on a card)
        # is process-global — a second concurrent start raises deep
        # inside the profiler instead of returning a clean 409.
        self._capture_lock = threading.Lock()
        self._closed = False
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="tdn-metrics-http",
            daemon=True,
        )
        self._thread.start()
        log.info("metrics endpoint on :%d (/metrics, /healthz)", self.port)

    def _health_body(self):
        if self._health_fn is None:
            return 200, b'{"ready": true}\n'
        try:
            health = self._health_fn()
        except Exception as e:  # noqa: BLE001 — a failing probe IS the report
            return 503, json.dumps(
                {"ready": False, "error": repr(e)}
            ).encode() + b"\n"
        status = 200 if health.get("ready") else 503
        return status, json.dumps(health).encode() + b"\n"

    def _resolve_tracer(self):
        if self._tracer is not None:
            return self._tracer
        from tpu_dist_nn_torch.obs.trace import TRACER

        return TRACER

    def attach(self, *, timeseries=None, slo=None, goodput=None) -> None:
        """Late-bind the /timeseries ring, /slo tracker, and /goodput
        tracker: the serving bring-up binds this endpoint BEFORE the
        sampler (and the ring it feeds) exists, so the routes 404 until
        attachment instead of holding the port hostage to construction
        order."""
        if timeseries is not None:
            self._timeseries = timeseries
        if slo is not None:
            self._slo = slo
        if goodput is not None:
            self._goodput = goodput

    def add_routes(self, routes: dict) -> None:
        """Late-mount extra GET routes (same shape as ``routes=``):
        the incident recorder's ``/incidents`` + fleet
        ``/debug/bundle`` bind here AFTER the serving bring-up built
        the recorder — the same construction-order seam as
        :meth:`attach`. Later mounts win (a router's fleet-capturing
        ``/debug/bundle`` overrides the built-in local one)."""
        self._routes.update(routes)

    def add_post_routes(self, routes: dict) -> None:
        """Late-mount extra POST routes (same shape as ``post_routes=``):
        the router's ``/router/scale`` manual-override verb binds here
        once the autoscaler exists."""
        self._post_routes.update(routes)

    def _trace_body(self, query: str):
        tracer = self._resolve_tracer()
        limit = None
        trace_id = None
        since = None
        for part in query.split("&"):
            k, _, v = part.partition("=")
            if k == "limit" and v:
                try:
                    limit = int(v)
                except ValueError:
                    return 400, b'{"error": "limit must be an integer"}\n'
            elif k == "trace_id" and v:
                trace_id = v
            elif k == "since" and v:
                # Monotonic cursor: only spans recorded AFTER sequence
                # number N (the previous reply's "cursor"), so a poller
                # stops re-downloading the whole ring every tick.
                try:
                    since = int(v)
                except ValueError:
                    return 400, b'{"error": "since must be an integer"}\n'
        return 200, tracer.render_json(
            limit, trace_id=trace_id, since=since
        ).encode() + b"\n"

    def _logs_body(self, query: str):
        from tpu_dist_nn_torch.obs.log import LOG_RING

        window = None
        level = None
        limit = None
        for part in query.split("&"):
            k, _, v = part.partition("=")
            if not v:
                continue
            try:
                if k == "window":
                    window = float(v)
                elif k == "limit":
                    limit = int(v)
                elif k == "level":
                    level = v
            except ValueError:
                return 400, (b'{"error": "window must be a number of '
                             b'seconds, limit an integer"}\n')
        try:
            records = LOG_RING.snapshot(window=window, level=level,
                                        limit=limit)
        except ValueError as e:
            return 400, json.dumps({"error": str(e)}).encode() + b"\n"
        return 200, json.dumps({
            "capacity": LOG_RING.capacity,
            "dropped_total": LOG_RING.dropped_total,
            "records": records,
        }, default=repr).encode() + b"\n"

    def _debug_bundle_body(self, query: str):
        """Process-local on-demand diagnostic bundle: the stock route
        every ``--metrics-port`` endpoint serves (a router's recorder
        overrides it via :meth:`add_routes` with the fleet version).
        Captures whatever is attached to THIS endpoint — tracer,
        timeseries ring, SLO tracker, the log ring, /metrics text."""
        import urllib.parse

        from tpu_dist_nn_torch.obs.incident import capture_bundle

        q = urllib.parse.parse_qs(query)
        reason = (q.get("reason") or ["on-demand capture"])[0]
        try:
            _iid, data = capture_bundle(
                "manual", reason,
                tracer=self._resolve_tracer(), registry=self._registry,
                ring=self._timeseries, slo=self._slo,
            )
        except Exception as e:  # noqa: BLE001 — degrade, never traceback
            log.warning("debug bundle capture failed: %r", e)
            return (500, "application/json", json.dumps(
                {"error": repr(e)}
            ).encode() + b"\n")
        return 200, "application/zip", data

    def _timeseries_body(self, query: str):
        ring = self._timeseries
        if ring is None:
            return 404, (b'{"error": "no time-series ring attached '
                         b'(start a serving command with '
                         b'--metrics-port)"}\n')
        family = None
        window = None
        for part in query.split("&"):
            k, _, v = part.partition("=")
            if not v:
                continue
            if k == "family":
                family = v
            elif k == "window":
                try:
                    window = float(v)
                except ValueError:
                    return 400, (b'{"error": "window must be a number '
                                 b'of seconds"}\n')
        doc = {
            "resolution_seconds": ring.resolution,
            "retention_seconds": ring.retention,
            "families": ring.families(),
            "series": ring.series(family=family, window=window),
        }
        return 200, json.dumps(doc).encode() + b"\n"

    def _slo_body(self, query: str):
        tracker = self._slo
        if tracker is None:
            return 404, (b'{"error": "no SLO tracker attached (pass '
                         b'--slo-latency-p99-ms / --slo-availability '
                         b'on the serving command)"}\n')
        return 200, json.dumps(tracker.status()).encode() + b"\n"

    def _goodput_body(self, query: str):
        tracker = self._goodput
        if tracker is None:
            return 404, (b'{"error": "no goodput tracker attached '
                         b'(start a serving command with '
                         b'--metrics-port)"}\n')
        return 200, json.dumps(tracker.snapshot()).encode() + b"\n"

    def _profile_body(self, query: str):
        from tpu_dist_nn_torch.obs.profile import profile_snapshot

        window = None
        top = 5
        for part in query.split("&"):
            k, _, v = part.partition("=")
            if not v:
                continue
            try:
                if k == "window":
                    window = float(v)
                elif k == "top":
                    top = int(v)
            except ValueError:
                return 400, (
                    b'{"error": "window must be a number of seconds, '
                    b'top an integer"}\n'
                )
        doc = profile_snapshot(self._resolve_tracer(), window=window, top=top)
        return 200, json.dumps(doc).encode() + b"\n"

    def _debug_profile_body(self, query: str):
        """On-demand capture: run a ``torch.profiler`` session for
        ``?seconds=N`` (default 2, capped) and return its Chrome trace
        as one zip body (``trace.json``). Every failure mode is a JSON
        status, never a handler traceback: a profiler that cannot start
        503, a concurrent capture 409."""
        seconds = 2.0
        for part in query.split("&"):
            k, _, v = part.partition("=")
            if k == "seconds" and v:
                try:
                    seconds = float(v)
                except ValueError:
                    return (400, "application/json",
                            b'{"error": "seconds must be a number"}\n')
        if not 0 < seconds <= self.MAX_CAPTURE_SECONDS:
            return (400, "application/json", json.dumps({
                "error": f"seconds must be in (0, "
                         f"{self.MAX_CAPTURE_SECONDS:g}]",
            }).encode() + b"\n")
        if not self._capture_lock.acquire(blocking=False):
            return (409, "application/json",
                    b'{"error": "a device capture is already running"}\n')
        try:
            import io
            import zipfile

            from tpu_dist_nn_torch.utils.profiling import capture_chrome_trace

            # The capture window: whatever the serving / training
            # threads launch during it lands in the trace.
            trace = capture_chrome_trace(lambda: time.sleep(seconds))
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
                z.writestr("trace.json", trace)
            return 200, "application/zip", buf.getvalue()
        except Exception as e:  # noqa: BLE001 — degrade, never traceback
            log.warning("device profile capture failed: %r", e)
            return (503, "application/json", json.dumps({
                "error": f"device profiler unavailable: {e!r}",
            }).encode() + b"\n")
        finally:
            self._capture_lock.release()

    def close(self) -> None:
        """Idempotent — a second close is a no-op, not a hang (stdlib
        shutdown() blocks forever if serve_forever already exited)."""
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def start_http_server(port: int = 0, host: str = "0.0.0.0", *,
                      registry: Registry | None = None,
                      health_fn=None, routes=None, timeseries=None,
                      slo=None, goodput=None,
                      post_routes=None) -> MetricsServer:
    """Start the /metrics endpoint; returns the server (``.port`` holds
    the bound port when ``port=0`` picked an ephemeral one). ``routes``
    mounts extra GET paths and ``post_routes`` extra POST paths (see
    :class:`MetricsServer`); ``timeseries``/``slo``/``goodput``
    pre-attach the /timeseries, /slo, and /goodput sources (or
    late-bind them with :meth:`MetricsServer.attach`)."""
    return MetricsServer(port, host, registry=registry, health_fn=health_fn,
                         routes=routes, timeseries=timeseries, slo=slo,
                         goodput=goodput, post_routes=post_routes)
