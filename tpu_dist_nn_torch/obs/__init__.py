"""Observability for the port: the metric registry and the plane that
serves it.

Counterparts of :mod:`tpu_dist_nn.obs`, kept as the port's own copies
(these modules import the standard library; the device-memory sampler
and the profiler captures import torch when they run):

  - :mod:`~tpu_dist_nn_torch.obs.registry` — ``Counter`` / ``Gauge`` /
    ``Histogram`` families behind one process-wide ``REGISTRY``, the
    text rendering, and the ``LatencyStats`` bridge.
  - :mod:`~tpu_dist_nn_torch.obs.exposition` — the stdlib HTTP endpoint
    (``--metrics-port``): ``/metrics``, ``/healthz``, ``/trace``,
    ``/logs``, ``/timeseries``, ``/slo``, ``/goodput``, ``/profile``,
    ``/debug/profile`` (a ``torch.profiler`` Chrome trace in a zip) and
    ``/debug/bundle``.
  - :mod:`~tpu_dist_nn_torch.obs.runtime` — the background sampler
    (queue depth, in-flight rows, slots, host RSS, per-card memory from
    the caching allocator).
  - :mod:`~tpu_dist_nn_torch.obs.trace` — request-scoped spans, the
    ``x-tdn-trace`` header, Chrome trace export.
  - :mod:`~tpu_dist_nn_torch.obs.profile` — spans folded into per-stage
    self time (``GET /profile``).
  - :mod:`~tpu_dist_nn_torch.obs.log` — structured, rate-limited
    records, the JSON formatter (``--log-json``) and the log ring.
  - :mod:`~tpu_dist_nn_torch.obs.timeseries` — the bounded history ring.
  - :mod:`~tpu_dist_nn_torch.obs.slo` — objectives, burn rates, error
    budgets.
  - :mod:`~tpu_dist_nn_torch.obs.goodput` — useful and pad FLOPs, MFU.
  - :mod:`~tpu_dist_nn_torch.obs.incident` — the flight recorder.

Every family is prefixed ``tdn_``, with the JAX package's names and
labels, so a scraper cannot tell the two endpoints apart but for the
device names (``cuda:0`` where the JAX package has ``tpu:0``).
"""

from tpu_dist_nn_torch.obs.registry import (  # noqa: F401
    REGISTRY,
    Registry,
    bridge_latency_stats,
    histogram_quantile,
)
from tpu_dist_nn_torch.obs.exposition import (  # noqa: F401
    MetricsServer,
    parse_prometheus_text,
    parsed_histogram_quantile,
    render,
    split_series,
    start_http_server,
)
from tpu_dist_nn_torch.obs.timeseries import TimeSeriesRing  # noqa: F401
from tpu_dist_nn_torch.obs.slo import (  # noqa: F401
    SLOTracker,
    availability_objective,
    latency_objective,
)
from tpu_dist_nn_torch.obs.runtime import RuntimeSampler  # noqa: F401
from tpu_dist_nn_torch.obs.trace import (  # noqa: F401
    SpanContext,
    TRACE_HEADER,
    TRACER,
    Tracer,
)
from tpu_dist_nn_torch.obs.profile import (  # noqa: F401
    format_profile_table,
    profile_snapshot,
)
from tpu_dist_nn_torch.obs.log import (  # noqa: F401
    LOG_RING,
    JsonFormatter,
    LogRing,
    get_logger,
    setup_json_logging,
)
from tpu_dist_nn_torch.obs.goodput import (  # noqa: F401
    GOODPUT,
    GoodputTracker,
    LMFlopModel,
    fcnn_flops_per_row,
)
from tpu_dist_nn_torch.obs.incident import (  # noqa: F401
    FlightRecorder,
    IncidentStore,
    capture_bundle,
    default_detectors,
    incident_routes,
    install_crash_hook,
)

__all__ = [
    "REGISTRY",
    "Registry",
    "bridge_latency_stats",
    "histogram_quantile",
    "MetricsServer",
    "parse_prometheus_text",
    "parsed_histogram_quantile",
    "render",
    "split_series",
    "start_http_server",
    "RuntimeSampler",
    "TimeSeriesRing",
    "SLOTracker",
    "latency_objective",
    "availability_objective",
    "SpanContext",
    "TRACE_HEADER",
    "TRACER",
    "Tracer",
    "profile_snapshot",
    "format_profile_table",
    "get_logger",
    "setup_json_logging",
    "JsonFormatter",
    "LogRing",
    "LOG_RING",
    "GOODPUT",
    "GoodputTracker",
    "LMFlopModel",
    "fcnn_flops_per_row",
    "FlightRecorder",
    "IncidentStore",
    "capture_bundle",
    "default_detectors",
    "incident_routes",
    "install_crash_hook",
]
