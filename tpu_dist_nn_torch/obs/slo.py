"""SLO tracking: objectives, error budgets, multi-window burn rates.

Port of :mod:`tpu_dist_nn.obs.slo` (the same documents and numbers).

The metrics stack says what the fleet is DOING; nothing says whether
that is GOOD ENOUGH. This module declares service-level objectives
(request latency, availability), evaluates them continuously from the
time-series ring's windowed deltas, and exports the two numbers an
operator actually pages on (Beyer et al., *Site Reliability Workbook*
ch. 5, multi-window multi-burn-rate alerting):

* ``burn_rate{window}`` — the rate the error budget is being consumed,
  normalized so 1.0 means "exactly on track to spend the whole budget
  over the compliance window". A FAST window (default 5 min) catches
  sudden breakage; a SLOW window (default 1 h, also the compliance
  window here) filters blips.
* ``error_budget_remaining`` — the fraction of the slow window's
  budget still unspent; 0 means the objective is blown for the window.

Objectives are fraction-of-bad-events shaped, the form burn rates
need:

* :func:`latency_objective` — "at most (1-q) of requests may take
  longer than T": bad = observations over T (bucket-interpolated from
  the family's histogram deltas), budget fraction = 1-q. The measured
  windowed p-quantile (via the shared
  :func:`~tpu_dist_nn_torch.obs.registry.histogram_quantile`) is reported
  alongside, so "p99 = 212ms against a 100ms objective" reads
  directly.
* :func:`availability_objective` — "at least A of requests must
  succeed": bad = error-family delta (or a label-predicate over the
  total family, e.g. router outcomes != ok), budget fraction = 1-A.

Exports ``tdn_slo_burn_rate{slo,window}`` and
``tdn_slo_error_budget_remaining{slo}`` gauges, serves ``GET /slo``
(obs/exposition.py), and emits a rate-limited ``slo.burn`` structured
event (obs/log.py) while the fast window burns above 1.0. Stdlib-only,
evaluated on the runtime sampler's tick — never on a request path.
"""

from __future__ import annotations

import threading
import time

from tpu_dist_nn_torch.obs.log import get_logger
from tpu_dist_nn_torch.obs.registry import REGISTRY, Registry, histogram_quantile

# Burn alerts are news but not a stream: first couple fire, then one
# per ~30s per objective while the burn persists (suppressed counts
# surface on the next emit, the obs/log contract). The bucket is
# PER OBJECTIVE (each tracker builds one logger per objective via
# _burn_logger) — obs/log keys its bucket on (logger, event), and one
# continuously-burning objective must not starve another's alerts.


def _burn_logger():
    return get_logger(__name__, rate=1.0 / 30.0, burst=2)

DEFAULT_FAST_WINDOW = 300.0
DEFAULT_SLOW_WINDOW = 3600.0


class Objective:
    """One declared objective. ``kind`` is ``latency`` or
    ``availability``; ``budget_fraction`` is the tolerated bad-event
    fraction (1-q, 1-A). Construct through the two factories below."""

    def __init__(self, name: str, kind: str, budget_fraction: float,
                 family: str, match: dict | None = None, *,
                 threshold_s: float | None = None, q: float = 0.99,
                 bad_family: str | None = None,
                 bad_match: dict | None = None,
                 bad_exclude: dict | None = None,
                 description: str = ""):
        if not 0.0 < budget_fraction < 1.0:
            raise ValueError(
                f"{name}: budget fraction must be in (0, 1), got "
                f"{budget_fraction}"
            )
        self.name = name
        self.kind = kind
        self.budget_fraction = float(budget_fraction)
        self.family = family
        self.match = dict(match or {})
        self.threshold_s = threshold_s
        self.q = float(q)
        self.bad_family = bad_family
        self.bad_match = dict(bad_match or {})
        self.bad_exclude = dict(bad_exclude or {})
        self.description = description

    def describe(self) -> dict:
        doc = {
            "name": self.name,
            "kind": self.kind,
            "budget_fraction": self.budget_fraction,
            "family": self.family,
        }
        if self.match:
            doc["match"] = self.match
        if self.kind == "latency":
            doc["objective"] = (
                f"p{self.q * 100:g} <= {self.threshold_s * 1e3:g}ms"
            )
            doc["threshold_ms"] = round(self.threshold_s * 1e3, 3)
            doc["quantile"] = self.q
        else:
            doc["objective"] = f"availability >= {1 - self.budget_fraction}"
            doc["target"] = 1 - self.budget_fraction
        if self.description:
            doc["description"] = self.description
        return doc


def latency_objective(name: str, family: str, threshold_s: float,
                      q: float = 0.99, match: dict | None = None,
                      description: str = "") -> Objective:
    """p<q> of ``family`` (a histogram) must be <= ``threshold_s``;
    equivalently at most 1-q of requests may exceed it."""
    if threshold_s <= 0:
        raise ValueError(f"{name}: threshold must be > 0, got {threshold_s}")
    return Objective(name, "latency", 1.0 - q, family, match,
                     threshold_s=float(threshold_s), q=q,
                     description=description)


def availability_objective(name: str, target: float, total_family: str,
                           bad_family: str | None = None,
                           match: dict | None = None,
                           bad_match: dict | None = None,
                           bad_exclude: dict | None = None,
                           description: str = "") -> Objective:
    """At least ``target`` of ``total_family`` events must be good.
    Bad events come from ``bad_family`` (e.g. the errors counter), or —
    when the total family itself carries the verdict in a label — from
    ``total_family`` filtered by ``bad_match``/``bad_exclude`` (e.g.
    router outcomes with ``bad_exclude={"outcome": "ok"}``)."""
    if bad_family is None and not bad_match and not bad_exclude:
        raise ValueError(
            f"{name}: name the bad events — pass bad_family, or "
            "bad_match/bad_exclude over the total family"
        )
    return Objective(name, "availability", 1.0 - float(target),
                     total_family, match,
                     bad_family=bad_family,
                     bad_match=bad_match, bad_exclude=bad_exclude,
                     description=description)


class SLOTracker:
    """Evaluates objectives from a
    :class:`~tpu_dist_nn_torch.obs.timeseries.TimeSeriesRing` on demand (the
    runtime sampler ticks :meth:`evaluate`), publishes the burn-rate /
    budget gauges, and keeps the last verdict for ``GET /slo``."""

    def __init__(self, ring, objectives, *,
                 fast_window: float = DEFAULT_FAST_WINDOW,
                 slow_window: float = DEFAULT_SLOW_WINDOW,
                 registry: Registry | None = None, logger=None):
        if fast_window <= 0 or slow_window <= 0:
            raise ValueError("SLO windows must be > 0")
        if fast_window > slow_window:
            raise ValueError(
                f"fast window {fast_window} must be <= slow window "
                f"{slow_window}"
            )
        reg = registry if registry is not None else REGISTRY
        self.ring = ring
        self.objectives = list(objectives)
        self.fast_window = float(fast_window)
        self.slow_window = float(slow_window)
        # One logger (= one token bucket) per objective; an injected
        # logger (tests) is shared deliberately.
        self._slogs = {
            obj.name: (logger if logger is not None else _burn_logger())
            for obj in self.objectives
        }
        self._g_burn = reg.gauge(
            "tdn_slo_burn_rate",
            "error-budget burn rate per objective and window (1.0 = "
            "on track to spend the whole budget over the window; "
            "fast > 1 pages, slow > 1 confirms)",
            labels=("slo", "window"),
        )
        self._g_budget = reg.gauge(
            "tdn_slo_error_budget_remaining",
            "fraction of the slow window's error budget still unspent "
            "(0 = objective blown for the window)",
            labels=("slo",),
        )
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._last: dict = {"objectives": [], "evaluated_at": None}

    # ------------------------------------------------------- evaluation

    def _series_keys(self, family: str, suffix: str, match: dict,
                     exclude: dict | None = None) -> list[str]:
        from tpu_dist_nn_torch.obs.exposition import split_series

        keys = []
        want = family + suffix
        for key in self.ring.series(family=family):
            name, labels = split_series(key)
            if name != want:
                continue
            if any(labels.get(k) != str(v) for k, v in match.items()):
                continue
            if exclude and all(
                labels.get(k) == str(v) for k, v in exclude.items()
            ):
                continue
            keys.append(key)
        return keys

    def _window_counts(self, obj: Objective, window: float,
                       now: float | None):
        """-> (bad, total, measured) over the window, from ring deltas."""
        from tpu_dist_nn_torch.obs.exposition import split_series

        if obj.kind == "latency":
            # Per-bucket deltas -> windowed distribution.
            per_edge: dict[float, float] = {}
            for key in self._series_keys(obj.family, "_bucket", obj.match):
                _, labels = split_series(key)
                try:
                    edge = float(labels.get("le", ""))
                except ValueError:
                    continue
                d, _ = self.ring.delta(key, window, now)
                per_edge[edge] = per_edge.get(edge, 0.0) + d
            total_d = sum(
                self.ring.delta(key, window, now)[0]
                for key in self._series_keys(obj.family, "_count", obj.match)
            )
            edges = sorted(per_edge)
            counts = [per_edge[e] for e in edges]
            # +Inf tail: observations past the last finite edge.
            counts.append(max(total_d - sum(counts), 0.0))
            # Bad fraction: observations over the threshold, with
            # linear interpolation inside the containing bucket (the
            # quantile estimator's dual).
            bad = counts[-1]
            lo = 0.0
            for e, n in zip(edges, counts):
                if obj.threshold_s < lo:
                    bad += n
                elif obj.threshold_s < e:
                    frac_over = (e - obj.threshold_s) / (e - lo) if e > lo \
                        else 0.0
                    bad += n * frac_over
                lo = e
            measured = histogram_quantile(edges, counts, obj.q)
            return bad, total_d, measured
        bad = 0.0
        if obj.bad_family is not None:
            for key in self._series_keys(obj.bad_family, "", obj.bad_match):
                bad += self.ring.delta(key, window, now)[0]
        else:
            for key in self._series_keys(obj.family, "", obj.bad_match,
                                         obj.bad_exclude):
                bad += self.ring.delta(key, window, now)[0]
        total = sum(
            self.ring.delta(key, window, now)[0]
            for key in self._series_keys(obj.family, "", obj.match)
        )
        measured = 1.0 - (bad / total) if total > 0 else None
        return bad, total, measured

    def evaluate(self, now: float | None = None) -> dict:
        """One evaluation pass: compute per-objective burn rates over
        both windows, publish the gauges, emit ``slo.burn`` while the
        fast window burns > 1, and return (and cache) the /slo doc."""
        t = time.time() if now is None else float(now)
        out = []
        for obj in self.objectives:
            windows = {}
            for label, window in (("fast", self.fast_window),
                                  ("slow", self.slow_window)):
                bad, total, measured = self._window_counts(obj, window, now)
                bad_frac = (bad / total) if total > 0 else 0.0
                burn = bad_frac / obj.budget_fraction
                self._g_burn.labels(slo=obj.name, window=label).set(burn)
                windows[label] = {
                    "seconds": window,
                    "bad": round(bad, 3),
                    "total": round(total, 3),
                    "bad_fraction": round(bad_frac, 6),
                    "burn_rate": round(burn, 4),
                }
                if obj.kind == "latency":
                    windows[label]["measured_quantile_ms"] = (
                        round(measured * 1e3, 3) if measured is not None
                        else None
                    )
                else:
                    windows[label]["measured_availability"] = (
                        round(measured, 6) if measured is not None else None
                    )
            remaining = max(0.0, 1.0 - windows["slow"]["burn_rate"])
            self._g_budget.labels(slo=obj.name).set(remaining)
            breaching = (windows["fast"]["burn_rate"] > 1.0
                         and windows["fast"]["total"] > 0)
            if breaching:
                self._slogs[obj.name].warning(
                    "slo.burn", slo=obj.name,
                    objective=obj.describe()["objective"],
                    burn_fast=windows["fast"]["burn_rate"],
                    burn_slow=windows["slow"]["burn_rate"],
                    budget_remaining=round(remaining, 4),
                )
            out.append({
                **obj.describe(),
                "windows": windows,
                "error_budget_remaining": round(remaining, 4),
                "burning": breaching,
            })
        doc = {
            "evaluated_at": t,
            "fast_window_seconds": self.fast_window,
            "slow_window_seconds": self.slow_window,
            "objectives": out,
        }
        with self._lock:
            self._last = doc
        return doc

    def status(self) -> dict:
        """The last evaluation (the ``GET /slo`` body); evaluates once
        if nothing has ticked yet so the route is never empty."""
        with self._lock:
            last = self._last
        if last.get("evaluated_at") is None:
            return self.evaluate()
        return last
