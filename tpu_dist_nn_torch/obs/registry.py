"""Process-wide metric registry: Counter, Gauge, Histogram.

Port of :mod:`tpu_dist_nn.obs.registry` with the text rendering of
``tpu_dist_nn.obs.exposition.render`` beside it. The port's
:data:`REGISTRY` is its own, separate from the JAX package's.

Design constraints (the serving/training hot paths publish here):

* **Dependency-free** — stdlib only; the container has no
  prometheus_client and must not grow one.
* **Lock-cheap** — one ``threading.Lock`` per family, held only for a
  dict lookup + float add. No allocation on the repeat-update path:
  ``labels(...)`` returns a cached child whose update methods touch
  pre-bound slots.
* **Host-side only** — values are python floats; updating a metric
  never touches a device tensor (a device sync on the batcher
  thread would serialize the launch pipeline).

Get-or-create semantics: asking the registry for an existing family
name returns the SAME family (so module-level instrumentation in
server/engine/trainer modules converges on one set of series), and
asking with a conflicting kind or label schema raises — a typo must
not silently fork a second family.
"""

from __future__ import annotations

import bisect
import math
import re
import threading

# Latency-shaped default: sub-ms serving spans up to multi-second
# compile/step outliers. "+Inf" is implicit (rendered by exposition).
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

# Row-count-shaped buckets: the batcher pads coalesced batches to
# powers of two, so bucket edges ON the powers make the histogram an
# exact per-bucket launch count.
POW2_BUCKETS = tuple(float(1 << i) for i in range(17))  # 1 .. 65536


def histogram_quantile(buckets, counts, q: float) -> float | None:
    """Prometheus-style quantile estimate from bucketed counts.

    ``buckets`` are the finite upper edges, ``counts`` the PER-BUCKET
    (not cumulative) observation counts with one extra entry for the
    implicit +Inf bucket — exactly a ``_Child``'s ``counts`` layout, and
    what scrape-side cumulative ``le`` series differentiate back to.

    Linear interpolation inside the containing bucket (lower edge 0 for
    the first bucket — these are latency/row-count shaped families, all
    non-negative); an estimate landing in the +Inf bucket clamps to the
    highest finite edge, same as ``histogram_quantile()`` in PromQL.
    Returns None when the histogram is empty.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    for i, n in enumerate(counts):
        if n <= 0:
            continue
        if cum + n >= rank:
            if i >= len(buckets):  # +Inf bucket: clamp to top edge
                return float(buckets[-1]) if buckets else 0.0
            lo = float(buckets[i - 1]) if i > 0 else 0.0
            hi = float(buckets[i])
            frac = (rank - cum) / n
            return lo + (hi - lo) * max(0.0, min(1.0, frac))
        cum += n
    return float(buckets[-1]) if buckets else 0.0


class _Child:
    """One labeled series. Value semantics depend on the family kind."""

    __slots__ = ("kind", "value", "sum", "counts", "_buckets", "_lock")

    def __init__(self, kind, buckets, lock):
        self.kind = kind
        self.value = 0.0  # guarded-by: _lock
        self.sum = 0.0  # guarded-by: _lock
        self._buckets = buckets
        self._lock = lock
        # guarded-by: _lock
        self.counts = [0] * (len(buckets) + 1) if buckets is not None else None

    def _expect(self, *kinds) -> None:
        if self.kind not in kinds:
            raise ValueError(f"operation not valid for a {self.kind}")

    # -- counter / gauge ------------------------------------------------
    def inc(self, amount: float = 1.0) -> None:
        self._expect("counter", "gauge")
        if self.kind == "counter" and amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self._expect("gauge")
        with self._lock:
            self.value -= amount

    def set(self, value: float) -> None:
        self._expect("gauge")
        with self._lock:
            self.value = float(value)

    # -- histogram ------------------------------------------------------
    def observe(self, value: float) -> None:
        self._expect("histogram")
        v = float(value)
        i = bisect.bisect_left(self._buckets, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.value += 1  # total count

    def quantile(self, q: float) -> float | None:
        """Bucket-interpolated quantile estimate of everything this
        series has observed (None while empty); the error bound is the
        containing bucket's width — see :func:`histogram_quantile`."""
        self._expect("histogram")
        with self._lock:
            counts = list(self.counts)
        return histogram_quantile(self._buckets, counts, q)


class Metric:
    """One metric family: a name, a kind, a label schema, N children."""

    def __init__(self, name: str, help: str, kind: str,
                 labelnames: tuple = (), buckets=None):
        _validate_name(name)
        for ln in labelnames:
            _validate_name(ln)
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets) if buckets is not None else None
        if kind == "histogram" and self.buckets is None:
            self.buckets = DEFAULT_BUCKETS
        if self.buckets is not None and list(self.buckets) != sorted(
            set(self.buckets)
        ):
            raise ValueError(
                f"{name}: buckets must be strictly increasing, got "
                f"{self.buckets}"
            )
        self._lock = threading.Lock()
        self._children: dict[tuple, _Child] = {}  # guarded-by: _lock
        if not self.labelnames:
            # Unlabeled families materialize at 0 immediately: an
            # error-class counter born at its first increment is
            # invisible to rate()/increase() alerts for exactly the
            # event that mattered (labeled children stay lazy — the
            # label space is open-ended).
            self._children[()] = _Child(self.kind, self.buckets, self._lock)

    def labels(self, **labels) -> _Child:
        """The child series for this label-value assignment (cached)."""
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{tuple(labels)}"
            )
        key = tuple(str(labels[ln]) for ln in self.labelnames)
        # Lock-free fast path for the repeat-update case (benign race:
        # a miss falls through to the locked setdefault, which
        # arbitrates; dict reads are atomic under the GIL).
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(
                    key, _Child(self.kind, self.buckets, self._lock)
                )
        return child

    def remove(self, **labels) -> None:
        """Drop one child series (a label value that has left the
        system): without this the label set only grows, and the dead
        series keeps exposing its last value. No-op when the child never
        existed."""
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{tuple(labels)}"
            )
        key = tuple(str(labels[ln]) for ln in self.labelnames)
        with self._lock:
            self._children.pop(key, None)

    def remove_matching(self, **labels) -> None:
        """Drop every child series whose values match the given SUBSET
        of labels, where :meth:`remove` needs the full label set."""
        unknown = set(labels) - set(self.labelnames)
        if unknown:
            raise ValueError(
                f"{self.name}: unknown labels {tuple(sorted(unknown))}; "
                f"has {self.labelnames}"
            )
        idx = {ln: i for i, ln in enumerate(self.labelnames)}
        want = {idx[ln]: str(v) for ln, v in labels.items()}
        with self._lock:
            for key in [k for k in self._children
                        if all(k[i] == v for i, v in want.items())]:
                self._children.pop(key, None)

    # Unlabeled convenience: metric.inc() == metric.labels().inc().
    def _default(self) -> _Child:
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; use "
                ".labels(...)"
            )
        return self.labels()

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def set(self, value: float) -> None:
        self._default().set(value)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def quantile(self, q: float, **labels) -> float | None:
        """Quantile estimate for one labeled series (the unlabeled one
        when no labels are given) — does NOT create the child, so
        probing a series that never observed returns None instead of
        materializing an empty one."""
        if self.kind != "histogram":
            raise ValueError(f"quantile() not valid for a {self.kind}")
        key = tuple(str(labels.get(ln)) for ln in self.labelnames)
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{tuple(labels)}"
            )
        with self._lock:
            child = self._children.get(key)
        return child.quantile(q) if child is not None else None

    def samples(self):
        """-> [(label_values_tuple, child)] snapshot for exposition."""
        with self._lock:
            return list(self._children.items())


def _validate_name(name: str) -> None:
    if not re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*", name):
        raise ValueError(f"invalid metric/label name: {name!r}")


class Registry:
    """Name -> Metric map with get-or-create family factories."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}  # guarded-by: _lock

    def _get_or_create(self, name, help, kind, labelnames, buckets=None):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if existing.kind != kind or existing.labelnames != tuple(
                    labelnames
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{existing.labelnames}; requested "
                        f"{kind}{tuple(labelnames)}"
                    )
                if buckets is not None and tuple(buckets) != existing.buckets:
                    # Silently keeping the first schema would bucket the
                    # caller's observations on edges it never asked for.
                    raise ValueError(
                        f"metric {name!r} already registered with buckets "
                        f"{existing.buckets}; requested {tuple(buckets)}"
                    )
                return existing
            m = Metric(name, help, kind, labelnames, buckets)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "", labels: tuple = ()) -> Metric:
        return self._get_or_create(name, help, "counter", labels)

    def gauge(self, name: str, help: str = "", labels: tuple = ()) -> Metric:
        return self._get_or_create(name, help, "gauge", labels)

    def histogram(self, name: str, help: str = "", labels: tuple = (),
                  buckets=None) -> Metric:
        return self._get_or_create(name, help, "histogram", labels, buckets)

    def get(self, name: str) -> Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> list[Metric]:
        with self._lock:
            return list(self._metrics.values())

    def reset(self) -> None:
        """Drop every family (test isolation only: callers holding a
        Metric reference would silently detach)."""
        with self._lock:
            self._metrics.clear()


# The process-wide registry every instrumentation site of the port
# publishes into and :func:`render` renders.
REGISTRY = Registry()


def bridge_latency_stats(stats, name: str | None = None,
                         registry: Registry | None = None,
                         buckets=None, **labels):
    """Teach an existing :class:`~tpu_dist_nn_torch.utils.profiling.LatencyStats`
    to ALSO feed a registry histogram: its callers (``summary()``,
    ``percentile()``) keep working, and every span it records from now
    on lands in ``{name}`` (default ``tdn_<stats.name>_seconds``).
    Returns ``stats``."""
    reg = registry if registry is not None else REGISTRY
    metric = reg.histogram(
        name or f"tdn_{stats.name}_seconds",
        f"bridged from LatencyStats({stats.name!r})",
        labels=tuple(labels),
        buckets=buckets,
    )
    child = metric.labels(**labels) if labels else metric.labels()
    inner = stats.record

    def record(seconds: float) -> None:
        inner(seconds)
        child.observe(seconds)

    stats.record = record
    return stats


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(value: str) -> str:
    return value.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _fmt(v: float) -> str:
    # Integral values print bare (the common counter case); floats keep
    # repr fidelity so scrape->parse round-trips exactly; non-finite
    # values use the text format's literals.
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _labelstr(names, values) -> str:
    if not names:
        return ""
    return "{" + ",".join(f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)) + "}"


def render(registry: Registry | None = None) -> str:
    """The whole registry in Prometheus text format 0.0.4 (histograms as
    cumulative ``le`` buckets, then ``_sum`` and ``_count``)."""
    reg = registry if registry is not None else REGISTRY
    out = []
    for m in reg.collect():
        samples = m.samples()
        if not samples:
            continue
        if m.help:
            out.append(f"# HELP {m.name} {_escape_help(m.help)}")
        out.append(f"# TYPE {m.name} {m.kind}")
        for values, child in samples:
            if m.kind != "histogram":
                out.append(f"{m.name}{_labelstr(m.labelnames, values)} {_fmt(child.value)}")
                continue
            cum = 0
            for edge, n in zip(m.buckets, child.counts):
                cum += n
                out.append(f"{m.name}_bucket"
                           + _labelstr(m.labelnames + ("le",), values + (_fmt(edge),))
                           + f" {cum}")
            total = cum + child.counts[-1]
            out.append(f"{m.name}_bucket"
                       + _labelstr(m.labelnames + ("le",), values + ("+Inf",)) + f" {total}")
            ls = _labelstr(m.labelnames, values)
            out.append(f"{m.name}_sum{ls} {_fmt(child.sum)}")
            out.append(f"{m.name}_count{ls} {total}")
    return "\n".join(out) + ("\n" if out else "")
