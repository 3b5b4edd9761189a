"""Performance attribution: spans -> per-stage SELF-time breakdown.

Port of :mod:`tpu_dist_nn.obs.profile` (the same documents and numbers).

The tracer (obs/trace.py) answers "where did THIS request go"; nothing
answered "where does the time go in AGGREGATE" — the question the bench
trajectory raises (host-fed throughput decaying while device-resident
holds: which stage is eating it?). This module folds the tracer's
completed spans into a rolling per-stage profile:

* **Self time, not inclusive time.** A span's self time is the part of
  its duration no deeper span covers — so a slow ``fetch`` no longer
  inflates its ``rpc.Process`` parent's row, and the shares of one
  request's stages sum to its root wall time instead of
  double-counting every level of the tree.
* **Innermost-cover sweep, not parent links.** The serving pipeline
  records spans that are *siblings by parent id* but *nested in time*
  (every ``decode.step`` hangs off the handler span but runs inside
  the request's ``decode`` phase span), and siblings that PARTIALLY
  overlap (two rows of one Generate request decoding in different
  slots). A parent-link tree would double-count both shapes. Instead,
  each instant of a trace is attributed to the innermost span covering
  it (latest start wins, shortest on ties) — a timeline sweep that
  partitions wall time exactly no matter how the spans interleave.
* **Per method.** Traces are grouped by their handler root
  (``rpc.Process`` / ``rpc.Generate``): the two wire paths have
  different stage taxonomies and different SLOs, so their breakdowns
  never mix. The handler's own uncovered time reports as the
  ``handler`` pseudo-stage, which is what makes the shares sum to ~1.

Stdlib-only, read-only over a snapshot: profiling a live server never
takes the tracer's lock for longer than ``snapshot()`` does, and never
touches a device. Serves ``GET /profile`` (obs/exposition.py) and
``tdn profile`` (cli.py); ``tools/bench_gate.py`` folds the breakdown
into its regression reports.
"""

from __future__ import annotations

import time

# Span-name prefix identifying a method root: "rpc.Process" ->
# method "Process". Client-side spans (client.*) are never attribution
# roots — in a loopback process both sides record into one tracer, and
# attributing the same wall time to both would double every share.
_ROOT_PREFIX = "rpc."

# The uncovered remainder of a root span (handler overhead: metadata,
# validation, result fan-in) reports under this pseudo-stage so every
# breakdown sums to the measured root wall time.
HANDLER_STAGE = "handler"


class SpanRecord:
    """The minimal span view attribution needs — constructable from
    tracer ``Span`` objects (:func:`records_from_spans`) or from Chrome
    trace events (``tdn trace``'s self-time summary)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "dur")

    def __init__(self, name, trace_id, span_id, parent_id, t0, dur):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = float(t0)
        self.dur = max(float(dur), 0.0)

    @property
    def end(self) -> float:
        return self.t0 + self.dur


def records_from_spans(spans) -> list[SpanRecord]:
    """Tracer ``Span`` objects -> records (unfinished spans skipped)."""
    return [
        SpanRecord(s.name, s.trace_id, s.span_id, s.parent_id, s.t0, s.dur)
        for s in spans if s.dur is not None
    ]


def compute_self_times(records) -> dict[str, float]:
    """``span_id -> self seconds``: the measure of the time where the
    span is the INNERMOST cover of its trace's timeline.

    Per trace, the span boundaries cut the timeline into elementary
    segments; each segment is attributed to the covering span that
    started latest (shortest on ties) — the innermost one. This
    partitions covered wall time exactly, for every interleaving the
    recorders produce: strict nesting (``fetch`` inside
    ``rpc.Process``), time-nested siblings (``decode.step`` inside the
    request's ``decode`` phase but parented to the handler), and
    PARTIALLY overlapping siblings (two rows of one Generate request
    decoding concurrently in different slots) — the case a parent-link
    tree would double-count.

    Quadratic in spans-per-trace; request trees are tens of spans, and
    the tracer's ring bounds the total.
    """
    selfs: dict[str, float] = {r.span_id: 0.0 for r in records}
    by_trace: dict[str, list[SpanRecord]] = {}
    for r in records:
        by_trace.setdefault(r.trace_id, []).append(r)
    for trace in by_trace.values():
        points = sorted({p for r in trace for p in (r.t0, r.end)})
        for a, b in zip(points, points[1:]):
            mid = (a + b) / 2.0
            cover = [r for r in trace if r.t0 <= mid < r.end]
            if not cover:
                continue
            innermost = max(cover, key=lambda r: (r.t0, -r.end))
            selfs[innermost.span_id] += b - a
    return selfs


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over an ascending list (stdlib-only —
    this module must not import numpy on the serving endpoint path)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[int(idx)]


def profile_snapshot(tracer=None, *, window: float | None = None,
                     top: int = 5, now: float | None = None) -> dict:
    """The rolling "where does the time go" breakdown as a JSON-ready
    dict (the ``GET /profile`` schema — documented in
    docs/OBSERVABILITY.md "Profiling").

    ``window`` keeps only traces whose root ENDED within the last
    ``window`` seconds (None = everything still in the tracer's buffer
    — itself a ring, so the profile is always rolling). ``top`` bounds
    the slowest-trace exemplar list per method.
    """
    if tracer is None:
        from tpu_dist_nn_torch.obs.trace import TRACER as tracer  # noqa: N811
    records = records_from_spans(tracer.snapshot())
    selfs = compute_self_times(records)
    by_trace: dict[str, list[SpanRecord]] = {}
    for r in records:
        by_trace.setdefault(r.trace_id, []).append(r)
    t_now = time.monotonic() if now is None else now
    roots = [r for r in records if r.name.startswith(_ROOT_PREFIX)]
    if window is not None:
        roots = [r for r in roots if r.end >= t_now - float(window)]

    # A root's breakdown covers the same-trace spans whose window lies
    # inside the root's (parent links would miss the time-nested /
    # partially-overlapping sibling shapes — see compute_self_times).
    # Client-side spans CONTAIN the handler and so never qualify, which
    # is what keeps a loopback process from attributing the same wall
    # time twice.
    eps = 1e-7
    methods: dict[str, dict] = {}
    for root in roots:
        method = root.name[len(_ROOT_PREFIX):]
        m = methods.setdefault(method, {
            "traces": 0, "wall": 0.0, "stages": {}, "roots": [],
        })
        m["traces"] += 1
        m["wall"] += root.dur
        per_trace: dict[str, float] = {
            HANDLER_STAGE: selfs.get(root.span_id, 0.0)
        }
        hst = m["stages"].setdefault(
            HANDLER_STAGE, {"count": 0, "durs": []}
        )
        hst["count"] += 1
        hst["durs"].append(per_trace[HANDLER_STAGE])
        for d in by_trace[root.trace_id]:
            if d.span_id == root.span_id or not (
                d.t0 >= root.t0 - eps and d.end <= root.end + eps
            ):
                continue
            per_trace[d.name] = per_trace.get(d.name, 0.0) + \
                selfs.get(d.span_id, 0.0)
            st = m["stages"].setdefault(d.name, {"count": 0, "durs": []})
            st["count"] += 1
            st["durs"].append(selfs.get(d.span_id, 0.0))
        m["roots"].append((root, per_trace))

    out_methods: dict[str, dict] = {}
    for method, m in methods.items():
        wall = m["wall"]
        stages = []
        for name, st in m["stages"].items():
            durs = sorted(st["durs"])
            total = sum(durs)
            stages.append({
                "stage": name,
                "count": st["count"],
                "total_s": round(total, 6),
                "share": round(total / wall, 4) if wall else 0.0,
                "p50_s": round(_percentile(durs, 0.50), 6),
                "p99_s": round(_percentile(durs, 0.99), 6),
                "max_s": round(durs[-1], 6),
            })
        stages.sort(key=lambda s: s["total_s"], reverse=True)
        slowest = sorted(m["roots"], key=lambda e: e[0].dur, reverse=True)
        out_methods[method] = {
            "traces": m["traces"],
            "wall_seconds_total": round(wall, 6),
            "share_sum": round(sum(s["share"] for s in stages), 4),
            "stages": stages,
            "slowest": [
                {
                    "trace_id": root.trace_id,
                    "wall_s": round(root.dur, 6),
                    "stages": {
                        k: round(v, 6)
                        for k, v in sorted(
                            per.items(), key=lambda kv: kv[1], reverse=True
                        )
                    },
                }
                for root, per in slowest[:max(int(top), 0)]
            ],
        }
    return {
        "window_seconds": window,
        "traces": len(roots),
        "methods": out_methods,
    }


def format_profile_table(doc: dict) -> str:
    """Human table of a :func:`profile_snapshot` document (the ``tdn
    profile`` output): one block per method, stages sorted by total
    self time, plus the slowest exemplar traces."""
    lines: list[str] = []
    methods = doc.get("methods", {})
    if not methods:
        lines.append(
            "no completed request traces in the window (is tracing "
            "enabled? --trace-sample-rate > 0 and traffic flowing)"
        )
        return "\n".join(lines)
    for method in sorted(methods):
        m = methods[method]
        lines.append(
            f"== {method}: {m['traces']} traces, "
            f"{m['wall_seconds_total'] * 1e3:.1f} ms total wall, "
            f"stage shares sum {m['share_sum'] * 100:.1f}% =="
        )
        lines.append(
            f"  {'stage':<14} {'share':>7} {'total_ms':>10} "
            f"{'p50_ms':>9} {'p99_ms':>9} {'count':>7}"
        )
        for s in m["stages"]:
            lines.append(
                f"  {s['stage']:<14} {s['share'] * 100:>6.1f}% "
                f"{s['total_s'] * 1e3:>10.2f} {s['p50_s'] * 1e3:>9.3f} "
                f"{s['p99_s'] * 1e3:>9.3f} {s['count']:>7}"
            )
        for i, ex in enumerate(m.get("slowest", ()), 1):
            top3 = list(ex["stages"].items())[:3]
            where = "  ".join(
                f"{k}={v * 1e3:.2f}ms" for k, v in top3
            )
            lines.append(
                f"  slowest[{i}] {ex['trace_id'][:16]} "
                f"wall={ex['wall_s'] * 1e3:.2f}ms  {where}"
            )
    return "\n".join(lines)
