"""Latency profiling: wall-clock spans and CUDA-event kernel timing.

Port of :mod:`tpu_dist_nn.utils.profiling`. :class:`LatencyStats` is a
copy (the source of the "p50 batch latency" figures);
:func:`cuda_time_ms` times device work with CUDA events, the card's
counterpart of the JAX package's device traces; :func:`cuda_graph_time_ms`
and :func:`device_call_ms` do the same with the host's launch cost taken
out.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass
class LatencyStats:
    """Wall-clock samples with percentile summaries.

    The structured replacement for the reference's printed per-batch
    seconds (``run_grpc_inference.py:195,211,213-215``).

    ``window`` bounds the retained samples to the most recent N (a
    sliding window): a long-lived serving process can record spans
    forever without the sample list growing without limit, at the cost
    of percentiles covering the window rather than all time.
    ``summary()`` reports the cap so a windowed p99 is never mistaken
    for an all-time one. ``None`` (the default) keeps everything — the
    bounded-run behavior existing callers rely on.
    """

    name: str = "latency"
    samples_s: list[float] = dataclasses.field(default_factory=list)
    window: int | None = None

    def __post_init__(self) -> None:
        if self.window is not None:
            if self.window < 1:
                raise ValueError(
                    f"{self.name}: window must be >= 1, got {self.window}"
                )
            # A deque with maxlen IS the sliding window: append is O(1)
            # and eviction is automatic. Everything downstream only
            # iterates (np.asarray, sum, len), so the container swap is
            # invisible to summary()/percentile() callers.
            self.samples_s = collections.deque(
                self.samples_s, maxlen=self.window
            )

    def record(self, seconds: float) -> None:
        self.samples_s.append(float(seconds))

    @contextlib.contextmanager
    def time(self) -> Iterator[None]:
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.record(time.monotonic() - t0)

    def __len__(self) -> int:
        return len(self.samples_s)

    @property
    def total_s(self) -> float:
        return float(sum(self.samples_s))

    def percentile(self, q: float) -> float:
        if not self.samples_s:
            raise ValueError(f"{self.name}: no samples recorded")
        return float(np.percentile(np.asarray(self.samples_s), q))

    def summary(self) -> dict:
        """p50/p90/p99/mean/min/max/total over the recorded spans.

        When a ``window`` cap is configured the summary includes it —
        the numbers then cover (at most) the last ``window`` spans.
        """
        if not self.samples_s:
            base = {"name": self.name, "count": 0}
            if self.window is not None:
                base["window"] = self.window
            return base
        arr = np.asarray(self.samples_s)
        return {
            "name": self.name,
            **({"window": self.window} if self.window is not None else {}),
            "count": int(arr.size),
            "total_s": float(arr.sum()),
            "mean_s": float(arr.mean()),
            "min_s": float(arr.min()),
            "max_s": float(arr.max()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "p99_s": float(np.percentile(arr, 99)),
        }


def cuda_time_ms(fn, *, iters: int = 50, warmup: int = 5) -> float:
    """Mean device milliseconds per call of ``fn()`` on the current CUDA
    stream: ``warmup`` untimed calls, then ``iters`` calls between two
    CUDA events. Raises without a visible GPU (a CPU time is never
    reported as a device time)."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def cuda_graph_time_ms(fn, *, iters: int = 50, warmup: int = 5) -> float:
    """Mean device milliseconds per call of ``fn()`` with the host out of
    the way: ``warmup`` untimed calls on a side stream, then ``iters``
    calls captured in one CUDA graph, replayed once untimed and once
    between two CUDA events. Where a call's Python and launch cost
    exceeds its device time, :func:`cuda_time_ms` measures the host;
    this measures the kernels. Outputs of the captured calls stay
    allocated until the graph is freed. Raises without a visible GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_graph_time_ms needs a CUDA device")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop) / iters
    del graph
    return ms


# Busy-wait cycles queued ahead of each call's start event in
# device_call_ms (about half a millisecond on an H100): longer than the
# host takes to issue one forward.
_LEAD_CYCLES = 1_000_000


def device_call_ms(fn, *, calls: int = 7) -> float:
    """Median device milliseconds of one ``fn()`` call on the current
    CUDA stream, over ``calls`` calls after one warm call. Each call sits
    between two CUDA events with a busy-wait kernel queued ahead of the
    first, so the card is still busy while the host issues the call: the
    time between the events is the call's device time, not the host's
    (an idle card would count the host's issue time). Raises without a
    visible GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_call_ms needs a CUDA device")
    fn()
    marks = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_LEAD_CYCLES)
        start.record()
        fn()
        stop.record()
        marks.append((start, stop))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in marks]))
