"""Compiled steps on the card: a step captured once as a CUDA graph and
replayed.

The JAX package runs each training step, the pipelined forward and the
``steps_per_call`` superstep as one compiled device program (``jax.jit``,
``lax.scan``). The port's counterpart on a card is a captured
``torch.cuda.CUDAGraph``: the host issues one replay where it issued
every operation of the step. This module has no JAX counterpart; the
trainers and the Engine's pipelined forward build on it:

* :class:`GraphedStep` runs a function of no arguments that reads and
  writes tensors at fixed addresses (the step's state is updated in
  place, its inputs are static buffers). Its first call is the warm-up,
  on a side stream, and is a real call: its outputs are returned and
  its effects stay. Then the function is captured (a capture executes
  nothing) and every later call replays the graph and returns the
  captured outputs, which the next replay overwrites. A failed capture
  or replay raises; nothing falls back to the eager step.
* Launch accounting: each kernel wrapper bumps its ``launches`` count in
  Python, where a replay does not run. The capture's increments are
  taken back out of the counts, recorded, and added again on every
  replay, so the counts say what ran on the card.
* :class:`StaticInputs`: the device buffers a captured step reads, and
  the host feed that fills them through a ring of pinned buffers with
  asynchronous copies, so the host does not wait for the card between
  steps.

On the CPU nothing here is used: the trainers run their eager steps.
"""

from __future__ import annotations

import functools
import gc
from typing import Callable, Sequence

import torch


def _launch_counts() -> dict:
    from tpu_dist_nn_torch.kernels import KERNEL_WRAPPERS

    return {fn: fn.launches for fn in KERNEL_WRAPPERS}


def _tensors(out) -> list[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    return []


class GraphedStep:
    """``fn()`` captured as a CUDA graph on ``device`` (see the module
    docstring), in a memory pool of its own: graphs replayed in any
    order, or two batches of one in flight, never share a block."""

    def __init__(self, fn: Callable[[], object], device):
        self.fn = fn
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {self.device}")
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs = None
        #: kernel wrapper -> launches one replay makes
        self.launches: dict = {}
        self.replays = 0

    def __call__(self):
        if self.graph is None:
            out = self._warm()
            self._capture()
            return out
        self.graph.replay()
        self.replays += 1
        for fn, n in self.launches.items():
            fn.launches += n
        return self.outputs

    def _warm(self):
        """The first call, on a side stream: lazy initialisation (kernel
        builds, cuBLAS workspaces, autograd's device threads) happens
        outside the capture."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn()
        current.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(current)
        return out

    def _capture(self) -> None:
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        # The cyclic collector could free another graph inside the
        # capture, and destroying a graph is refused while a stream
        # captures: that would invalidate this capture.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                outputs = self.fn()
        finally:
            if collecting:
                gc.enable()
            after = _launch_counts()
            for fn, n in before.items():
                fn.launches = n
        self.launches = {fn: after[fn] - n for fn, n in before.items() if after[fn] != n}
        self.graph, self.outputs = graph, outputs


class StaticInputs:
    """Device buffers shaped like ``like`` (``(shape, dtype)`` pairs)
    that a captured step reads, and their host feed.

    :meth:`load` copies host arrays into the buffers: each array lands
    in a pinned host buffer of a ring of two, then an asynchronous copy
    on the current stream moves it to the card. A pinned buffer is
    reused only after its previous copy has finished (an event), so the
    host runs up to two loads ahead of the card."""

    def __init__(self, like: Sequence, device):
        self.device = torch.device(device)
        self.buffers = [torch.zeros(shape, dtype=dtype, device=self.device)
                        for shape, dtype in like]
        pin = self.device.type == "cuda"
        self._ring = [[torch.empty(shape, dtype=dtype, pin_memory=pin) for shape, dtype in like]
                      for _ in range(2)]
        self._done: list = [None, None]
        self._next = 0

    def load(self, *arrays) -> list[torch.Tensor]:
        """Copy ``arrays`` (numpy or CPU tensors, in ``like``'s order and
        shapes) into the device buffers; returns the buffers."""
        slot = self._next
        self._next = 1 - slot
        if self._done[slot] is not None:
            self._done[slot].synchronize()
        for buf, host, a in zip(self.buffers, self._ring[slot], arrays):
            host.copy_(torch.as_tensor(a))
            buf.copy_(host, non_blocking=True)
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._done[slot] = ev
        return self.buffers


class CompiledStep:
    """A training step ``step(*state, *inputs, micro_step=role)`` run as
    one captured graph a micro-step role (``grad_accum > 1`` captures
    an accumulate-only graph and an accumulate-and-update one).

    ``like``: the step's input buffers (see :class:`StaticInputs`);
    ``opt_state.mini_step`` is the host's index, read to pick the graph
    and advanced after each call as the eager step advances it. Returns
    the step's last output (its loss), which the next call overwrites."""

    def __init__(self, step, state: tuple, like: Sequence, optimizer, opt_state, device):
        self.step, self.state = step, state
        self.optimizer, self.opt_state = optimizer, opt_state
        self.device = torch.device(device)
        self.inputs = StaticInputs(like, device)
        self.graphs: dict = {}

    def __call__(self, *arrays):
        self.inputs.load(*arrays)
        role = self.opt_state.mini_step
        graph = self.graphs.get(role)
        if graph is None:
            # The captured function holds no reference back to this
            # object (no cycle: graphs are freed by reference count).
            graph = self.graphs[role] = GraphedStep(functools.partial(
                _last_output, self.step, (*self.state, *self.inputs.buffers), role),
                self.device)
        out = graph()
        self.opt_state.mini_step = self.optimizer.next_micro_step(role)
        return out


def _last_output(step, args, micro_step):
    return step(*args, micro_step=micro_step)[-1]
