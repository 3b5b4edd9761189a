"""Compiled steps (``tpu_dist_nn_torch.train.graphs``) and the capturable
Adam, on the CPU.

The optimizer's count is a device tensor and its learning rate and bias
corrections are read from tables indexed by it, so a captured step
replays every later step: held here to optax's trajectory (rtol 1e-6,
atol 1e-7: ``tests/test_torch_lm.py``'s optimizer tolerance) over
constant, cosine with warm-up, ``clip_norm``, ``weight_decay`` and
``grad_accum`` 2, and past the tables' end. The graph runner's launch
accounting and role selection run against a fake capture (the CUDA
graph itself runs only on the card: ``tests/test_torch_cuda.py``).
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_dist_nn.train.optimizers import build_optimizer as jax_build_optimizer
from tpu_dist_nn_torch.kernels import fcnn_fused_forward, flash_fwd_f32, reset_launch_counts
from tpu_dist_nn_torch.train import graphs
from tpu_dist_nn_torch.train.optimizers import (
    _MIN_TABLE,
    apply_updates,
    build_optimizer,
)

torch.set_num_threads(1)

SCHEDULES = {
    "constant": dict(learning_rate=1e-2),
    "cosine-warmup": dict(learning_rate=1e-2, schedule="cosine", warmup_steps=3,
                          total_steps=8),
    "clip": dict(learning_rate=1e-2, clip_norm=1.0),
    "weight-decay": dict(learning_rate=1e-2, weight_decay=0.1),
    "grad-accum-2": dict(learning_rate=1e-2, schedule="cosine", warmup_steps=2,
                         total_steps=12, clip_norm=2.0, grad_accum=2),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_capturable_adam_follows_optax(name):
    kw = SCHEDULES[name]
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": (3,), "c": (2, 5)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jopt = jax_build_optimizer(**kw)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    opt = build_optimizer(**kw)
    leaves = [torch.from_numpy(init[k].copy()) for k in sorted(shapes)]
    state = opt.init(leaves)
    assert state.count.dtype == torch.int64 and state.count.shape == ()
    for step in range(8 * kw.get("grad_accum", 1)):
        g = {k: (rng.standard_normal(s) * (3.0 if step % 2 else 0.2)).astype(np.float32)
             for k, s in shapes.items()}
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate,
                                      jparams)
        jparams = optax.apply_updates(jparams, updates)
        # the role a captured step would be given: the host's index
        role = state.mini_step
        ups = opt.update([torch.from_numpy(g[k]) for k in sorted(shapes)], state, leaves,
                         micro_step=role)
        state.mini_step = opt.next_micro_step(role)
        if ups is not None:
            apply_updates(leaves, ups)
        for k, t in zip(sorted(shapes), leaves):
            np.testing.assert_allclose(t.numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7)
    assert int(state.count) == 8


def test_tables_match_the_host_arithmetic_and_clamp_past_their_end():
    opt = build_optimizer(1.0, schedule="cosine", warmup_steps=2, total_steps=6)
    table = opt.tables("cpu")
    assert table.shape == (3, _MIN_TABLE)
    assert table[0, :8].tolist() == [np.float32(-opt.lr(c)) for c in range(8)]
    for row, b in ((1, 0.9), (2, 0.999)):
        for t in (1, 2, 50, 17_000):
            assert table[row, t - 1].item() == float(1 - np.float32(b) ** np.float32(t))
    # the last entries are 1.0 and the schedule's end: a count past the
    # table reads exactly what the host arithmetic gives there
    assert table[1, -1].item() == table[2, -1].item() == 1.0
    assert float(1 - np.float32(0.999) ** np.float32(10 * _MIN_TABLE)) == 1.0
    const = build_optimizer(1e-2)
    ups = []
    for count in (_MIN_TABLE - 1, 10 * _MIN_TABLE):
        leaf = torch.ones(2)
        state = const.init([leaf])
        state.count.fill_(count)
        ups.append(const.update([torch.full((2,), 0.5)], state, [leaf])[0])
        assert int(state.count) == count + 1
    assert torch.equal(ups[0], ups[1])


def test_update_is_in_place_and_leaves_the_host_index_to_the_caller():
    opt = build_optimizer(1e-2, grad_accum=2)
    leaves = [torch.ones(3), torch.ones(2)]
    state = opt.init(leaves)
    ids = [id(t) for t in (state.count, *state.mu, *state.nu, *state.acc)]
    assert opt.update([torch.ones(3), torch.ones(2)], state, leaves, micro_step=0) is None
    assert state.mini_step == 0  # a given role does not advance the host index
    assert opt.update([torch.ones(3), torch.ones(2)], state, leaves, micro_step=1) is not None
    assert [id(t) for t in (state.count, *state.mu, *state.nu, *state.acc)] == ids
    assert all(not a.any() for a in state.acc) and int(state.count) == 1
    # without a role the eager API reads and advances it
    assert opt.update([torch.ones(3), torch.ones(2)], state, leaves) is None
    assert state.mini_step == 1


class _FakeCuda:
    """Stand-ins for the CUDA graph API: a capture records nothing and
    a replay runs nothing, as on the card."""

    class CUDAGraph:
        replays = 0

        def replay(self):
            type(self).replays += 1

    class Stream:
        def __init__(self, *a, **k):
            pass

        def wait_stream(self, other):
            pass

    def __init__(self, fail_capture=False):
        self.fail_capture = fail_capture
        self.captures = 0

    def install(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "CUDAGraph", self.CUDAGraph)
        monkeypatch.setattr(torch.cuda, "Stream", self.Stream)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: self.Stream())
        monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "graph", self.graph)

    @contextlib.contextmanager
    def graph(self, g, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        self.captures += 1
        yield
        if self.fail_capture:
            raise RuntimeError("operation failed due to a previous error during capture")


def test_launch_accounting_through_the_graph_runner(monkeypatch):
    fake = _FakeCuda()
    fake.install(monkeypatch)
    calls = []

    def step():
        calls.append(1)
        fcnn_fused_forward.launches += 3  # as three kernel wrapper calls would
        flash_fwd_f32.launches += 1
        return types.SimpleNamespace(out=len(calls))

    reset_launch_counts()
    g = graphs.GraphedStep(step, "cuda")
    first = g()
    # the warm-up is a real call (its launches count); the capture's
    # increments are taken back out
    assert first.out == 1 and len(calls) == 2 and fake.captures == 1
    assert (fcnn_fused_forward.launches, flash_fwd_f32.launches) == (3, 1)
    assert g.launches == {fcnn_fused_forward: 3, flash_fwd_f32: 1}
    for _ in range(4):
        assert g() is g.outputs  # the captured outputs, nothing re-run
    assert len(calls) == 2 and g.replays == 4
    assert (fcnn_fused_forward.launches, flash_fwd_f32.launches) == (15, 5)
    reset_launch_counts()


def test_a_failed_capture_raises_and_restores_the_counts(monkeypatch):
    _FakeCuda(fail_capture=True).install(monkeypatch)

    def step():
        fcnn_fused_forward.launches += 2

    reset_launch_counts()
    g = graphs.GraphedStep(step, "cuda")
    with pytest.raises(RuntimeError, match="during capture"):
        g()
    assert fcnn_fused_forward.launches == 2 and g.graph is None
    reset_launch_counts()
    with pytest.raises(ValueError, match="needs a CUDA device"):
        graphs.GraphedStep(step, "cpu")


def test_compiled_step_picks_a_graph_per_micro_step_role(monkeypatch):
    _FakeCuda().install(monkeypatch)

    class OnTheCpu(graphs.GraphedStep):  # the fake capture, over CPU buffers
        def __init__(self, fn, device, **kw):
            super().__init__(fn, "cuda", **kw)

    monkeypatch.setattr(graphs, "GraphedStep", OnTheCpu)
    opt = build_optimizer(1e-2, grad_accum=2)
    leaves = [torch.zeros(3)]
    state = opt.init(leaves)
    seen = []

    def step(leaf, opt_state, x, *, micro_step=None):
        seen.append((micro_step, x.clone()))
        return leaf, opt_state, float(x.sum())

    compiled = graphs.CompiledStep(step, (leaves[0], state), [((3,), torch.float32)], opt,
                                   state, "cpu")
    for i in range(5):
        compiled(np.full(3, float(i), np.float32))
    # role 0 then 1 each warmed and captured once, then replayed
    assert sorted(compiled.graphs) == [0, 1]
    assert [r for r, _ in seen] == [0, 0, 1, 1]
    assert state.mini_step == 1  # five calls: 0 1 0 1 0
    assert torch.equal(compiled.inputs.buffers[0], torch.full((3,), 4.0))


def test_static_inputs_fill_their_buffers_through_the_ring():
    inputs = graphs.StaticInputs([((4, 2), torch.float32), ((4,), torch.int64)], "cpu")
    first = inputs.buffers
    for i in range(3):
        bufs = inputs.load(np.full((4, 2), i, np.float64), np.arange(4) + i)
        assert bufs is first  # fixed addresses
        assert torch.equal(bufs[0], torch.full((4, 2), float(i)))
        assert bufs[1].tolist() == [i, i + 1, i + 2, i + 3]
