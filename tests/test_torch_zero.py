"""ZeRO-1 and FSDP (``tpu_dist_nn_torch.parallel.zero``) against the JAX
package's ``parallel/zero.py``, on the CPU.

Case by case the mirror of ``tests/test_zero.py``: the same seeded
params (the JAX init carried across) and token rows go through the JAX
steps on conftest's 8 virtual host devices and through the port's on
``devices=["cpu"] * N`` data slots. Tolerances are that file's: the loss
trajectory rtol 1e-4 a step, the params atol 3e-3 (Adam's early
near-sign updates turn a different summation order into lr-scale
wiggle). Then what only the port can get wrong: its slices against its
own unsharded step with ``clip_norm``, ``weight_decay`` and
``grad_accum`` on (and a per-slice clip that such a check catches), a
repeat bit for bit, the checkpoint of a sharded run, and the collectives.
"""

import dataclasses
import io
from contextlib import redirect_stderr

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist_nn.models.transformer import TransformerConfig as JaxConfig
from tpu_dist_nn.models.transformer import init_transformer as jax_init
from tpu_dist_nn.parallel import zero as jz
from tpu_dist_nn.parallel.mesh import MeshSpec as JaxMeshSpec
from tpu_dist_nn.parallel.mesh import build_mesh as jax_build_mesh
from tpu_dist_nn.train.optimizers import build_optimizer as jax_build_optimizer
from tpu_dist_nn_torch.checkpoint import CheckpointManager
from tpu_dist_nn_torch.models.transformer import (
    TransformerConfig,
    param_leaves,
    transformer_params_from_jax,
    tree_map,
)
from tpu_dist_nn_torch.parallel import collectives, zero
from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
from tpu_dist_nn_torch.parallel.zero import Shards
from tpu_dist_nn_torch.train.lm_trainer import LMTrainConfig, make_lm_train_step, train_lm
from tpu_dist_nn_torch.train.optimizers import build_optimizer

torch.set_num_threads(1)
SHAPE = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_seq_len=16)
JCFG, CFG = JaxConfig(**SHAPE), TransformerConfig(**SHAPE)


def _tokens(b, key=0):
    return np.random.default_rng(key).integers(0, SHAPE["vocab_size"], (b, 16)).astype(np.int32)


def _both(seed, jcfg=JCFG):
    jparams = jax_init(jax.random.key(seed), jcfg)
    return jparams, transformer_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _mesh(data, seq=1):
    return build_mesh(MeshSpec(data=data, seq=seq), ["cpu"] * (data * seq))


def _trainable(params):
    return tree_map(lambda a: a.detach().clone().requires_grad_(True), params)


def _spec_dim(sharding):
    spec = tuple(sharding.spec)
    return spec.index("data") if "data" in spec else None


class _Box:
    def __init__(self, shape):
        self.shape = shape
        self.ndim = len(shape)


@pytest.mark.parametrize("data", [8, 2])
def test_layout_rule_picks_the_jax_dim(data):
    """``zero_opt_shardings`` on the JAX test's boxes (and a tie and an
    odd shape), on every leaf of a small transformer and on every leaf of
    its Adam state: the dim the JAX rule shards, or None where it keeps
    the leaf whole."""
    jmesh = jax_build_mesh(JaxMeshSpec(data=data))
    is_sharding = lambda x: hasattr(x, "spec")  # noqa: E731
    boxes = {"a": _Box((2, 128, 48)), "b": _Box((3, 5)), "c": _Box(()), "tie": _Box((16, 16)),
             "odd": _Box((7, 3 * data))}
    got = zero.zero_opt_shardings(boxes, _mesh(data))
    assert got == jax.tree.map(_spec_dim, jz.zero_opt_shardings(boxes, jmesh),
                               is_leaf=is_sharding)
    if data == 8:
        assert (got["a"], got["b"], got["c"], got["tie"]) == (1, None, None, 1)
    jparams, params = _both(0)
    got = zero.zero_opt_shardings(param_leaves(params), data)
    want = [_spec_dim(s) for s in jax.tree.leaves(jz.zero_opt_shardings(jparams, jmesh),
                                                  is_leaf=is_sharding)]
    assert got == want and any(d is not None for d in got)
    jstate = jax.eval_shape(jax_build_optimizer(1e-3).init, jparams)
    want = [_spec_dim(s) for s in jax.tree.leaves(jz.zero_opt_shardings(jstate, jmesh),
                                                  is_leaf=is_sharding)]
    assert [zero.shard_dim(tuple(leaf.shape), data) for leaf in jax.tree.leaves(jstate)] == want


def _run_jax(make, steps, keys, jparams, **kw):
    mesh = jax_build_mesh(JaxMeshSpec(**kw.pop("spec")))
    opt = jax_build_optimizer(kw.pop("lr", 1e-3))
    step = make(mesh, JCFG, opt, jparams, **kw)
    p, o = jparams, step.init_opt_state(jparams)
    losses = []
    for i in range(steps):
        p, o, loss = step(p, o, jnp.asarray(_tokens(keys[1], key=keys[0] + i)))
        losses.append(float(loss))
    return p, losses


def _run_port(step, opt, params, steps, keys):
    p = step.shard_params(_trainable(params))
    o = step.init_opt_state(param_leaves(p))
    losses = [float(step(p, o, torch.from_numpy(_tokens(keys[1], key=keys[0] + i)).long())[2])
              for i in range(steps)]
    return step.unshard_params(p), o, losses


@pytest.mark.parametrize("kind", ["zero1", "fsdp"])
def test_loss_trajectory_and_params_match_jax(kind):
    """``tests/test_zero.py::test_zero1_matches_unsharded_trajectory`` and
    ``test_fsdp_matches_unsharded_loss_trajectory``: the port's sharded
    step against the JAX one at data 8, 6 (5) steps of 16 rows."""
    jparams, params = _both(0)
    steps = 6 if kind == "zero1" else 5
    jmake = jz.make_zero_lm_train_step if kind == "zero1" else jz.make_fsdp_lm_train_step
    make = zero.make_zero_lm_train_step if kind == "zero1" else zero.make_fsdp_lm_train_step
    jp, jlosses = _run_jax(jmake, steps, (0, 16), jparams, spec=dict(data=8))
    opt = build_optimizer(1e-3)
    got, state, losses = _run_port(make(_mesh(8), CFG, opt, params), opt, params, steps,
                                   (0, 16))
    assert all(isinstance(m, Shards) for m in state.mu)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    want = transformer_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for a, b in zip(param_leaves(got), param_leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=3e-3)


@pytest.mark.parametrize("kind", ["zero1", "fsdp"])
def test_each_slot_owns_one_nth_and_init_allocates_no_full_moment(kind):
    """``test_opt_state_actually_sharded``, ``test_sharded_init_never_
    materializes_replicated_moments`` and FSDP's sharded params: every
    sharded leaf's slices are 1/8 of it, one a slot; no moment piece of a
    sharded leaf is full size; the step consumes the state and the
    params come back whole and learning."""
    _, params = _both(0)
    opt = build_optimizer(1e-3)
    make = zero.make_zero_lm_train_step if kind == "zero1" else zero.make_fsdp_lm_train_step
    step = make(_mesh(8), CFG, opt, params)
    p = step.shard_params(_trainable(params))
    state = step.init_opt_state(param_leaves(p))
    sharded = [i for i, d in enumerate(step.layout) if d is not None]
    assert sharded
    for moments in (state.mu, state.nu):
        for i, leaf in enumerate(moments):
            if i in sharded:
                assert isinstance(leaf, Shards) and len(leaf.parts) == 8
                assert all(part.numel() * 8 == leaf.numel() for part in leaf.parts)
            else:
                assert isinstance(leaf, torch.Tensor)
    for i, leaf in enumerate(param_leaves(p)):
        assert isinstance(leaf, Shards) == (kind == "fsdp" and i in sharded)
    losses = [float(step(p, state, torch.from_numpy(_tokens(16, key=i % 2)).long())[2])
              for i in range(6)]
    assert losses[-1] < losses[0] and int(state.count) == 6
    whole = step.unshard_params(p)
    assert all(isinstance(a, torch.Tensor) and a.dtype == torch.float32
               for a in param_leaves(whole))


def test_fsdp_composes_with_bf16_and_remat():
    """``test_fsdp_composes_with_bf16_and_remat``: bf16 compute with
    remat learns, the master params stay float32, and the losses follow
    the JAX step's at the bf16 rounding's scale."""
    jcfg = dataclasses.replace(JCFG, compute_dtype="bfloat16", remat=True)
    cfg = dataclasses.replace(CFG, compute_dtype="bfloat16", remat=True)
    jparams, params = _both(0, jcfg)
    mesh = jax_build_mesh(JaxMeshSpec(data=8))
    jopt = jax_build_optimizer(1e-3)
    jstep = jz.make_fsdp_lm_train_step(mesh, jcfg, jopt, jparams)
    p, o, jlosses = jparams, jstep.init_opt_state(jparams), []
    for i in range(4):
        p, o, loss = jstep(p, o, jnp.asarray(_tokens(16, key=i % 2)))
        jlosses.append(float(loss))
    opt = build_optimizer(1e-3)
    step = zero.make_fsdp_lm_train_step(_mesh(8), cfg, opt, params)
    pp = step.shard_params(_trainable(params))
    state = step.init_opt_state(param_leaves(pp))
    losses = [float(step(pp, state, torch.from_numpy(_tokens(16, key=i % 2)).long())[2])
              for i in range(4)]
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-2)
    assert all(leaf.dtype == torch.float32 for leaf in param_leaves(step.unshard_params(pp)))


def test_sp_zero1_matches_the_jax_sp_sharded_step():
    """``test_sp_zero1_matches_sp_only_trajectory``: the ring loss over
    (seq 4, data 2) with the moments over the data slots, against JAX's
    ``make_sp_sharded_lm_train_step`` (and so its sp-only trajectory),
    4 steps at rtol 1e-4; the moments are sharded."""
    jparams, params = _both(1)
    _, jlosses = _run_jax(jz.make_sp_sharded_lm_train_step, 4, (10, 8), jparams,
                          spec=dict(seq=4, data=2))
    opt = build_optimizer(1e-3)
    step = zero.make_sp_sharded_lm_train_step(_mesh(2, seq=4), CFG, opt, params)
    _, state, losses = _run_port(step, opt, params, 4, (10, 8))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    w_qkv = sorted(_keys(params)).index(("blocks", "w_qkv"))
    assert isinstance(state.mu[w_qkv], Shards)


def _keys(tree, path=()):
    return [k for key in sorted(tree) for k in (
        _keys(tree[key], path + (key,)) if isinstance(tree[key], dict) else [path + (key,)])]


def test_sp_fsdp_params_sharded_and_learning():
    """``test_sp_fsdp_params_sharded_and_learning``: (seq 2, data 4), lr
    1e-2, the params and moments sliced, the loss falls; and its losses
    are JAX's."""
    jparams, params = _both(2)
    _, jlosses = _run_jax(jz.make_sp_sharded_lm_train_step, 4, (20, 8), jparams,
                          spec=dict(seq=2, data=4), lr=1e-2, shard_params=True)
    opt = build_optimizer(1e-2)
    step = zero.make_sp_sharded_lm_train_step(_mesh(4, seq=2), CFG, opt, params,
                                              shard_params=True)
    p = step.shard_params(_trainable(params))
    state = step.init_opt_state(param_leaves(p))
    losses = [float(step(p, state, torch.from_numpy(_tokens(8, key=20 + i)).long())[2])
              for i in range(4)]
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert isinstance(p["blocks"]["w_qkv"], Shards)


def test_cli_lm_sp_zero1_prints_perplexity(capsys):
    """``test_cli_lm_sp_zero1``: the flag combination end to end."""
    from tpu_dist_nn_torch.cli import main

    rc = main(["lm", "--device", "cpu", "--steps", "2", "--batch-size", "4", "--seq-len", "15",
               "--d-model", "16", "--heads", "2", "--layers", "2", "--seq-parallel", "4",
               "--data-parallel", "2", "--zero1", "--eval-batches", "1"])
    assert rc == 0
    assert "perplexity" in capsys.readouterr().out


# ------------------------------------------------ what only the port can get wrong

CONTROLS = dict(clip_norm=0.05, weight_decay=0.01, grad_accum=2)


@pytest.mark.parametrize("data", [8, 3])
@pytest.mark.parametrize("kind", ["zero1", "fsdp"])
def test_slices_match_the_unsharded_step_with_every_control(kind, data):
    """With ``clip_norm`` (binding: the norm is above 0.05), decoupled
    weight decay and ``grad_accum 2`` on, the sharded step follows the
    port's unsharded step (the JAX test's tolerances; Adam's first
    moment, which carries the clipped gradients, within 1e-4 relative L2
    a leaf), two runs are bit for bit equal, and a clip by each slice's
    own norm departs from the unsharded first moment.
    At data 3 only the ``3 * d_model`` leaves are sliced: the others stay
    whole on slot 0."""
    _, params = _both(3)
    batches = [torch.from_numpy(_tokens(24, key=30 + i)).long() for i in range(6)]
    opt = build_optimizer(1e-3, **CONTROLS)
    base = make_lm_train_step(CFG, opt)
    p0 = _trainable(params)
    s0 = opt.init(param_leaves(p0))
    want = [float(base(p0, s0, t)[2]) for t in batches]
    make = zero.make_zero_lm_train_step if kind == "zero1" else zero.make_fsdp_lm_train_step

    def run(optimizer):
        step = make(_mesh(data), CFG, optimizer, params)
        assert (None in step.layout) == (data == 3)
        p = step.shard_params(_trainable(params))
        state = step.init_opt_state(param_leaves(p))
        losses = [step(p, state, t)[2] for t in batches]
        mu = [m.whole() if isinstance(m, Shards) else m for m in state.mu]
        return losses, step.unshard_params(p), mu

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    losses, got, mu = run(opt)
    np.testing.assert_allclose([float(x) for x in losses], want, rtol=1e-4)
    for a, b in zip(param_leaves(got), param_leaves(p0)):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), atol=3e-3)
    assert max(rel(a, b) for a, b in zip(mu, s0.mu)) < 1e-4
    again, got2, _ = run(build_optimizer(1e-3, **CONTROLS))
    assert all(torch.equal(a, b) for a, b in zip(losses, again))
    assert all(torch.equal(a, b) for a, b in zip(param_leaves(got), param_leaves(got2)))

    class PerSliceClip(type(opt)):
        def apply(self, grads, state, params, **kw):
            # Each slice clipped by its own norm, and no global clip: the
            # fault a global norm avoids.
            clip, self.clip_norm = self.clip_norm, None
            try:
                grads = [torch.where(g.norm() < clip, g, g / g.norm() * clip) for g in grads]
                return super().apply(grads, state, params, **kw)
            finally:
                self.clip_norm = clip

    wrong = PerSliceClip(1e-3, schedule="constant", warmup_steps=0, total_steps=None,
                         **CONTROLS)
    _, _, bad = run(wrong)
    assert max(rel(a, b) for a, b in zip(bad, s0.mu)) > 1e-4


@pytest.mark.parametrize("kind", ["zero1", "fsdp"])
def test_checkpoint_resume_equals_the_straight_run_with_unsharded_keys(kind, tmp_path):
    """``train_lm`` with the sharded step: a run cut at step 2 and resumed
    from its checkpoint equals the straight run bit for bit, and its
    file's keys and shapes are an unsharded run's (the slices saved whole)."""
    _, params = _both(4)
    rows = np.random.default_rng(5).integers(0, 64, (64, 17))
    batches = [rows[i * 8:(i + 1) * 8] for i in range(6)]
    tc = LMTrainConfig(steps=4, batch_size=8, seq_len=16, log_every=1, clip_norm=0.5)
    make = zero.make_zero_lm_train_step if kind == "zero1" else zero.make_fsdp_lm_train_step
    mesh = _mesh(2)

    def step_fn(opt):
        return make(mesh, CFG, opt, params)

    straight, h1 = train_lm(params, CFG, batches, tc, step_fn=step_fn)
    ck = CheckpointManager(tmp_path / "zero")
    _, cut = train_lm(params, CFG, batches, dataclasses.replace(tc, steps=2), step_fn=step_fn,
                      checkpoints=ck)
    resumed, h2 = train_lm(params, CFG, batches, tc, step_fn=step_fn,
                           checkpoints=CheckpointManager(tmp_path / "zero"))
    assert [h["loss"] for h in h1] == [h["loss"] for h in cut + h2]
    assert all(torch.equal(a, b) for a, b in zip(param_leaves(straight), param_leaves(resumed)))
    train_lm(params, CFG, batches, dataclasses.replace(tc, steps=2),
             checkpoints=CheckpointManager(tmp_path / "plain"))
    with np.load(tmp_path / "zero" / "ckpt_00000004.npz") as z, \
            np.load(tmp_path / "plain" / "ckpt_00000002.npz") as u:
        assert sorted(z.files) == sorted(u.files) and "opt_state/mu/3" in z.files
        assert all(z[k].shape == u[k].shape for k in z.files)


def test_reduce_scatter_and_gather_are_each_others_backward():
    """``reduce_scatter`` sums slice j of every partial in shard order on
    slot j; ``gather_slices`` is its inverse layout; as autograd ops the
    gradient of one is the other."""
    slots = list(_mesh(4).slots[0])
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32)).requires_grad_()
             for _ in range(4)]
    out = collectives.reduce_scatter(parts, slots, dim=1)
    total = parts[0] + parts[1] + parts[2] + parts[3]
    assert [o.shape for o in out] == [(3, 2)] * 4
    assert torch.equal(torch.cat(out, dim=1), total)
    cot = [torch.from_numpy(rng.normal(size=(3, 2)).astype(np.float32)) for _ in range(4)]
    grads = torch.autograd.grad(out, parts, cot)
    gathered = collectives.gather_slices(cot, slots[2], dim=1)
    assert all(torch.equal(g, gathered) for g in grads)
    slices = [p.detach()[:, 2 * j:2 * j + 2].clone().requires_grad_() for j, p in enumerate(parts)]
    full = [collectives.gather_slices(slices, slot, dim=1) for slot in slots]
    back = torch.autograd.grad(full, slices, [p.detach() for p in parts])
    for got, want in zip(back, collectives.reduce_scatter([p.detach() for p in parts], slots, 1)):
        torch.testing.assert_close(got, want)


def test_cli_zero_flags_accept_and_refuse_as_tdn(capsys):
    """``tdn lm --zero1/--fsdp``: the refusals in the JAX package's texts
    and order, and FSDP trains where JAX's trains."""
    from tpu_dist_nn.cli import main as tdn_main
    from tpu_dist_nn_torch.cli import main as port_main

    base = ["lm", "--steps", "2", "--batch-size", "4", "--seq-len", "15", "--d-model", "16",
            "--heads", "2", "--layers", "2", "--eval-batches", "1"]
    for flags in (["--zero1", "--fsdp", "--data-parallel", "2"], ["--fsdp"],
                  ["--zero1", "--data-parallel", "2", "--stages", "2"],
                  ["--fsdp", "--data-parallel", "3"]):
        texts = []
        for main, argv in ((port_main, base + flags + ["--device", "cpu"]),
                           (tdn_main, ["--platform", "cpu"] + base + flags)):
            err = io.StringIO()
            with redirect_stderr(err):
                assert main(argv) == 2
            texts.append(err.getvalue().strip().splitlines()[-1])
        assert texts[0] == texts[1]
    assert port_main(base + ["--fsdp", "--data-parallel", "2", "--device", "cpu"]) == 0
    assert "perplexity" in capsys.readouterr().out
