"""Expert parallelism over CPU expert slots against the JAX package's, on the CPU.

Flat EP (the batch over ``(data, expert)``, the buffers exchanged over a
replica's expert slots), tensor parallelism inside the experts and
sequence x expert parallelism (ring and Ulysses), each on
``devices=["cpu"] * n`` meshes, against the JAX package's sharded
functions on conftest's 8 virtual host devices and its grouped oracle
(``moe_forward`` / ``moe_ffn_apply`` with ``n_groups = data * expert``
and ``n_seq_groups = seq``), at ``tests/test_expert_parallel.py``'s
configuration and tolerances: logits within 2e-5, the loss within rtol
1e-5 / atol 1e-6, the gradients within rtol 1e-5 / atol 1e-7. JAX's
sharded Ulysses sp x ep loss is never built here (it crashes a pytest
worker): the port's Ulysses is held against the grouped oracle and
against its own ring on the same shards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist_nn.models.transformer import masked_next_token_ce as jax_masked_ce
from tpu_dist_nn.parallel import expert_parallel as jep
from tpu_dist_nn.parallel.mesh import MeshSpec as JaxMeshSpec
from tpu_dist_nn.parallel.mesh import build_mesh as jax_build_mesh
from tpu_dist_nn_torch.models.transformer import param_leaves, tree_map
from tpu_dist_nn_torch.parallel import expert_parallel as ep
from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
from tpu_dist_nn_torch.train.lm_trainer import (
    make_ep_tp_moe_lm_train_step,
    make_moe_lm_train_step,
    make_sp_moe_lm_train_step,
)
from tpu_dist_nn_torch.train.optimizers import build_optimizer

torch.set_num_threads(1)
SHAPE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=32,
             n_experts=4, capacity_factor=1.5)
LOGIT_TOL = dict(rtol=2e-5, atol=2e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)


def _cfgs(**over):
    shape = dict(SHAPE, **over)
    return jep.MoEConfig(**shape), ep.MoEConfig(**shape)


def _both(seed, jcfg):
    jparams = jep.init_moe_transformer(jax.random.key(seed), jcfg)
    return jparams, ep.moe_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _tokens(batch, t, seed):
    return np.random.default_rng(seed).integers(0, 64, (batch, t)).astype(np.int32)


def _mesh(**axes):
    spec = MeshSpec(**axes)
    return build_mesh(spec, ["cpu"] * spec.num_devices)


def _value_and_grads(loss_fn, params):
    """``(loss, grads)``, the grads a dict in the params' layout."""
    p = tree_map(lambda a: a.clone().requires_grad_(), params)
    loss = loss_fn(p)
    loss.backward()
    return float(loss.detach()), tree_map(lambda a: a.grad, p)


def _close(got: dict, want: dict, tol, path=""):
    for k, v in want.items():
        if isinstance(v, dict):
            _close(got[k], v, tol, f"{path}{k}/")
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v), err_msg=path + k, **tol)


def _ep(params, n_ep):
    return dict(params, blocks=ep.ep_shard_blocks(params["blocks"], n_ep))


def test_mesh_places_expert_innermost_and_keeps_every_accessor_at_expert_1(monkeypatch):
    """JAX's device order ``(data, seq, stage, model, expert)``: slot ``(s,
    d, q, m, x)`` is ``devices[(((d * Q + q) * S + s) * N + m) * X + x]``;
    a cell's shards are its ``(expert, seq)`` pairs, expert-major."""
    from tpu_dist_nn_torch.parallel import mesh as mesh_mod

    made = []

    class Recorded(mesh_mod.StageSlot):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(mesh_mod, "StageSlot", Recorded)
    S, D, Q, N, X = 2, 2, 3, 2, 2
    m = build_mesh(MeshSpec(stage=S, data=D, seq=Q, model=N, expert=X), ["cpu"] * 48)
    assert sorted(map(id, m.all_slots)) == sorted(map(id, made)) and len(made) == 48
    for s in range(S):
        for d in range(D):
            for q in range(Q):
                for n in range(N):
                    for x in range(X):
                        assert m.expert_slots[s][d][q][n][x] is made[
                            (((d * Q + q) * S + s) * N + n) * X + x]
                    assert m.seq_slots[s][d][q][n] is m.expert_slots[s][d][q][n][0]
            cells = m.shard_model_slots(s, d)
            assert len(cells) == X * Q
            for x in range(X):
                for q in range(Q):
                    assert all(a is b for a, b in zip(
                        cells[x * Q + q], [m.expert_slots[s][d][q][n][x] for n in range(N)],
                        strict=True))
            assert all(a is c[0] for a, c in zip(m.cell(s, d), cells, strict=True))
            assert m.slots[s][d] is m.expert_slots[s][d][0][0][0]
    assert m.shape["expert"] == X
    made.clear()
    flat = build_mesh(MeshSpec(stage=2, data=2, model=2), ["cpu"] * 8)
    assert flat.expert_slots is None and flat.cell(1, 1) is flat.slots[1][1]
    assert all(a is b for a, b in zip(flat.all_slots, [s for r in flat.seq_slots for c in r
                                                         for q in c for s in q], strict=True))
    with pytest.raises(ValueError, match="x 2 expert"):
        build_mesh(MeshSpec(data=2, expert=2), ["cpu"] * 3)


def test_ep_shard_round_trip_and_refusal_match_jax():
    jcfg, _ = _cfgs()
    jparams, params = _both(0, jcfg)
    jst = jep.ep_shard_blocks(jparams["blocks"], 2)
    st = ep.ep_shard_blocks(params["blocks"], 2)
    assert st["w_up"].shape == (2, 2, 2, 32, 64)
    _close(st, jax.tree.map(np.asarray, jst), dict(rtol=0, atol=0))
    back = ep.ep_unshard_blocks(st)
    for k, v in params["blocks"].items():
        assert torch.equal(back[k], v), k
    with pytest.raises(ValueError) as want:
        jep.ep_shard_blocks(jparams["blocks"], 3)
    with pytest.raises(ValueError) as got:
        ep.ep_shard_blocks(params["blocks"], 3)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("data,n_ep", [(2, 4), (4, 2), (1, 4)])
def test_flat_ep_forward_matches_jax_and_the_grouped_oracle(data, n_ep):
    jcfg, cfg = _cfgs()
    jparams, params = _both(2, jcfg)
    tokens = _tokens(8, 16, 3)
    jfwd = jep.make_ep_lm_forward(jax_build_mesh(JaxMeshSpec(data=data, expert=n_ep)), jcfg)
    want = np.asarray(jax.jit(jfwd)(dict(jparams, blocks=jep.ep_shard_blocks(
        jparams["blocks"], n_ep)), jnp.asarray(tokens)))
    got = ep.make_ep_lm_forward(_mesh(data=data, expert=n_ep), cfg)(_ep(params, n_ep),
                                                                    torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    oracle = ep.moe_forward(params, torch.from_numpy(tokens), cfg, n_groups=data * n_ep)[0]
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("data,n_ep", [(2, 4), (4, 2), (1, 4)])
def test_flat_ep_loss_and_gradients_match_jax(k, data, n_ep):
    jcfg, cfg = _cfgs(router_top_k=k)
    jparams, params = _both(4, jcfg)
    tokens = _tokens(8, 17, 5)
    jloss = jep.make_ep_lm_forward(jax_build_mesh(JaxMeshSpec(data=data, expert=n_ep)), jcfg,
                                   with_loss=True)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        dict(jparams, blocks=jep.ep_shard_blocks(jparams["blocks"], n_ep)), jnp.asarray(tokens))
    loss_fn = ep.make_ep_lm_forward(_mesh(data=data, expert=n_ep), cfg, with_loss=True)
    loss, grads = _value_and_grads(lambda p: loss_fn(p, torch.from_numpy(tokens)),
                                   _ep(params, n_ep))
    np.testing.assert_allclose(loss, float(jl), **LOSS_TOL)
    _close(grads, jax.tree.map(np.asarray, jg), GRAD_TOL)
    assert float(grads["blocks"]["w_router"].abs().max()) > 0
    # expert leaves: each expert's gradient from its own slot's tokens only
    want = _value_and_grads(lambda p: ep.moe_lm_loss(p, torch.from_numpy(tokens), cfg,
                                                     data * n_ep), params)[1]
    for key in ep.EP_SHARDED:
        np.testing.assert_allclose(ep.ep_unshard_blocks(grads["blocks"])[key].numpy(),
                                   want["blocks"][key].numpy(), **GRAD_TOL)


def test_flat_ep_remat_matches_no_remat_and_refuses_what_jax_refuses():
    jcfg, cfg = _cfgs()
    _, params = _both(0, jcfg)
    tokens = torch.from_numpy(_tokens(8, 17, 3))
    m = _mesh(data=4, expert=2)
    got = [_value_and_grads(lambda p: ep.make_ep_lm_forward(m, c, with_loss=True)(p, tokens),
                            _ep(params, 2))
           for c in (cfg, ep.MoEConfig(**dict(SHAPE, remat=True)))]
    assert got[0][0] == got[1][0]
    _close(got[1][1], tree_map(lambda a: a.numpy(), got[0][1]), GRAD_TOL)
    jm = jax_build_mesh(JaxMeshSpec(data=2, expert=2))
    jfwd = jep.make_ep_lm_forward(jm, jcfg)
    jparams = jep.init_moe_transformer(jax.random.key(0), jcfg)
    with pytest.raises(ValueError) as want:
        jfwd(dict(jparams, blocks=jep.ep_shard_blocks(jparams["blocks"], 2)),
             jnp.asarray(_tokens(6, 16, 0)))
    with pytest.raises(ValueError) as err:
        ep.make_ep_lm_forward(_mesh(data=2, expert=2), cfg)(_ep(params, 2),
                                                           torch.from_numpy(_tokens(6, 16, 0)))
    assert str(err.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jep.make_ep_lm_forward(jax_build_mesh(JaxMeshSpec(expert=8)), jcfg)
    with pytest.raises(ValueError) as err:
        ep.make_ep_lm_forward(_mesh(expert=8), cfg)
    assert str(err.value) == str(want.value)


@pytest.mark.parametrize("data,n_ep,n_tp", [(2, 2, 2), (1, 2, 4), (1, 4, 2)])
def test_tp_inside_experts_matches_jax_and_the_flat_ep_loss(data, n_ep, n_tp):
    jcfg, cfg = _cfgs()
    jparams, params = _both(41, jcfg)
    tokens = _tokens(8, 17, 42)
    jloss = jep.make_ep_tp_lm_loss(jax_build_mesh(JaxMeshSpec(model=n_tp, expert=n_ep,
                                                              data=data)), jcfg)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        dict(jparams, blocks=jep.ep_shard_blocks(jparams["blocks"], n_ep)), jnp.asarray(tokens))
    loss_fn = ep.make_ep_tp_lm_loss(_mesh(model=n_tp, expert=n_ep, data=data), cfg)
    loss, grads = _value_and_grads(lambda p: loss_fn(p, torch.from_numpy(tokens)),
                                   _ep(params, n_ep))
    np.testing.assert_allclose(loss, float(jl), **LOSS_TOL)
    _close(grads, jax.tree.map(np.asarray, jg), GRAD_TOL)
    flat = ep.make_ep_lm_forward(_mesh(expert=n_ep, data=data), cfg, with_loss=True)
    np.testing.assert_allclose(loss, float(flat(_ep(params, n_ep), torch.from_numpy(tokens))),
                               **LOSS_TOL)


def test_tp_inside_experts_refuses_an_indivisible_ff_as_jax_does():
    jcfg, cfg = _cfgs()
    with pytest.raises(ValueError) as want:
        jep.make_ep_tp_lm_loss(jax_build_mesh(JaxMeshSpec(model=3, expert=2)), jcfg)
    with pytest.raises(ValueError) as got:
        ep.make_ep_tp_lm_loss(_mesh(model=3, expert=2), cfg)
    assert str(got.value) == str(want.value) and "d_ff" in str(got.value)


def _sp_oracle(cfg, tokens, groups, seq):
    def loss(p):
        ffn = lambda b, h: ep.moe_ffn_apply(b, h, cfg, n_groups=groups, n_seq_groups=seq)  # noqa
        logits, aux = ep.moe_forward(p, tokens, cfg, ffn_fn=ffn)
        from tpu_dist_nn_torch.models.transformer import masked_next_token_ce

        return masked_next_token_ce(logits, tokens) + cfg.router_aux_weight * aux

    return loss


@pytest.mark.parametrize("seq,n_ep,data", [(2, 2, 2), (4, 2, 1)])
def test_sp_ep_ring_matches_jax_and_the_grouped_oracle(seq, n_ep, data):
    jcfg, cfg = _cfgs()
    jparams, params = _both(31, jcfg)
    tokens = _tokens(8, 16, 32)
    jloss = jep.make_sp_ep_lm_loss(jax_build_mesh(JaxMeshSpec(seq=seq, expert=n_ep, data=data)),
                                   jcfg, mode="ring")
    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        dict(jparams, blocks=jep.ep_shard_blocks(jparams["blocks"], n_ep)), jnp.asarray(tokens))

    def jax_oracle(p):
        ffn = lambda b, h: jep.moe_ffn_apply(b, h, jcfg, n_groups=data * n_ep,  # noqa
                                             n_seq_groups=seq)
        logits, aux = jep.moe_forward(p, jnp.asarray(tokens), jcfg, ffn_fn=ffn)
        return jax_masked_ce(logits, jnp.asarray(tokens)) + jcfg.router_aux_weight * aux

    ol = float(jax.jit(jax_oracle)(jparams))
    loss_fn = ep.make_sp_ep_lm_loss(_mesh(seq=seq, expert=n_ep, data=data), cfg, "ring")
    loss, grads = _value_and_grads(lambda p: loss_fn(p, torch.from_numpy(tokens)),
                                   _ep(params, n_ep))
    np.testing.assert_allclose(loss, float(jl), **LOSS_TOL)
    np.testing.assert_allclose(loss, ol, **LOSS_TOL)
    _close(grads, jax.tree.map(np.asarray, jg), GRAD_TOL)


@pytest.mark.parametrize("seq,n_ep,data", [(2, 2, 2), (4, 2, 1)])
def test_sp_ep_ulysses_matches_the_jax_grouped_oracle_and_the_ring(seq, n_ep, data):
    jcfg, cfg = _cfgs()
    jparams, params = _both(33, jcfg)
    tokens = _tokens(8, 16, 34)

    def jax_oracle(p):
        ffn = lambda b, h: jep.moe_ffn_apply(b, h, jcfg, n_groups=data * n_ep,  # noqa
                                             n_seq_groups=seq)
        logits, aux = jep.moe_forward(p, jnp.asarray(tokens), jcfg, ffn_fn=ffn)
        return jax_masked_ce(logits, jnp.asarray(tokens)) + jcfg.router_aux_weight * aux

    jl, jg = jax.jit(jax.value_and_grad(jax_oracle))(jparams)
    m = _mesh(seq=seq, expert=n_ep, data=data)
    got = {}
    for mode in ("ulysses", "ring"):
        loss_fn = ep.make_sp_ep_lm_loss(m, cfg, mode)
        got[mode] = _value_and_grads(lambda p: loss_fn(p, torch.from_numpy(tokens)),
                                     _ep(params, n_ep))
    loss, grads = got["ulysses"]
    np.testing.assert_allclose(loss, float(jl), **LOSS_TOL)
    np.testing.assert_allclose(loss, got["ring"][0], **LOSS_TOL)
    unsharded = dict(grads, blocks=ep.ep_unshard_blocks(grads["blocks"]))
    _close(unsharded, jax.tree.map(np.asarray, jg), GRAD_TOL)
    _close(grads, tree_map(lambda a: a.numpy(), got["ring"][1]), GRAD_TOL)


def test_sp_ep_refuses_what_jax_refuses():
    jcfg, cfg = _cfgs()
    jparams, params = _both(0, jcfg)
    jloss = jep.make_sp_ep_lm_loss(jax_build_mesh(JaxMeshSpec(seq=2, expert=2, data=2)), jcfg)
    loss = ep.make_sp_ep_lm_loss(_mesh(seq=2, expert=2, data=2), cfg)
    for batch, t in ((6, 16), (8, 15), (8, 34)):  # shards, seq split, position table
        with pytest.raises(ValueError) as want:
            jloss(dict(jparams, blocks=jep.ep_shard_blocks(jparams["blocks"], 2)),
                  jnp.asarray(_tokens(batch, t, 0)))
        with pytest.raises(ValueError) as got:
            loss(_ep(params, 2), torch.from_numpy(_tokens(batch, t, 0)))
        assert str(got.value) == str(want.value)


def test_flat_train_steps_match_the_grouped_program_and_learn():
    """One optimizer for each: the flat EP, TP-inside-experts and sp x ep
    steps' losses over three steps equal the grouped single program's
    step (its routing groups), and fall."""
    jcfg, cfg = _cfgs(router_top_k=2)
    _, params = _both(5, jcfg)
    tokens = torch.from_numpy(_tokens(8, 17, 6)).long()
    full = tokens[:, :16]

    def run(step, p, toks):
        opt_state = opt.init(param_leaves(p))
        return [float(step(p, opt_state, toks)[2]) for _ in range(3)]

    def copy(p):
        return tree_map(lambda a: a.clone().requires_grad_(), p)

    opt = build_optimizer(3e-3)
    from tpu_dist_nn_torch.train.lm_trainer import _autograd_step

    for step, p, toks, oracle in (
        (make_moe_lm_train_step(cfg, opt, _mesh(data=2, expert=2)), _ep(params, 2), tokens,
         lambda q, t: ep.moe_lm_loss(q, t, cfg, 4)),
        (make_ep_tp_moe_lm_train_step(_mesh(model=2, expert=2), cfg, opt), _ep(params, 2),
         tokens, lambda q, t: ep.moe_lm_loss(q, t, cfg, 2)),
        (make_sp_moe_lm_train_step(_mesh(seq=2, expert=2), cfg, opt, "ulysses"), _ep(params, 2),
         full, lambda q, t: _sp_oracle(cfg, t, 2, 2)(q)),
    ):
        got = run(step, copy(p), toks)
        want = run(_autograd_step(oracle, opt), copy(params), toks)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert got[-1] < got[0]


def test_route_log_of_flat_ep_under_remat_equals_the_grouped_program():
    """The routes a flat EP step records (2 data replicas x 2 expert
    shards, remat: the recomputes record nothing) are the grouped single
    program's, group for group."""
    jcfg, _ = _cfgs()
    _, params = _both(6, jcfg)
    cfg = ep.MoEConfig(**dict(SHAPE, remat=True, router_top_k=2))
    tokens = torch.from_numpy(_tokens(8, 17, 7))
    logs = []
    for fn, p in ((lambda q: ep.moe_lm_loss(q, tokens, cfg, 4), params),
                  (lambda q: ep.make_ep_lm_forward(_mesh(data=2, expert=2), cfg,
                                                   with_loss=True)(q, tokens), _ep(params, 2))):
        with ep.recording_routes(ep.RouteLog()) as log:
            _value_and_grads(fn, p)
        logs.append(log.layers())
    assert sorted(logs[0]) == sorted(logs[1]) == [0, 1]
    for layer in (0, 1):
        for want, got in zip(logs[0][layer], logs[1][layer]):
            assert want.shape[0] == 4
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
