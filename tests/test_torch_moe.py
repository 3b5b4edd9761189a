"""The mixture-of-experts single program against the JAX package's, on the CPU.

The same seeded params (``moe_params_from_jax`` of the JAX
``init_moe_transformer``) and tokens go through the JAX package's
routing, grouped FFN and loss and through the port's, at
``tests/test_expert_parallel.py``'s configuration (vocab 64, d 32, 4
heads, 2 layers, d_ff 64, 4 experts, capacity 1.5) and tolerances: the
dispatch one-hot bit for bit, gates and logits within 2e-5, the loss
within rtol 1e-5 / atol 1e-6, the gradients within rtol 1e-5 / atol 1e-7
(remat against none: the same). The port routes by index; the JAX
package's one-hot ``(S, E, C)`` tensors are rebuilt from the port's
routes (``routes_to_onehot``) only to compare them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist_nn.models.transformer import masked_next_token_ce as jax_masked_ce
from tpu_dist_nn.parallel import expert_parallel as jep
from tpu_dist_nn.train import lm_trainer as jlt
from tpu_dist_nn.train.optimizers import build_optimizer as jax_build_optimizer
from tpu_dist_nn_torch.models.transformer import masked_next_token_ce, param_leaves, tree_map
from tpu_dist_nn_torch.parallel import expert_parallel as ep
from tpu_dist_nn_torch.train.lm_trainer import (
    LMTrainConfig,
    evaluate_moe_lm,
    make_moe_lm_train_step,
    train_lm,
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


def _grads(loss_fn, params):
    p = tree_map(lambda a: a.clone().requires_grad_(), params)
    loss = loss_fn(p)
    return float(loss.detach()), torch.autograd.grad(loss, param_leaves(p))


def _close_leaves(got, want, tol):
    for g, w in zip(got, jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def _xw(s, d, e, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((s, d)).astype(np.float32),
            rng.standard_normal((d, e)).astype(np.float32))


@pytest.mark.parametrize("k,capacity", [(1, 3), (1, 12), (2, 4), (2, 16)])
def test_routing_matches_jax_dispatch_combine_and_aux(k, capacity):
    x, w = _xw(24, 8, 4, 1)
    jd, jc, jaux = jep.route_topk(jnp.asarray(x), jnp.asarray(w), capacity, k)
    routes = ep.route_topk(torch.from_numpy(x), torch.from_numpy(w), capacity, k)
    d, c = ep.routes_to_onehot(routes, 4, capacity)
    assert d.shape == (24, 4, capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **LOGIT_TOL)
    np.testing.assert_allclose(float(routes.aux), float(jaux), rtol=1e-6)
    # a token in at most k slots, a slot holding at most one token
    assert float(d.sum(dim=(1, 2)).max()) <= k and float(d.sum(dim=0).max()) <= 1.0


def test_overflow_drops_and_dropped_tokens_pass_through():
    # every token prefers expert 1: only `capacity` of them get a slot
    x = torch.ones((10, 4))
    w = torch.zeros((4, 3))
    w[:, 1] = 5.0
    routes = ep.route_top1(x, w, capacity=4)
    d, _ = ep.routes_to_onehot(routes, 3, 4)
    assert float(d.sum()) == 4.0 and float(d[:, 1].sum()) == 4.0
    assert routes.kept[:, 0].tolist() == [True] * 4 + [False] * 6
    assert (routes.slot[4:, 0] == 3 * 4).all()  # the dump row
    # capacity so small most tokens drop: their FFN output is exactly 0
    jcfg, cfg = _cfgs(vocab_size=16, d_model=8, n_heads=2, n_layers=1, d_ff=16, max_seq_len=8,
                      n_experts=2, capacity_factor=0.1)
    _, params = _both(0, jcfg)
    block = {k: v[0] for k, v in params["blocks"].items()}
    h = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8, 8)).astype(np.float32))
    y, _ = ep.moe_ffn_apply(block, h, cfg)
    contributions = y.abs().sum(-1).flatten()
    assert int((contributions == 0).sum()) > 0 and int((contributions > 0).sum()) > 0


def test_top2_fills_rank_by_rank_and_renormalises_gates():
    # all tokens prefer expert 0 then expert 1: each holds exactly cap of
    # its rank's tokens, no slot holds two
    x = torch.ones((6, 1))
    w = torch.tensor([[3.0, 2.0, -5.0]])
    routes = ep.route_topk(x, w, capacity=2, k=2)
    d, _ = ep.routes_to_onehot(routes, 3, 2)
    assert float(d[:, 0].sum()) == 2 and float(d[:, 1].sum()) == 2
    assert (d.sum(dim=0) <= 1.0).all()
    # with room for all, every token in 2 slots, gates summing to 1, the
    # two experts the router's two largest
    x, w = _xw(16, 8, 4, 1)
    routes = ep.route_topk(torch.from_numpy(x), torch.from_numpy(w), capacity=16, k=2)
    d, c = ep.routes_to_onehot(routes, 4, 16)
    np.testing.assert_array_equal(d.sum(dim=(1, 2)).numpy(), np.full(16, 2.0))
    np.testing.assert_allclose(c.sum(dim=(1, 2)).numpy(), np.ones(16), rtol=1e-6)
    probs = torch.softmax(torch.from_numpy(x @ w), -1).numpy()
    for s in range(16):
        assert set(routes.top[s].tolist()) == set(np.argsort(probs[s])[-2:])


def test_k1_is_top1_and_ties_go_to_the_lower_index_as_lax_top_k():
    x, w = _xw(32, 8, 4, 0)
    a = ep.route_top1(torch.from_numpy(x), torch.from_numpy(w), capacity=12)
    b = ep.route_topk(torch.from_numpy(x), torch.from_numpy(w), capacity=12, k=1)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    # exact ties: equal logits for experts 1, 2 and 3
    x = torch.ones((5, 2))
    w = torch.tensor([[0.0, 1.0, 1.0, 1.0], [0.0, 1.0, 1.0, 1.0]])
    for k in (1, 2):
        routes = ep.route_topk(x, w, capacity=5, k=k)
        jd, _, _ = jep.route_topk(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), 5, k)
        assert routes.top[0].tolist() == [1, 2][:k]
        np.testing.assert_array_equal(ep.routes_to_onehot(routes, 4, 5)[0].numpy(),
                                      np.asarray(jd))


def test_capacity_scales_with_top_k_and_k_is_validated_as_jax_does():
    base = dict(SHAPE, capacity_factor=1.25)
    for k in (1, 2):
        for s in (1, 7, 256, 1000):
            assert (ep.MoEConfig(**base, router_top_k=k).capacity(s)
                    == jep.MoEConfig(**base, router_top_k=k).capacity(s))
    assert ep.MoEConfig(**base, router_top_k=2).capacity(256) == 160
    with pytest.raises(ValueError) as want:
        jep.MoEConfig(**dict(base, n_experts=1), router_top_k=2)
    with pytest.raises(ValueError) as got:
        ep.MoEConfig(**dict(base, n_experts=1), router_top_k=2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("groups,seq_groups", [(1, 1), (4, 1), (2, 2), (1, 4)])
def test_moe_ffn_apply_matches_jax(k, groups, seq_groups):
    jcfg, cfg = _cfgs(router_top_k=k)
    jparams, params = _both(2, jcfg)
    jblock = jax.tree.map(lambda a: a[0], jparams["blocks"])
    block = {key: v[0] for key, v in params["blocks"].items()}
    h = np.random.default_rng(3).standard_normal((4, 8, 32)).astype(np.float32)
    jy, jaux = jep.moe_ffn_apply(jblock, jnp.asarray(h), jcfg, groups, seq_groups)
    y, aux = ep.moe_ffn_apply(block, torch.from_numpy(h), cfg, groups, seq_groups)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **LOSS_TOL)


def test_moe_ffn_apply_refuses_what_jax_refuses():
    jcfg, cfg = _cfgs()
    jparams, params = _both(2, jcfg)
    jblock = jax.tree.map(lambda a: a[0], jparams["blocks"])
    block = {key: v[0] for key, v in params["blocks"].items()}
    for shape, g, q in (((3, 5, 32), 2, 1), ((3, 8, 32), 2, 2), ((4, 6, 32), 2, 4)):
        h = np.zeros(shape, np.float32)
        with pytest.raises(ValueError) as want:
            jep.moe_ffn_apply(jblock, jnp.asarray(h), jcfg, g, q)
        with pytest.raises(ValueError) as got:
            ep.moe_ffn_apply(block, torch.from_numpy(h), cfg, g, q)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("groups", [1, 4])
def test_forward_loss_and_gradients_match_jax(k, groups):
    jcfg, cfg = _cfgs(router_top_k=k)
    jparams, params = _both(4, jcfg)
    tokens = _tokens(8, 17, 5)
    jlogits, jaux = jep.moe_forward(jparams, jnp.asarray(tokens[:, :-1]), jcfg, groups)
    logits, aux = ep.moe_forward(params, torch.from_numpy(tokens[:, :-1]), cfg, groups)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **LOSS_TOL)
    jl, jg = jax.value_and_grad(lambda p: jep.moe_lm_loss(p, jnp.asarray(tokens), jcfg,
                                                          groups))(jparams)
    loss, grads = _grads(lambda p: ep.moe_lm_loss(p, torch.from_numpy(tokens), cfg, groups),
                         params)
    np.testing.assert_allclose(loss, float(jl), **LOSS_TOL)
    _close_leaves(grads, jg, GRAD_TOL)
    # the router learns only through the gates and the aux loss
    i = [n for n in sorted(params["blocks"])].index("w_router")
    assert float(grads[i].abs().max()) > 0


def test_seq_grouped_oracle_matches_jax():
    """The sp x ep oracle: ``(batch slice x seq slice)`` groups and the
    masked CE on full rows."""
    jcfg, cfg = _cfgs()
    jparams, params = _both(31, jcfg)
    tokens = _tokens(8, 16, 32)

    def jloss(p):
        ffn = lambda b, h: jep.moe_ffn_apply(b, h, jcfg, n_groups=4, n_seq_groups=2)  # noqa
        logits, aux = jep.moe_forward(p, jnp.asarray(tokens), jcfg, ffn_fn=ffn)
        return jax_masked_ce(logits, jnp.asarray(tokens)) + jcfg.router_aux_weight * aux

    def loss(p):
        ffn = lambda b, h: ep.moe_ffn_apply(b, h, cfg, n_groups=4, n_seq_groups=2)  # noqa
        logits, aux = ep.moe_forward(p, torch.from_numpy(tokens), cfg, ffn_fn=ffn)
        return masked_next_token_ce(logits, torch.from_numpy(tokens)) + cfg.router_aux_weight * aux

    jl, jg = jax.value_and_grad(jloss)(jparams)
    got, grads = _grads(loss, params)
    np.testing.assert_allclose(got, float(jl), **LOSS_TOL)
    _close_leaves(grads, jg, GRAD_TOL)


def test_remat_matches_no_remat():
    jcfg, cfg = _cfgs(router_top_k=2)
    _, params = _both(0, jcfg)
    tokens = torch.from_numpy(_tokens(8, 17, 3))
    l0, g0 = _grads(lambda p: ep.moe_lm_loss(p, tokens, cfg, 2), params)
    l1, g1 = _grads(lambda p: ep.moe_lm_loss(p, tokens, dataclasses.replace(cfg, remat=True), 2),
                    params)
    assert l0 == l1
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def test_params_from_jax_carry_every_leaf_and_init_draws_jax_shapes():
    jcfg, cfg = _cfgs()
    jparams, params = _both(7, jcfg)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        keys = [k.key for k in path]
        got = params
        for key in keys:
            got = got[key]
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    assert params["blocks"]["w_up"].shape == (2, 4, 32, 64)
    assert params["blocks"]["b_down"].shape == (2, 4, 32)
    mine = ep.init_moe_transformer(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert jax.tree.map(np.shape, jparams) == tree_map(lambda a: tuple(a.shape), mine)
    assert float(mine["blocks"]["b_up"].abs().max()) == 0.0
    with pytest.raises(ValueError, match="not MoE params"):
        ep.moe_params_from_jax({"blocks": {"w_qkv": np.zeros((1, 2, 6))}}, device="cpu")


def test_train_step_losses_match_jax_and_fall():
    """Three steps of the single MoE program (top-2) against the JAX
    package's ``make_moe_lm_train_step`` with its optimizer."""
    jcfg, cfg = _cfgs(router_top_k=2)
    jparams, params = _both(1, jcfg)
    tokens = _tokens(8, 17, 2)
    jopt = jax_build_optimizer(3e-3)
    jstep = jlt.make_moe_lm_train_step(jcfg, jopt, attn_fn=jep.dot_product_attention)
    jstate = jopt.init(jparams)
    opt = build_optimizer(3e-3)
    step = make_moe_lm_train_step(cfg, opt)
    p = tree_map(lambda a: a.clone().requires_grad_(), params)
    state = opt.init(param_leaves(p))
    got, want = [], []
    for _ in range(3):
        jparams, jstate, jl = jstep(jparams, jstate, jnp.asarray(tokens))
        want.append(float(jl))
        got.append(float(step(p, state, torch.from_numpy(tokens).long())[2]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_train_lm_and_evaluate_moe_lm_match_jax():
    jcfg, cfg = _cfgs()
    jparams, params = _both(9, jcfg)
    rows = _tokens(16, 17, 10)
    batches = [rows[:8], rows[8:]]
    from tpu_dist_nn.train.lm_trainer import LMTrainConfig as JaxTrainConfig

    jtrained, jhist = jlt.train_lm(
        jparams, jcfg, batches, JaxTrainConfig(steps=2, batch_size=8, seq_len=16, log_every=1),
        step_fn=lambda opt: jlt.make_moe_lm_train_step(jcfg, opt,
                                                      attn_fn=jep.dot_product_attention))
    trained, hist = train_lm(params, cfg, batches,
                             LMTrainConfig(steps=2, batch_size=8, seq_len=16, log_every=1))
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist], rtol=1e-5)
    want = jlt.evaluate_moe_lm(jtrained, jcfg, rows, batch_size=8)
    got = evaluate_moe_lm(trained, cfg, rows, batch_size=8)
    np.testing.assert_allclose(got["loss_nats_per_token"], want["loss_nats_per_token"],
                               rtol=1e-4)
    assert got["eval_rows_used"] == want["eval_rows_used"] == 16


def test_route_log_records_each_layer_and_group_once_under_remat():
    jcfg, cfg = _cfgs(router_top_k=2, remat=True)
    _, params = _both(3, jcfg)
    tokens = torch.from_numpy(_tokens(8, 17, 4))
    with ep.recording_routes(ep.RouteLog()) as log:
        _grads(lambda p: ep.moe_lm_loss(p, tokens, cfg, 4), params)
    ep.moe_lm_loss(params, tokens, cfg, 4)  # outside the block: not recorded
    assert sorted(log.entries) == [(0, 0), (1, 0)]  # the remat recompute is not recorded
    top, kept, probs = log.layers()[0]
    assert top.shape == (4, 32, 2) and kept.shape == (4, 32, 2) and probs.shape == (4, 32, 4)
    assert torch.equal(top[..., 0], probs.argmax(-1))
