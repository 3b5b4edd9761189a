"""MoE through the pipeline over CPU slots against the JAX package's, on the CPU.

MoE blocks over stage slots with the experts over each stage's expert
slots, the batch over ``(data, expert)``, on every schedule the JAX
package runs with ``--experts`` (gpipe, 1f1b, interleaved, zb, zb-v)
and pipeline x sequence x expert on gpipe. The same seeded params and
tokens go through the JAX functions on conftest's 8 virtual host devices
and the port's on ``devices=["cpu"] * n`` meshes, and through the
grouped single program (``n_groups = M * data * expert``, ``n_seq_groups
= seq``), at ``tests/test_pipeline_ep.py``'s configuration (4 layers for
the chunked layouts) with the router loss at its default weight 1e-2, so
a wrong aux denominator shows. Tolerances: the loss within rtol 1e-5 /
atol 1e-6, the gradients within rtol 1e-5 / atol 1e-7. Then the layouts,
the trainer's step, ``tdn lm --experts`` in each form on the CPU and the
refusals in the JAX package's texts.
"""

import io
import json
from contextlib import redirect_stderr

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist_nn.models.transformer import masked_next_token_ce as jax_masked_ce
from tpu_dist_nn.parallel import expert_parallel as jep
from tpu_dist_nn.parallel.mesh import MeshSpec as JaxMeshSpec
from tpu_dist_nn.parallel.mesh import build_mesh as jax_build_mesh
from tpu_dist_nn.train import lm_trainer as jlt
from tpu_dist_nn.train.optimizers import build_optimizer as jax_build_optimizer
from tpu_dist_nn_torch.models.transformer import masked_next_token_ce, param_leaves, tree_map
from tpu_dist_nn_torch.parallel import expert_parallel as ep
from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
from tpu_dist_nn_torch.train.lm_trainer import (
    _autograd_step,
    lm_block_layout,
    make_pipeline_moe_lm_train_step,
)
from tpu_dist_nn_torch.train.optimizers import build_optimizer

torch.set_num_threads(1)
SHAPE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_seq_len=16,
             n_experts=4, router_top_k=1)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)
LM = ["lm", "--device", "cpu", "--d-model", "32", "--heads", "4", "--layers", "4",
      "--seq-len", "15", "--steps", "2", "--batch-size", "8", "--eval-batches", "1",
      "--log-every", "1", "--experts", "4"]


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


def _jmesh(**axes):
    return jax_build_mesh(JaxMeshSpec(**axes))


def _close(got: dict, want: dict, tol=GRAD_TOL, path=""):
    for k, v in want.items():
        if isinstance(v, dict):
            _close(got[k], v, tol, f"{path}{k}/")
        else:
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v), err_msg=path + k, **tol)


def _np(tree):
    return tree_map(lambda a: a.detach().numpy(), tree)


def _oracle(cfg, params, tokens, groups, seq=1):
    """The grouped single program's loss and gradients (full rows and
    the masked CE when ``seq > 1``)."""
    p = tree_map(lambda a: a.clone().requires_grad_(), params)
    t = torch.from_numpy(tokens)
    if seq == 1:
        loss = ep.moe_lm_loss(p, t, cfg, groups)
    else:
        ffn = lambda b, h: ep.moe_ffn_apply(b, h, cfg, n_groups=groups, n_seq_groups=seq)  # noqa
        logits, aux = ep.moe_forward(p, t, cfg, ffn_fn=ffn)
        loss = masked_next_token_ce(logits, t) + cfg.router_aux_weight * aux
    loss.backward()
    return float(loss.detach()), _np(tree_map(lambda a: a.grad, p))


LAYOUTS = {
    "pp": (lambda b, S, v, X: jep.shard_blocks_pp_ep(b, S, X), jep.unshard_blocks_pp_ep,
           lambda b, S, v, X: ep.shard_blocks_pp_ep(b, S, X), ep.unshard_blocks_pp_ep),
    "interleaved": (jep.shard_blocks_interleaved_ep, jep.unshard_blocks_interleaved_ep,
                    ep.shard_blocks_interleaved_ep, ep.unshard_blocks_interleaved_ep),
    "vshape": (lambda b, S, v, X: jep.shard_blocks_vshape_ep(b, S, X),
               jep.unshard_blocks_vshape_ep,
               lambda b, S, v, X: ep.shard_blocks_vshape_ep(b, S, X), ep.unshard_blocks_vshape_ep),
}


@pytest.mark.parametrize("layout,S,v,X", [("pp", 2, 1, 2), ("pp", 4, 1, 4),
                                          ("interleaved", 2, 2, 2), ("vshape", 2, 2, 2)])
def test_layouts_equal_jax_and_round_trip(layout, S, v, X):
    jcfg, _ = _cfgs(n_layers=8)
    jparams, params = _both(0, jcfg)
    jshard, _, shard, unshard = LAYOUTS[layout]
    staged = shard(params["blocks"], S, v, X)
    _close(_np(staged), jax.tree.map(np.asarray, jshard(jparams["blocks"], S, v, X)),
           dict(rtol=0, atol=0))
    back = unshard(staged)
    for k, val in params["blocks"].items():
        assert torch.equal(back[k], val), k
    sched = {"pp": "1f1b", "interleaved": "zb", "vshape": "zb-v"}[layout]
    mine, mine_back = lm_block_layout(sched, S, v, ep=X)
    assert all(torch.equal(a, b) for a, b in zip(param_leaves(mine(params["blocks"])),
                                                 param_leaves(staged)))
    assert mine_back is unshard


@pytest.mark.parametrize("stage,expert,data,M", [(2, 2, 2, 1), (2, 2, 1, 2), (2, 4, 1, 1),
                                                 (2, 1, 2, 2)])
def test_gpipe_loss_and_gradients_match_jax_and_the_grouped_oracle(stage, expert, data, M):
    """``make_pipeline_ep_lm_loss`` through autograd, and the GPipe order
    played op by op, against ``jax.grad`` of the JAX gpipe x ep loss."""
    jcfg, cfg = _cfgs()
    jparams, params = _both(1, jcfg)
    groups = M * expert * data
    tokens = _tokens(2 * groups, 17, 2)
    jloss = jep.make_pipeline_ep_lm_loss(_jmesh(stage=stage, expert=expert, data=data), jcfg,
                                         stage, M)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        dict(jparams, blocks=jep.shard_blocks_pp_ep(jparams["blocks"], stage, expert)),
        jnp.asarray(tokens))
    m = _mesh(stage=stage, expert=expert, data=data)
    st = tree_map(lambda a: a.clone().requires_grad_(),
                  dict(params, blocks=ep.shard_blocks_pp_ep(params["blocks"], stage, expert)))
    loss = ep.make_pipeline_ep_lm_loss(m, cfg, stage, M)(st, torch.from_numpy(tokens))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **LOSS_TOL)
    _close(_np(tree_map(lambda a: a.grad, st)), jax.tree.map(np.asarray, jg))
    loss_s, g_s = ep.make_pipeline_ep_lm_gpipe_grad(m, cfg, stage, M)(
        dict(params, blocks=ep.shard_blocks_pp_ep(params["blocks"], stage, expert)),
        torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss_s), float(jl), **LOSS_TOL)
    _close(_np(g_s), jax.tree.map(np.asarray, jg))
    o_loss, o_grads = _oracle(cfg, params, tokens, groups)
    np.testing.assert_allclose(float(loss_s), o_loss, **LOSS_TOL)
    _close(_np(dict(g_s, blocks=ep.unshard_blocks_pp_ep(g_s["blocks"]))), o_grads)


@pytest.mark.parametrize("stage,expert,data,M", [(2, 2, 1, 2), (2, 2, 2, 2), (4, 2, 1, 4)])
def test_1f1b_gradients_match_jax(stage, expert, data, M):
    jcfg, cfg = _cfgs()
    jparams, params = _both(3, jcfg)
    tokens = _tokens(2 * M * expert * data, 17, 4)
    jvag = jep.make_pipeline_ep_lm_1f1b_grad(_jmesh(stage=stage, expert=expert, data=data),
                                             jcfg, stage, M)
    jl, jg = jax.jit(jvag)(
        dict(jparams, blocks=jep.shard_blocks_pp_ep(jparams["blocks"], stage, expert)),
        jnp.asarray(tokens))
    vag = ep.make_pipeline_ep_lm_1f1b_grad(_mesh(stage=stage, expert=expert, data=data), cfg,
                                           stage, M)
    loss, g = vag(dict(params, blocks=ep.shard_blocks_pp_ep(params["blocks"], stage, expert)),
                  torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(jl), **LOSS_TOL)
    _close(_np(g), jax.tree.map(np.asarray, jg))


@pytest.mark.parametrize("variant,data", [("interleaved", 1), ("zb", 1), ("interleaved", 2),
                                          ("zb", 2), ("zb-v", 1), ("zb-v", 2)])
def test_table_schedules_match_jax(variant, data):
    """Interleaved and zb at stage 2 x virtual 2 x expert 2 (the split
    backward's aux input gradient on BWD_B, its weight gradient on
    BWD_W), zb-v on its V of 4 chunks."""
    jcfg, cfg = _cfgs()
    jparams, params = _both(11, jcfg)
    S, v, X, M = 2, 2, 2, 2
    tokens = _tokens(2 * M * X * data, 17, 12)
    jm, m = _jmesh(stage=S, expert=X, data=data), _mesh(stage=S, expert=X, data=data)
    if variant == "zb-v":
        jvag = jep.make_pipeline_ep_lm_zb_v_grad(jm, jcfg, M)
        jst = dict(jparams, blocks=jep.shard_blocks_vshape_ep(jparams["blocks"], S, X))
        vag = ep.make_pipeline_ep_lm_zb_v_grad(m, cfg, M)
    else:
        jvag = getattr(jep, f"make_pipeline_ep_lm_{variant}_grad")(jm, jcfg, v, M)
        jst = dict(jparams, blocks=jep.shard_blocks_interleaved_ep(jparams["blocks"], S, v, X))
        vag = getattr(ep, f"make_pipeline_ep_lm_{variant}_grad")(m, cfg, v, M)
    shard, unshard = lm_block_layout(variant, S, v, ep=X)
    jl, jg = jax.jit(jvag)(jst, jnp.asarray(tokens))
    loss, g = vag(dict(params, blocks=shard(params["blocks"])), torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(jl), **LOSS_TOL)
    _close(_np(g), jax.tree.map(np.asarray, jg))
    o_loss, o_grads = _oracle(cfg, params, tokens, M * X * data)
    np.testing.assert_allclose(float(loss), o_loss, **LOSS_TOL)
    _close(_np(dict(g, blocks=unshard(g["blocks"]))), o_grads)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved", "zb", "zb-v"])
def test_the_router_loss_is_normalised_as_the_oracle_is(schedule):
    """The loss at the default router weight less the loss at weight 0
    is 1e-2 x the grouped oracle's router loss, on every schedule."""
    S, X, M, v = 2, 2, 2, (2 if schedule in ("interleaved", "zb", "zb-v") else 1)
    jcfg, cfg = _cfgs()
    _, params = _both(5, jcfg)
    tokens = _tokens(2 * M * X, 17, 6)
    shard, _ = lm_block_layout(schedule, S, v, ep=X)
    st = dict(params, blocks=shard(params["blocks"]))
    got = []
    for c in (cfg, ep.MoEConfig(**dict(SHAPE, router_aux_weight=0.0))):
        opt = build_optimizer(0.0)
        step = make_pipeline_moe_lm_train_step(_mesh(stage=S, expert=X), c, S, M, opt,
                                               schedule=schedule, num_virtual=v)
        p = tree_map(lambda a: a.clone(), st)
        got.append(float(step(p, opt.init(param_leaves(p)), torch.from_numpy(tokens))[2]))
    aux = float(ep.moe_forward(params, torch.from_numpy(tokens[:, :-1]), cfg, M * X)[1])
    assert aux > 0.5
    np.testing.assert_allclose(got[0] - got[1], cfg.router_aux_weight * aux, rtol=1e-4)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_pp_sp_ep_matches_the_grouped_oracle_and_jax_ring(mode):
    """Stage 2 x seq 2 x expert 2 on gpipe: the loss through autograd and
    the GPipe order played op by op against the grouped oracle
    (``n_groups = M * expert``, ``n_seq_groups = seq``), and the ring
    against the JAX package's three-axis loss."""
    jcfg, cfg = _cfgs()
    jparams, params = _both(51, jcfg)
    M = 2
    tokens = _tokens(4, 16, 52)
    m = _mesh(stage=2, seq=2, expert=2)
    staged = dict(params, blocks=ep.shard_blocks_pp_ep(params["blocks"], 2, 2))
    st = tree_map(lambda a: a.clone().requires_grad_(), staged)
    loss = ep.make_pipeline_sp_ep_lm_loss(m, cfg, 2, M, mode)(st, torch.from_numpy(tokens))
    loss.backward()
    loss_s, g_s = ep.make_pipeline_sp_ep_lm_gpipe_grad(m, cfg, 2, M, mode)(
        staged, torch.from_numpy(tokens))
    o_loss, o_grads = _oracle(cfg, params, tokens, M * 2, seq=2)
    for value, grads in ((float(loss.detach()), tree_map(lambda a: a.grad, st)),
                         (float(loss_s), g_s)):
        np.testing.assert_allclose(value, o_loss, **LOSS_TOL)
        _close(_np(dict(grads, blocks=ep.unshard_blocks_pp_ep(grads["blocks"]))), o_grads)

    def jax_oracle(p):
        ffn = lambda b, h: jep.moe_ffn_apply(b, h, jcfg, n_groups=M * 2, n_seq_groups=2)  # noqa
        logits, aux = jep.moe_forward(p, jnp.asarray(tokens), jcfg, ffn_fn=ffn)
        return jax_masked_ce(logits, jnp.asarray(tokens)) + jcfg.router_aux_weight * aux

    jl, jg = jax.jit(jax.value_and_grad(jax_oracle))(jparams)
    np.testing.assert_allclose(o_loss, float(jl), **LOSS_TOL)
    _close(o_grads, jax.tree.map(np.asarray, jg))
    if mode == "ring":
        jloss = jep.make_pipeline_sp_ep_lm_loss(_jmesh(stage=2, seq=2, expert=2), jcfg, 2, M,
                                                mode="ring")
        jl, jg = jax.jit(jax.value_and_grad(jloss))(
            dict(jparams, blocks=jep.shard_blocks_pp_ep(jparams["blocks"], 2, 2)),
            jnp.asarray(tokens))
        np.testing.assert_allclose(float(loss_s), float(jl), **LOSS_TOL)
        _close(_np(g_s), jax.tree.map(np.asarray, jg))


def test_train_step_matches_the_jax_step_and_refuses_in_its_texts():
    jcfg, cfg = _cfgs()
    jparams, params = _both(7, jcfg)
    tokens = _tokens(8, 17, 8)
    jopt = jax_build_optimizer(3e-3)
    jstep = jlt.make_pipeline_moe_lm_train_step(_jmesh(stage=2, expert=2), jcfg, 2, 2, jopt,
                                                schedule="1f1b")
    jst = dict(jparams, blocks=jep.shard_blocks_pp_ep(jparams["blocks"], 2, 2))
    jstate = jopt.init(jst)
    opt = build_optimizer(3e-3)
    step = make_pipeline_moe_lm_train_step(_mesh(stage=2, expert=2), cfg, 2, 2, opt,
                                           schedule="1f1b")
    st = tree_map(lambda a: a.clone(), dict(params, blocks=ep.shard_blocks_pp_ep(
        params["blocks"], 2, 2)))
    state = opt.init(param_leaves(st))
    got, want = [], []
    for _ in range(3):
        jst, jstate, jl = jstep(jst, jstate, jnp.asarray(tokens))
        want.append(float(jl))
        got.append(float(step(st, state, torch.from_numpy(tokens))[2]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    for kw in (dict(schedule="zb-stash"), dict(schedule="1f1b", sp_mode="ring")):
        with pytest.raises(ValueError) as w:
            jlt.make_pipeline_moe_lm_train_step(_jmesh(stage=2, expert=2), jcfg, 2, 2, jopt, **kw)
        with pytest.raises(ValueError) as g:
            make_pipeline_moe_lm_train_step(_mesh(stage=2, expert=2), cfg, 2, 2, opt, **kw)
        assert str(g.value) == str(w.value)


def test_pp_ep_refuses_an_indivisible_batch_as_jax_does():
    jcfg, cfg = _cfgs()
    jparams, params = _both(0, jcfg)
    jloss = jep.make_pipeline_ep_lm_loss(_jmesh(stage=2, expert=2, data=2), jcfg, 2, 2)
    with pytest.raises(ValueError) as want:
        jloss(dict(jparams, blocks=jep.shard_blocks_pp_ep(jparams["blocks"], 2, 2)),
              jnp.asarray(_tokens(6, 17, 0)))
    staged = dict(params, blocks=ep.shard_blocks_pp_ep(params["blocks"], 2, 2))
    for fn in (ep.make_pipeline_ep_lm_loss(_mesh(stage=2, expert=2, data=2), cfg, 2, 2),
               ep.make_pipeline_ep_lm_1f1b_grad(_mesh(stage=2, expert=2, data=2), cfg, 2, 2)):
        with pytest.raises(ValueError) as got:
            fn(staged, torch.from_numpy(_tokens(6, 17, 0)))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flags", [
    [],
    ["--router-top-k", "2", "--remat"],
    ["--expert-parallel", "2", "--data-parallel", "2"],
    ["--data-parallel", "2"],
    ["--tensor-parallel", "2", "--expert-parallel", "2"],
    ["--seq-parallel", "2", "--sp-mode", "ring", "--expert-parallel", "2"],
    ["--seq-parallel", "2", "--sp-mode", "ulysses", "--expert-parallel", "2"],
    ["--stages", "2", "--expert-parallel", "2", "--schedule", "gpipe"],
    ["--stages", "2", "--expert-parallel", "2", "--schedule", "1f1b"],
    ["--stages", "2", "--expert-parallel", "2", "--schedule", "interleaved"],
    ["--stages", "2", "--expert-parallel", "2", "--schedule", "zb"],
    ["--stages", "2", "--expert-parallel", "2", "--schedule", "zb-v", "--microbatches", "2"],
    ["--stages", "2", "--seq-parallel", "2", "--expert-parallel", "2", "--microbatches", "2"],
], ids=["single", "top2-remat", "ep-dp", "dp", "tp", "sp-ring", "sp-ulysses", "pp-gpipe",
        "pp-1f1b", "pp-interleaved", "pp-zb", "pp-zb-v", "pp-sp"])
def test_cli_lm_trains_each_moe_form(capsys, flags):
    from tpu_dist_nn_torch.cli import main

    assert main(LM + flags) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(report["final_train_loss"]) and report["perplexity"] > 1
    assert report["eval_rows_used"] == 8


def _last_err_lines(flags):
    from tpu_dist_nn.cli import main as tdn_main
    from tpu_dist_nn_torch.cli import main as port_main

    texts = []
    for main, argv in ((port_main, LM + flags),
                       (tdn_main, ["--platform", "cpu"] + [a for a in LM if a not in (
                           "--device", "cpu")] + flags)):
        err = io.StringIO()
        with redirect_stderr(err):
            assert main(argv) == 2
        texts.append(err.getvalue().strip().splitlines()[-1])
    return texts


@pytest.mark.parametrize("flags", [
    ["--zero1", "--data-parallel", "2"],
    ["--fsdp", "--data-parallel", "2"],
    ["--tensor-parallel", "2", "--stages", "2"],
    ["--tensor-parallel", "2", "--seq-parallel", "2"],
    ["--tensor-parallel", "3"],
    ["--seq-parallel", "2", "--stages", "2", "--schedule", "1f1b"],
    ["--stages", "2", "--schedule", "zb-stash"],
    ["--sample-bytes", "4"],
    ["--serve-generate", "0"],
    ["--schedule", "1f1b"],
    ["--expert-parallel", "3"],
    ["--stages", "3"],
    ["--seq-parallel", "3"],
], ids=["zero1", "fsdp", "tp-pp", "tp-sp", "tp-ff", "pp-sp-1f1b", "zb-stash", "sample",
        "serve", "schedule-alone", "batch", "layers", "seq-split"])
def test_cli_refusals_in_jax_texts(flags):
    port, jax_text = _last_err_lines(flags)
    assert port == jax_text


def test_expert_parallel_without_experts_is_refused_in_the_jax_text():
    from tpu_dist_nn.cli import main as tdn_main
    from tpu_dist_nn_torch.cli import main as port_main

    texts = []
    base = LM[:-2]  # without --experts 4
    for main, argv in ((port_main, base + ["--expert-parallel", "2"]),
                       (tdn_main, ["--platform", "cpu"] + [a for a in base if a not in (
                           "--device", "cpu")] + ["--expert-parallel", "2"])):
        err = io.StringIO()
        with redirect_stderr(err):
            assert main(argv) == 2
        texts.append(err.getvalue().strip().splitlines()[-1])
    assert texts[0] == texts[1] and "--experts" in texts[0]


def test_grouped_program_oracle_step_agrees_with_train_lm_on_pipelined_moe():
    """``train_lm`` with a MoE config and a (stage 2, expert 2) mesh:
    its losses are the grouped single program's, and the params come
    back in the standard layout."""
    from tpu_dist_nn_torch.train.lm_trainer import LMTrainConfig, train_lm

    jcfg, cfg = _cfgs()
    _, params = _both(9, jcfg)
    rows = _tokens(16, 17, 10)
    batches = [rows[:8], rows[8:]]
    trained, hist = train_lm(params, cfg, batches,
                             LMTrainConfig(steps=2, batch_size=8, seq_len=16, log_every=1,
                                           learning_rate=3e-3),
                             mesh=_mesh(stage=2, expert=2), num_stages=2, num_microbatches=2,
                             schedule="zb-v", num_virtual=2)
    opt = build_optimizer(3e-3, total_steps=2)
    step = _autograd_step(lambda p, t: ep.moe_lm_loss(p, t, cfg, 4), opt)
    p = tree_map(lambda a: a.clone().requires_grad_(), params)
    state = opt.init(param_leaves(p))
    want = [float(step(p, state, torch.from_numpy(b).long())[2]) for b in batches]
    np.testing.assert_allclose([h["loss"] for h in hist], want, rtol=1e-5)
    assert all(a.shape == b.shape for a, b in zip(param_leaves(trained), param_leaves(params)))
