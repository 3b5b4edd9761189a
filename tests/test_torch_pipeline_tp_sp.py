"""PP x TP x SP over CPU slots (pipeline depth x Megatron width x
sequence length), against the JAX package's, on the CPU.

Each seq shard's Megatron block runs on its model slots, attention over
the seq slots of each model shard on its local heads. The same seeded
params and full rows go through the JAX functions on conftest's 8
virtual host devices and through the port's on ``devices=["cpu"] * 8``
meshes (stage 2 x model 2 x seq 2). Tolerances are
``tests/test_pipeline_tp_sp.py``'s: losses rtol 1e-5, gradients rtol
5e-4 / atol 1e-5.
"""

import io
import json
from contextlib import redirect_stderr

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist_nn.models.transformer import TransformerConfig as JaxConfig
from tpu_dist_nn.models.transformer import init_transformer as jax_init
from tpu_dist_nn.parallel import transformer_pipeline as jtpl
from tpu_dist_nn.parallel.mesh import MeshSpec as JaxMeshSpec
from tpu_dist_nn.parallel.mesh import build_mesh as jax_build_mesh
from tpu_dist_nn.train import lm_trainer as jlt
from tpu_dist_nn.train.optimizers import build_optimizer as jax_build_optimizer
from tpu_dist_nn_torch.models.transformer import (
    TransformerConfig,
    forward,
    masked_next_token_ce,
    param_leaves,
    transformer_params_from_jax,
    tree_map,
)
from tpu_dist_nn_torch.parallel import transformer_pipeline as tpl
from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
from tpu_dist_nn_torch.train.lm_trainer import lm_block_layout, make_pipeline_sp_lm_train_step
from tpu_dist_nn_torch.train.optimizers import build_optimizer

torch.set_num_threads(1)
SHAPE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_seq_len=16)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)


def _setup(seed, tok_seed, schedule="1f1b", v=1):
    jcfg, cfg = JaxConfig(**SHAPE), TransformerConfig(**SHAPE)
    jparams = jax_init(jax.random.key(seed), jcfg)
    params = transformer_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jshard, _ = jlt.lm_block_layout(schedule, 2, v, cfg=jcfg, tp=2)
    shard, unshard = lm_block_layout(schedule, 2, v, cfg=cfg, tp=2)
    tokens = np.random.default_rng(tok_seed).integers(0, 64, (4, 16)).astype(np.int32)
    return (jcfg, dict(jparams, blocks=jshard(jparams["blocks"])), cfg,
            dict(params, blocks=shard(params["blocks"])), params, unshard, tokens)


def _meshes():
    spec = MeshSpec(stage=2, model=2, seq=2)
    return (jax_build_mesh(JaxMeshSpec(stage=2, model=2, seq=2)),
            build_mesh(spec, ["cpu"] * spec.num_devices))


def _check(loss, grads, jl, jg, params, cfg, unshard, tokens):
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for got, want in zip(param_leaves(grads), jax.tree.leaves(jg)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **GRAD_TOL)
    # and the single program's masked CE, through the standard layout
    p = tree_map(lambda a: a.clone().requires_grad_(), params)
    t = torch.from_numpy(tokens)
    ref = masked_next_token_ce(forward(p, t, cfg), t)
    g_ref = torch.autograd.grad(ref, param_leaves(p))
    flat = param_leaves(dict(grads, blocks=unshard(grads["blocks"])))
    np.testing.assert_allclose(float(loss), float(ref.detach()), rtol=1e-5)
    for got, want in zip(flat, g_ref):
        np.testing.assert_allclose(got.detach().numpy(), want.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_pp_tp_sp_1f1b_gradients_match_jax(mode):
    jcfg, jst, cfg, st, params, unshard, tokens = _setup(17, 18)
    jm, m = _meshes()
    jl, jg = jax.jit(jtpl.make_pipeline_tp_sp_lm_1f1b_grad(jm, jcfg, 2, 2, mode=mode))(
        jst, jnp.asarray(tokens))
    loss, g = tpl.make_pipeline_tp_sp_lm_1f1b_grad(m, cfg, 2, 2, mode)(st, torch.from_numpy(tokens))
    _check(loss, g, jl, jg, params, cfg, unshard, tokens)


@pytest.mark.parametrize("variant,mode", [("interleaved", "ring"), ("zb", "ring"),
                                          ("zb-v", "ulysses")])
def test_pp_tp_sp_table_schedules_match_jax(variant, mode):
    jcfg, jst, cfg, st, params, unshard, tokens = _setup(19, 20, variant, 2)
    jm, m = _meshes()
    if variant == "zb-v":
        jvag = jtpl.make_pipeline_tp_sp_lm_zb_v_grad(jm, jcfg, 2, mode=mode)
        vag = tpl.make_pipeline_tp_sp_lm_zb_v_grad(m, cfg, 2, mode)
    else:
        jvag = getattr(jtpl, f"make_pipeline_tp_sp_lm_{variant}_grad")(jm, jcfg, 2, 2, mode=mode)
        vag = getattr(tpl, f"make_pipeline_tp_sp_lm_{variant}_grad")(m, cfg, 2, 2, mode)
    jl, jg = jax.jit(jvag)(jst, jnp.asarray(tokens))
    loss, g = vag(st, torch.from_numpy(tokens))
    _check(loss, g, jl, jg, params, cfg, unshard, tokens)


def test_pp_tp_sp_gpipe_loss_and_schedule_match_jax():
    """The GPipe member: the loss through the forward, differentiated by
    autograd, and the op-by-op gpipe gradient, against ``jax.grad`` of the
    JAX 3-way loss."""
    jcfg, jst, cfg, st, params, unshard, tokens = _setup(29, 30, "gpipe")
    jm, m = _meshes()
    jl, jg = jax.jit(jax.value_and_grad(jtpl.make_pipeline_tp_sp_lm_loss(jm, jcfg, 2, 2)))(
        jst, jnp.asarray(tokens))
    p = tree_map(lambda a: a.clone().requires_grad_(), st)
    loss = tpl.make_pipeline_tp_sp_lm_loss(m, cfg, 2, 2)(p, torch.from_numpy(tokens))
    grads = torch.autograd.grad(loss, param_leaves(p))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for got, want in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    loss_s, g_s = tpl.make_pipeline_tp_sp_lm_gpipe_grad(m, cfg, 2, 2)(st, torch.from_numpy(tokens))
    _check(loss_s, g_s, jl, jg, params, cfg, unshard, tokens)


def test_pp_tp_sp_ulysses_refuses_an_indivisible_local_head_split():
    cfg = TransformerConfig(**dict(SHAPE, n_heads=2, d_model=32))
    _, m = _meshes()
    with pytest.raises(ValueError, match=r"n_heads / model \(2 / 2 = 1 local heads\) divisible"):
        tpl.make_pipeline_tp_sp_lm_1f1b_grad(m, cfg, 2, 2, "ulysses")


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_pp_tp_sp_train_step_losses_match_jax(schedule):
    jcfg, jst, cfg, st, _, _, _ = _setup(23, 24, schedule)
    jm, m = _meshes()
    jopt, opt = jax_build_optimizer(1e-2), build_optimizer(1e-2)
    jstep = jax.jit(jlt.make_pipeline_sp_lm_train_step(jm, jcfg, 2, 2, jopt, mode="ring",
                                                       schedule=schedule, tensor_parallel=2))
    step = make_pipeline_sp_lm_train_step(m, cfg, 2, 2, opt, "ring", schedule=schedule,
                                          tensor_parallel=2)
    st = tree_map(lambda a: a.clone(), st)
    before = st["blocks"]["w_qkv"].clone()
    jstate, state = jopt.init(jst), opt.init(param_leaves(st))
    for i in range(2):
        tokens = np.random.default_rng(40 + i).integers(0, 64, (4, 16)).astype(np.int32)
        jst, jstate, jl = jstep(jst, jstate, jnp.asarray(tokens))
        st, state, loss = step(st, state, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5 if i == 0 else 1e-4)
    assert not torch.equal(st["blocks"]["w_qkv"], before)
    with pytest.raises(ValueError) as jerr:
        jlt.make_pipeline_sp_lm_train_step(jax_build_mesh(JaxMeshSpec(stage=2, seq=2)), jcfg, 2,
                                           2, jopt, tensor_parallel=2)
    with pytest.raises(ValueError) as err:
        make_pipeline_sp_lm_train_step(build_mesh(MeshSpec(stage=2, seq=2), ["cpu"] * 4), cfg, 2,
                                       2, opt, tensor_parallel=2)
    assert str(err.value) == str(jerr.value)


def test_cli_lm_stages_tensor_parallel_seq_parallel_1f1b(capsys):
    from tpu_dist_nn_torch.cli import main

    assert main(["lm", "--device", "cpu", "--steps", "2", "--batch-size", "4", "--seq-len", "15",
                 "--d-model", "16", "--heads", "2", "--layers", "2", "--eval-batches", "2",
                 "--stages", "2", "--tensor-parallel", "2", "--seq-parallel", "2",
                 "--schedule", "1f1b", "--microbatches", "2"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(report["final_train_loss"]) and report["perplexity"] > 0


@pytest.mark.parametrize("flags", [
    ["--tensor-parallel", "2", "--seq-parallel", "2"],
    ["--stages", "2", "--tensor-parallel", "2", "--seq-parallel", "2", "--sp-mode",
     "ulysses", "--heads", "2"],
], ids=["tp-no-stages", "ulysses-local-heads"])
def test_cli_pp_tp_sp_refusals_with_jax_texts(flags):
    from tpu_dist_nn.cli import main as tdn_main
    from tpu_dist_nn_torch.cli import main as port_main

    argv = ["lm", "--steps", "1", "--batch-size", "4", "--seq-len", "15", "--d-model", "16",
            "--layers", "2", "--microbatches", "2", "--eval-batches", "1"] + flags
    texts = []
    for main, args in ((port_main, argv + ["--device", "cpu"]),
                       (tdn_main, ["--platform", "cpu"] + argv)):
        err = io.StringIO()
        with redirect_stderr(err):
            rc = main(args)
        texts.append((rc, err.getvalue().strip().splitlines()[-1]))
    assert texts[0][0] == 2 and texts[0][1] in texts[1][1]
