"""Pipeline x sequence parallelism over CPU slots, against the JAX
package's, on the CPU.

Blocks over stage slots, each microbatch's sequence over seq slots (ring
or Ulysses attention in the stages), the batch over data slots. The same
seeded params and full (input + target) rows go through the JAX
functions on conftest's 8 virtual host devices and through the port's on
``devices=["cpu"] * n`` meshes. Tolerances are
``tests/test_pipeline_sp.py``'s: forwards rtol 2e-5 / atol 2e-5, losses
rtol 1e-5, gradients rtol 5e-4 / atol 1e-5.
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
from tpu_dist_nn.parallel import ring_attention as jra
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
from tpu_dist_nn_torch.parallel import ring_attention as ra
from tpu_dist_nn_torch.parallel import transformer_pipeline as tpl
from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
from tpu_dist_nn_torch.train.lm_trainer import (
    lm_block_layout,
    make_pipeline_lm_train_step,
    make_pipeline_sp_lm_train_step,
)
from tpu_dist_nn_torch.train.optimizers import build_optimizer

torch.set_num_threads(1)
SHAPE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_seq_len=16)
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)


def _cfgs(**over):
    shape = dict(SHAPE, **over)
    return JaxConfig(**shape), TransformerConfig(**shape)


def _both(seed, jcfg):
    jparams = jax_init(jax.random.key(seed), jcfg)
    return jparams, transformer_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _tokens(batch, t, seed):
    return np.random.default_rng(seed).integers(0, 64, (batch, t)).astype(np.int32)


def _mesh(stage, seq, data=1, model=1):
    spec = MeshSpec(stage=stage, seq=seq, data=data, model=model)
    return build_mesh(spec, ["cpu"] * spec.num_devices)


def _jmesh(stage, seq, data=1, model=1):
    return jax_build_mesh(JaxMeshSpec(stage=stage, seq=seq, data=data, model=model))


def _close(got: dict, want: dict, tol, path=""):
    for k, v in want.items():
        if isinstance(v, dict):
            _close(got[k], v, tol, f"{path}{k}/")
        else:
            np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(v), err_msg=path + k,
                                       **tol)


@pytest.mark.parametrize("stage,seq,data,mode", [(2, 2, 2, "ring"), (2, 4, 1, "ring"),
                                                 (2, 2, 2, "ulysses")])
def test_pp_sp_forward_matches_jax_and_the_single_program(stage, seq, data, mode):
    jcfg, cfg = _cfgs()
    jparams, params = _both(1, jcfg)
    tokens = _tokens(8, 16, 2)
    jfwd = jtpl.make_pipeline_sp_lm_forward(_jmesh(stage, seq, data), jcfg, stage, 2, mode=mode)
    want = np.asarray(jax.jit(jfwd)(dict(jparams, blocks=jtpl.shard_blocks(jparams["blocks"],
                                                                            stage)),
                                    jnp.asarray(tokens)))
    fwd = tpl.make_pipeline_sp_lm_forward(_mesh(stage, seq, data), cfg, stage, 2, mode)
    got = fwd(dict(params, blocks=tpl.shard_blocks(params["blocks"], stage)),
              torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    np.testing.assert_allclose(got.numpy(), forward(params, torch.from_numpy(tokens), cfg).numpy(),
                               **FWD_TOL)


def test_pp_sp_loss_and_gradients_match_jax():
    """The GPipe member: ``make_pipeline_sp_lm_loss`` differentiated by
    autograd, and the schedule played op by op
    (``make_pipeline_sp_lm_gpipe_grad``), against ``jax.grad`` of the JAX
    pp x sp loss (stage 2 x seq 2 x data 2)."""
    jcfg, cfg = _cfgs()
    jparams, params = _both(3, jcfg)
    tokens = _tokens(8, 16, 4)
    jloss = jtpl.make_pipeline_sp_lm_loss(_jmesh(2, 2, 2), jcfg, 2, 2)
    jst = dict(jparams, blocks=jtpl.shard_blocks(jparams["blocks"], 2))
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jst, jnp.asarray(tokens))
    m = _mesh(2, 2, 2)
    st = tree_map(lambda a: a.clone().requires_grad_(),
                  dict(params, blocks=tpl.shard_blocks(params["blocks"], 2)))
    loss = tpl.make_pipeline_sp_lm_loss(m, cfg, 2, 2)(st, torch.from_numpy(tokens))
    grads = torch.autograd.grad(loss, param_leaves(st))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for g, w in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
    loss_s, g_s = tpl.make_pipeline_sp_lm_gpipe_grad(m, cfg, 2, 2)(st, torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss_s), float(jl), rtol=1e-5)
    _close(g_s, jax.tree.map(np.asarray, jg), GRAD_TOL)


@pytest.mark.parametrize("seq,data,mode", [(2, 2, "ulysses"), (4, 1, "ulysses"), (2, 2, "ring"),
                                           (4, 1, "ring")])
def test_pp_sp_1f1b_gradients_match_jax(seq, data, mode):
    jcfg, cfg = _cfgs()
    jparams, params = _both(11, jcfg)
    tokens = _tokens(8, 16, 12)
    jvag = jtpl.make_pipeline_sp_lm_1f1b_grad(_jmesh(2, seq, data), jcfg, 2, 2, mode=mode)
    jl, jg = jax.jit(jvag)(dict(jparams, blocks=jtpl.shard_blocks(jparams["blocks"], 2)),
                           jnp.asarray(tokens))
    vag = tpl.make_pipeline_sp_lm_1f1b_grad(_mesh(2, seq, data), cfg, 2, 2, mode)
    loss, g = vag(dict(params, blocks=tpl.shard_blocks(params["blocks"], 2)),
                  torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _close(g, jax.tree.map(np.asarray, jg), GRAD_TOL)


@pytest.mark.parametrize("variant,mode", [("interleaved", "ulysses"), ("zb", "ulysses"),
                                          ("interleaved", "ring"), ("zb", "ring"),
                                          ("zb-v", "ring"), ("zb-v", "ulysses")])
def test_pp_sp_table_schedules_match_jax(variant, mode):
    """Interleaved and zb at stage 2 x virtual 2 x seq 2 x data 2
    (tests/test_pipeline_sp.py's), and zb-v (its V of 4 chunks) at stage 2
    x seq 2."""
    jcfg, cfg = _cfgs()
    jparams, params = _both(13, jcfg)
    tokens = _tokens(8, 16, 14)
    data = 1 if variant == "zb-v" else 2
    jm, m = _jmesh(2, 2, data), _mesh(2, 2, data)
    if variant == "zb-v":
        jvag = jtpl.make_pipeline_sp_lm_zb_v_grad(jm, jcfg, 2, mode=mode)
        jst = dict(jparams, blocks=jtpl.shard_blocks_vshape(jparams["blocks"], 2))
        vag = tpl.make_pipeline_sp_lm_zb_v_grad(m, cfg, 2, mode)
    else:
        make = "interleaved" if variant == "interleaved" else "zb"
        jvag = getattr(jtpl, f"make_pipeline_sp_lm_{make}_grad")(jm, jcfg, 2, 2, mode=mode)
        jst = dict(jparams, blocks=jtpl.shard_blocks_interleaved(jparams["blocks"], 2, 2))
        vag = getattr(tpl, f"make_pipeline_sp_lm_{make}_grad")(m, cfg, 2, 2, mode)
    shard, _ = lm_block_layout(variant, 2, 2, cfg=cfg)
    jl, jg = jax.jit(jvag)(jst, jnp.asarray(tokens))
    loss, g = vag(dict(params, blocks=shard(params["blocks"])), torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _close(g, jax.tree.map(np.asarray, jg), GRAD_TOL)


def test_pp_sp_agrees_with_sp_only_and_the_masked_single_program():
    jcfg, cfg = _cfgs()
    jparams, params = _both(5, jcfg)
    tokens = _tokens(4, 16, 6)
    v_pp = float(tpl.make_pipeline_sp_lm_loss(_mesh(2, 2, 2), cfg, 2, 2)(
        dict(params, blocks=tpl.shard_blocks(params["blocks"], 2)), torch.from_numpy(tokens)))
    v_sp = float(ra.make_seq_parallel_lm_loss(_mesh(1, 4, 2), cfg)(params,
                                                                  torch.from_numpy(tokens)))
    v_single = float(masked_next_token_ce(forward(params, torch.from_numpy(tokens), cfg),
                                          torch.from_numpy(tokens)))
    j_sp = float(jra.make_seq_parallel_lm_loss(_jmesh(1, 4, 2), jcfg)(jparams,
                                                                      jnp.asarray(tokens)))
    np.testing.assert_allclose(v_sp, v_pp, rtol=1e-5)
    np.testing.assert_allclose(v_single, v_pp, rtol=1e-5)
    np.testing.assert_allclose(j_sp, v_pp, rtol=1e-5)


def test_pp_sp_refusals_in_jax_texts():
    jcfg, cfg = _cfgs()
    jparams, params = _both(0, jcfg)
    jfwd = jtpl.make_pipeline_sp_lm_forward(_jmesh(2, 2, 2), jcfg, 2, 2)
    fwd = tpl.make_pipeline_sp_lm_forward(_mesh(2, 2, 2), cfg, 2, 2)
    jst = dict(jparams, blocks=jtpl.shard_blocks(jparams["blocks"], 2))
    st = dict(params, blocks=tpl.shard_blocks(params["blocks"], 2))
    for batch, t in ((4, 15), (3, 16), (4, 18)):  # seq split, microbatches, position table
        with pytest.raises(ValueError) as jerr:
            jfwd(jst, jnp.asarray(_tokens(batch, t, 0)))
        with pytest.raises(ValueError) as err:
            fwd(st, torch.from_numpy(_tokens(batch, t, 0)))
        assert str(err.value) == str(jerr.value)
    vag = tpl.make_pipeline_sp_lm_1f1b_grad(_mesh(2, 2, 2), cfg, 2, 2)
    with pytest.raises(ValueError, match="not divisible by seq axis 2 .sp feeds full"):
        vag(st, torch.from_numpy(_tokens(4, 15, 0)))
    with pytest.raises(ValueError) as jerr:
        jlt.make_pipeline_sp_lm_train_step(_jmesh(2, 2, 2), jcfg, 2, 2,
                                           jax_build_optimizer(1e-3), schedule="zb-stash")
    with pytest.raises(ValueError) as err:
        make_pipeline_sp_lm_train_step(_mesh(2, 2, 2), cfg, 2, 2, build_optimizer(1e-3),
                                       schedule="zb-stash")
    assert str(err.value) == str(jerr.value) and "dense-LM only" in str(err.value)


@pytest.mark.parametrize("schedule,mode", [("gpipe", "ring"), ("1f1b", "ulysses")])
def test_pp_sp_train_step_losses_match_jax(schedule, mode):
    """Two Adam steps of the pp x sp step from the same params, against
    the JAX step's losses (stage 2 x seq 2 x data 2), and the weights
    move."""
    jcfg, cfg = _cfgs()
    jparams, params = _both(7, jcfg)
    jopt, opt = jax_build_optimizer(1e-2), build_optimizer(1e-2)
    jm, m = _jmesh(2, 2, 2), _mesh(2, 2, 2)
    jstep = jax.jit(jlt.make_pipeline_sp_lm_train_step(jm, jcfg, 2, 2, jopt, mode=mode,
                                                       schedule=schedule))
    step = make_pipeline_sp_lm_train_step(m, cfg, 2, 2, opt, mode, schedule=schedule)
    jst = dict(jparams, blocks=jtpl.shard_blocks(jparams["blocks"], 2))
    st = tree_map(lambda a: a.clone(), dict(params, blocks=tpl.shard_blocks(params["blocks"], 2)))
    before = st["blocks"]["w_qkv"].clone()
    jstate, state = jopt.init(jst), opt.init(param_leaves(st))
    for i in range(2):
        tokens = _tokens(8, 16, 8 + i)
        jst, jstate, jl = jstep(jst, jstate, jnp.asarray(tokens))
        st, state, loss = step(st, state, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5 if i == 0 else 1e-4)
    assert not torch.equal(st["blocks"]["w_qkv"], before)


LM = ["lm", "--device", "cpu", "--steps", "2", "--batch-size", "4", "--seq-len", "15",
      "--d-model", "16", "--heads", "2", "--layers", "2", "--eval-batches", "2",
      "--stages", "2", "--seq-parallel", "2", "--microbatches", "2"]


@pytest.mark.parametrize("flags", [[], ["--sp-mode", "ulysses", "--schedule", "1f1b"]],
                         ids=["gpipe-ring", "1f1b-ulysses"])
def test_cli_lm_stages_seq_parallel(capsys, flags):
    from tpu_dist_nn_torch.cli import main

    assert main(LM + flags) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(report["final_train_loss"]) and report["perplexity"] > 0


@pytest.mark.parametrize("flags", [
    ["--seq-len", "16"],
    ["--schedule", "zb-stash"],
    ["--heads", "1", "--d-model", "16", "--sp-mode", "ulysses"],
    ["--batch-size", "5"],
], ids=["seq-len", "zb-stash", "ulysses-heads", "batch"])
def test_cli_pp_sp_refusals_before_training_with_jax_texts(flags):
    """The port refuses before any work; its texts are the JAX package's
    (which raises zb-stash's and the head split's later, once its step
    is built or traced)."""
    from tpu_dist_nn.cli import main as tdn_main
    from tpu_dist_nn_torch.cli import main as port_main

    texts = []
    for main, argv in ((port_main, LM + flags),
                       (tdn_main, ["--platform", "cpu"] + LM[:1] + LM[3:] + flags)):
        err = io.StringIO()
        with redirect_stderr(err):
            rc = main(argv)
        texts.append((rc, err.getvalue().strip().splitlines()[-1]))
    assert texts[0][0] == 2 and texts[0][1] in texts[1][1]


def test_slot_order_is_jax_device_order_and_seq_1_is_the_model_parallel_grid(monkeypatch):
    """Slot ``(s, d, q, m)`` is ``devices[((d * Q + q) * S + s) * N + m]``
    (the JAX mesh's ``(data, seq, stage, model)`` order); at ``seq = 1``
    ``model_slots``, ``slots`` and ``cell`` are the model-parallel grid's."""
    from tpu_dist_nn_torch.parallel import mesh as mesh_mod

    made = []

    class Recorded(mesh_mod.StageSlot):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(mesh_mod, "StageSlot", Recorded)
    for S, D, Q, N in ((2, 2, 1, 2), (2, 2, 2, 2), (3, 1, 2, 1)):
        made.clear()
        m = build_mesh(MeshSpec(stage=S, data=D, model=N, seq=Q), ["cpu"] * (S * D * Q * N))
        for s in range(S):
            for d in range(D):
                for q in range(Q):
                    for n in range(N):
                        assert m.seq_slots[s][d][q][n] is made[((d * Q + q) * S + s) * N + n]
                assert m.model_slots[s][d] is m.seq_slots[s][d][0]
                assert m.slots[s][d] is m.seq_slots[s][d][0][0]
                cell = m.cell(s, d)
                if Q == 1:
                    assert cell is m.slots[s][d]
                else:
                    assert all(a is b[0] for a, b in zip(cell, m.seq_slots[s][d], strict=True))
        assert len(m.all_slots) == len(made) and m.shape["seq"] == Q


@pytest.mark.parametrize("schedule,model", [("gpipe", 2), ("1f1b", 1), ("interleaved", 2),
                                            ("zb", 2), ("zb-v", 1), ("zb-stash", 1)])
def test_seq_1_grid_gives_the_model_parallel_gradients_bit_for_bit(schedule, model):
    """The dense and Megatron schedules on a grid built with ``seq=1``
    give the gradients of the grid built without a seq axis, bit for bit
    (the seq-1 path issues the model-parallel ops unchanged)."""
    _, cfg = _cfgs()
    _, params = _both(31, JaxConfig(**SHAPE))
    tokens = torch.from_numpy(_tokens(8, 17, 32))
    v = 2 if schedule in ("interleaved", "zb-v") else 1
    shard, _ = lm_block_layout(schedule, 2, v, cfg=cfg, tp=model)
    st = dict(params, blocks=shard(params["blocks"]))
    out = []
    for spec in (MeshSpec(stage=2, data=2, model=model),
                 MeshSpec(stage=2, data=2, model=model, seq=1)):
        m = build_mesh(spec, ["cpu"] * spec.num_devices)
        s = tree_map(lambda a: a.clone(), st)
        opt = build_optimizer(1e-2)
        step = make_pipeline_lm_train_step(m, cfg, 2, 2, opt, schedule=schedule, num_virtual=v,
                                           tensor_parallel=model)
        loss = step(s, opt.init(param_leaves(s)), tokens)[2]
        out.append((float(loss), param_leaves(s)))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
