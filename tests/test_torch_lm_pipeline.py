"""The per-block LM pipeline and its Megatron composition over CPU slots,
against the JAX package's, on the CPU.

The same seeded params and tokens go through the JAX functions on
conftest's 8 virtual host devices and through the port's on
``devices=["cpu"] * n`` meshes of (stage, data, model) slots. Tolerances
are the JAX tests': layouts bit for bit (roundtrips rtol 1e-6 / atol 1e-7
there), forwards 2e-5, losses rtol 1e-5, gradients rtol 5e-4 / atol 1e-5
(``tests/test_pipeline_tp.py``); 1F1B against GPipe rtol 2e-4 / atol 1e-6
(``tests/test_pipeline_1f1b.py``); the trained losses of a few Adam steps
rtol 1e-4 (later steps amplify rounding through Adam's normalisation).
"""

import dataclasses
import io
import json
import time
from contextlib import redirect_stderr

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist_nn.models.transformer import TransformerConfig as JaxConfig
from tpu_dist_nn.models.transformer import init_transformer as jax_init
from tpu_dist_nn.models.transformer import lm_loss as jax_lm_loss
from tpu_dist_nn.parallel import transformer_pipeline as jtpl
from tpu_dist_nn.parallel.mesh import MeshSpec as JaxMeshSpec
from tpu_dist_nn.parallel.mesh import build_mesh as jax_build_mesh
from tpu_dist_nn.train import lm_trainer as jlt
from tpu_dist_nn.train.optimizers import build_optimizer as jax_build_optimizer
from tpu_dist_nn_torch.checkpoint import CheckpointManager
from tpu_dist_nn_torch.data.text import lm_batches, lm_sequences
from tpu_dist_nn_torch.models.transformer import (
    TransformerConfig,
    forward,
    lm_loss,
    param_leaves,
    transformer_params_from_jax,
    tree_map,
)
from tpu_dist_nn_torch.parallel import transformer_pipeline as tpl
from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
from tpu_dist_nn_torch.train.lm_trainer import (
    LMTrainConfig,
    lm_block_layout,
    make_pipeline_lm_train_step,
    train_lm,
)
from tpu_dist_nn_torch.train.optimizers import build_optimizer
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

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


def _tokens(batch, t, seed, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (batch, t)).astype(np.int32)


def _cpu_mesh(stage=1, data=1, model=1):
    spec = MeshSpec(stage=stage, data=data, model=model)
    return build_mesh(spec, ["cpu"] * spec.num_devices)


def _jmesh(stage=1, data=1, model=1):
    return jax_build_mesh(JaxMeshSpec(stage=stage, data=data, model=model))


def _close(got: dict, want: dict, tol, path=""):
    for k, v in want.items():
        if isinstance(v, dict):
            _close(got[k], v, tol, f"{path}{k}/")
        else:
            np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(v), err_msg=path + k,
                                       **tol)


LAYOUTS = {
    "pp": (lambda b, c: tpl.shard_blocks(b, 2), lambda s, c: tpl.unshard_blocks(s),
           lambda b, c: jtpl.shard_blocks(b, 2)),
    "interleaved": (lambda b, c: tpl.shard_blocks_interleaved(b, 2, 2),
                    lambda s, c: tpl.unshard_blocks_interleaved(s),
                    lambda b, c: jtpl.shard_blocks_interleaved(b, 2, 2)),
    "pp_tp": (lambda b, c: tpl.shard_blocks_pp_tp(b, c, 2, 2),
              lambda s, c: tpl.unshard_blocks_pp_tp(s, c),
              lambda b, c: jtpl.shard_blocks_pp_tp(b, c, 2, 2)),
    "interleaved_tp": (lambda b, c: tpl.shard_blocks_interleaved_tp(b, c, 2, 2, 2),
                       lambda s, c: tpl.unshard_blocks_interleaved_tp(s, c),
                       lambda b, c: jtpl.shard_blocks_interleaved_tp(b, c, 2, 2, 2)),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layouts_equal_jax_and_roundtrip_bit_for_bit(layout):
    jcfg, cfg = _cfgs()
    jparams, params = _both(0, jcfg)
    shard, unshard, jshard = LAYOUTS[layout]
    staged = shard(params["blocks"], cfg)
    jstaged = jshard(jparams["blocks"], jcfg)
    for k, v in staged.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jstaged[k]), err_msg=k)
    back = unshard(staged, cfg)
    for k, v in params["blocks"].items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("stage,model,data", [(4, 1, 1), (2, 1, 2), (2, 2, 2), (4, 2, 1),
                                              (2, 4, 1)])
def test_forward_matches_jax_and_the_single_program(stage, model, data):
    jcfg, cfg = _cfgs()
    jparams, params = _both(1, jcfg)
    tokens = _tokens(8, 16, 2)
    jm, m = _jmesh(stage, data, model), _cpu_mesh(stage, data, model)
    if model > 1:
        jfwd = jtpl.make_pipeline_tp_lm_forward(jm, jcfg, stage, 2)
        jst = dict(jparams, blocks=jtpl.shard_blocks_pp_tp(jparams["blocks"], jcfg, stage, model))
        fwd = tpl.make_pipeline_tp_lm_forward(m, cfg, stage, 2)
        st = dict(params, blocks=tpl.shard_blocks_pp_tp(params["blocks"], cfg, stage, model))
    else:
        jfwd = jtpl.make_pipeline_lm_forward(jm, jcfg, stage, 2)
        jst = dict(jparams, blocks=jtpl.shard_blocks(jparams["blocks"], stage))
        fwd = tpl.make_pipeline_lm_forward(m, cfg, stage, 2)
        st = dict(params, blocks=tpl.shard_blocks(params["blocks"], stage))
    want = np.asarray(jax.jit(jfwd)(jst, jnp.asarray(tokens)))
    got = fwd(st, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    single = forward(params, torch.from_numpy(tokens), cfg)
    if model == 1:  # the dense blocks are the single program's ops, row for row
        np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), single.numpy(), **FWD_TOL)


def _jax_value_and_grad(jcfg, jparams, tokens):
    return jax.jit(jax.value_and_grad(jax_lm_loss), static_argnums=2)(
        jparams, jnp.asarray(tokens), jcfg)


@pytest.mark.parametrize("family", ["pp", "pp_tp"])
def test_loss_and_gradients_match_jax(family):
    """``make_pipeline_(tp_)lm_loss`` differentiated by autograd, and the
    GPipe-ordered schedule's loss and grads, against ``jax.grad`` of the
    JAX loss (stage 2, model 2, data 2 as tests/test_pipeline_tp.py)."""
    jcfg, cfg = _cfgs()
    jparams, params = _both(3, jcfg)
    tokens = _tokens(8, 17, 4)
    tp = family == "pp_tp"
    model = 2 if tp else 1
    jm, m = _jmesh(2, 2, model), _cpu_mesh(2, 2, model)
    if tp:
        jloss_fn = jtpl.make_pipeline_tp_lm_loss(jm, jcfg, 2, 2)
        jst = dict(jparams, blocks=jtpl.shard_blocks_pp_tp(jparams["blocks"], jcfg, 2, 2))
        loss_fn = tpl.make_pipeline_tp_lm_loss(m, cfg, 2, 2)
        st = dict(params, blocks=tpl.shard_blocks_pp_tp(params["blocks"], cfg, 2, 2))
    else:
        jloss_fn = jtpl.make_pipeline_lm_loss(jm, jcfg, 2, 2)
        jst = dict(jparams, blocks=jtpl.shard_blocks(jparams["blocks"], 2))
        loss_fn = tpl.make_pipeline_lm_loss(m, cfg, 2, 2)
        st = dict(params, blocks=tpl.shard_blocks(params["blocks"], 2))
    jl, jg = jax.jit(jax.value_and_grad(jloss_fn))(jst, jnp.asarray(tokens))
    st = tree_map(lambda a: a.clone().requires_grad_(), st)
    loss = loss_fn(st, torch.from_numpy(tokens))
    grads = torch.autograd.grad(loss, param_leaves(st))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for g, want in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **GRAD_TOL)
    vag = (tpl.make_pipeline_tp_lm_gpipe_grad if tp else tpl.make_pipeline_lm_gpipe_grad)(
        m, cfg, 2, 2)
    loss_s, g_s = vag(st, torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss_s), float(jl), rtol=1e-5)
    _close(g_s, jax.tree.map(np.asarray, jg), GRAD_TOL)
    jl_single, _ = _jax_value_and_grad(jcfg, jparams, tokens)
    np.testing.assert_allclose(float(loss_s), float(jl_single), rtol=1e-5)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_lm_1f1b_matches_jax_and_gpipe(remat):
    """tests/test_pipeline_1f1b.py::test_lm_1f1b_matches_gpipe's shape:
    stage 2 x data 2, 4 microbatches."""
    jcfg, cfg = _cfgs(vocab_size=37, d_model=16, n_heads=2, n_layers=4, d_ff=32, max_seq_len=12,
                      remat=remat)
    jparams, params = _both(0, jcfg)
    tokens = _tokens(16, 13, 3, vocab=37)
    jst = dict(jparams, blocks=jtpl.shard_blocks(jparams["blocks"], 2))
    jl, jg = jax.jit(jtpl.make_pipeline_lm_1f1b_grad(_jmesh(2, 2), jcfg, 2, 4))(
        jst, jnp.asarray(tokens))
    m = _cpu_mesh(2, 2)
    st = dict(params, blocks=tpl.shard_blocks(params["blocks"], 2))
    loss_f, g_f = tpl.make_pipeline_lm_1f1b_grad(m, cfg, 2, 4)(st, torch.from_numpy(tokens))
    loss_g, g_g = tpl.make_pipeline_lm_gpipe_grad(m, cfg, 2, 4)(st, torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss_f), float(jl), rtol=1e-5)
    _close(g_f, jax.tree.map(np.asarray, jg), GRAD_TOL)
    np.testing.assert_allclose(float(loss_f), float(loss_g), rtol=1e-5)
    _close(g_f, tree_map(lambda a: a.numpy(), g_g), dict(rtol=2e-4, atol=1e-6))


def test_pp_tp_1f1b_gradients_match_jax():
    jcfg, cfg = _cfgs()
    jparams, params = _both(5, jcfg)
    tokens = _tokens(8, 17, 6)
    jst = dict(jparams, blocks=jtpl.shard_blocks_pp_tp(jparams["blocks"], jcfg, 2, 2))
    jl, jg = jax.jit(jtpl.make_pipeline_tp_lm_1f1b_grad(_jmesh(2, 2, 2), jcfg, 2, 2))(
        jst, jnp.asarray(tokens))
    st = dict(params, blocks=tpl.shard_blocks_pp_tp(params["blocks"], cfg, 2, 2))
    loss, g = tpl.make_pipeline_tp_lm_1f1b_grad(_cpu_mesh(2, 2, 2), cfg, 2, 2)(
        st, torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _close(g, jax.tree.map(np.asarray, jg), GRAD_TOL)


@pytest.mark.parametrize("S,v,M,remat,model", [(2, 2, 4, False, 1), (2, 2, 4, True, 1),
                                               (2, 1, 2, False, 1), (2, 2, 2, False, 2),
                                               (2, 2, 2, False, 4)])
def test_interleaved_gradients_match_jax(S, v, M, remat, model):
    """tests/test_interleaved.py's and tests/test_pipeline_tp.py's
    interleaved cases (data 2; data 1 at model 4)."""
    data = 1 if model == 4 else 2
    jcfg, cfg = _cfgs(vocab_size=29, d_model=16 if model == 1 else 32,
                      n_heads=2 if model == 1 else 4, n_layers=S * v,
                      d_ff=32 if model == 1 else 64, max_seq_len=10, remat=remat)
    jparams, params = _both(1, jcfg)
    tokens = _tokens(M * data * 2, 11, 5, vocab=29)
    jm, m = _jmesh(S, data, model), _cpu_mesh(S, data, model)
    if model > 1:
        jst = dict(jparams, blocks=jtpl.shard_blocks_interleaved_tp(jparams["blocks"], jcfg, S, v,
                                                                     model))
        jvag = jtpl.make_pipeline_tp_lm_interleaved_grad(jm, jcfg, v, M)
        st = dict(params, blocks=tpl.shard_blocks_interleaved_tp(params["blocks"], cfg, S, v,
                                                                  model))
        vag = tpl.make_pipeline_tp_lm_interleaved_grad(m, cfg, v, M)
    else:
        jst = dict(jparams, blocks=jtpl.shard_blocks_interleaved(jparams["blocks"], S, v))
        jvag = jtpl.make_pipeline_lm_interleaved_grad(jm, jcfg, v, M)
        st = dict(params, blocks=tpl.shard_blocks_interleaved(params["blocks"], S, v))
        vag = tpl.make_pipeline_lm_interleaved_grad(m, cfg, v, M)
    jl, jg = jax.jit(jvag)(jst, jnp.asarray(tokens))
    loss, g = vag(st, torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _close(g, jax.tree.map(np.asarray, jg), GRAD_TOL)
    single = float(lm_loss(params, torch.from_numpy(tokens), cfg))
    np.testing.assert_allclose(float(loss), single, rtol=1e-5)


@pytest.mark.parametrize("schedule,model", [("gpipe", 1), ("1f1b", 1), ("interleaved", 1),
                                            ("gpipe", 2), ("1f1b", 2), ("interleaved", 2)])
def test_train_step_losses_match_jax(schedule, model):
    """Three Adam steps of ``make_pipeline_lm_train_step`` against the JAX
    step from the same params (stage 2 x data 2 x model)."""
    jcfg, cfg = _cfgs()
    jparams, params = _both(7, jcfg)
    v = 2 if schedule == "interleaved" else 1
    jshard, _ = jlt.lm_block_layout(schedule, 2, v, cfg=jcfg, tp=model)
    shard, unshard = lm_block_layout(schedule, 2, v, cfg=cfg, tp=model)
    jopt, opt = jax_build_optimizer(1e-2), build_optimizer(1e-2)
    jm, m = _jmesh(2, 2, model), _cpu_mesh(2, 2, model)
    jstep = jax.jit(jlt.make_pipeline_lm_train_step(jm, jcfg, 2, 2, jopt, schedule=schedule,
                                                    num_virtual=v, tensor_parallel=model))
    step = make_pipeline_lm_train_step(m, cfg, 2, 2, opt, schedule=schedule, num_virtual=v,
                                       tensor_parallel=model)
    jst = dict(jparams, blocks=jshard(jparams["blocks"]))
    st = dict(params, blocks=shard(params["blocks"]))
    st = tree_map(lambda a: a.clone(), st)
    jstate, state = jopt.init(jst), opt.init(param_leaves(st))
    for i in range(3):
        tokens = _tokens(8, 17, 10 + i)
        jst, jstate, jl = jstep(jst, jstate, jnp.asarray(tokens))
        st, state, loss = step(st, state, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5 if i == 0 else 1e-4)
    assert unshard(st["blocks"])["w_qkv"].shape == params["blocks"]["w_qkv"].shape


def _rows(n=4000, seq=16, vocab=32, seed=0):
    return lm_sequences(np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32), seq)


@pytest.mark.parametrize("schedule,tp", [("gpipe", 1), ("1f1b", 2)])
def test_train_lm_pipelined_matches_jax_and_descends(schedule, tp):
    """``train_lm(mesh=, num_stages=2)``: the JAX trainer's per-step
    losses (JAX's own ``train_lm`` for the dense gpipe path, its step
    through ``step_fn`` for PP x TP, as its CLI does) and the standard
    layout back."""
    jcfg, cfg = _cfgs(vocab_size=32, n_layers=2, max_seq_len=16)
    jparams, params = _both(1, jcfg)
    rows = _rows()
    tc = LMTrainConfig(steps=6, batch_size=8, seq_len=16, log_every=1, learning_rate=3e-3)
    jtc = jlt.LMTrainConfig(steps=6, batch_size=8, seq_len=16, log_every=1, learning_rate=3e-3)
    jm = _jmesh(2, 2, tp)
    if tp > 1:
        jshard, junshard = jlt.lm_block_layout(schedule, 2, 1, cfg=jcfg, tp=tp)
        jout, jhist = jlt.train_lm(
            dict(jparams, blocks=jshard(jparams["blocks"])), jcfg,
            lm_batches(rows, 8, seed=0, epochs=None), jtc,
            step_fn=lambda o: jlt.make_pipeline_lm_train_step(jm, jcfg, 2, 2, o,
                                                              schedule=schedule,
                                                              tensor_parallel=tp))
    else:
        jout, jhist = jlt.train_lm(jparams, jcfg, lm_batches(rows, 8, seed=0, epochs=None), jtc,
                                   mesh=jm, num_stages=2, num_microbatches=2,
                                   schedule=schedule)
    out, hist = train_lm(params, cfg, lm_batches(rows, 8, seed=0, epochs=None), tc,
                         mesh=_cpu_mesh(2, 2, tp), num_stages=2, num_microbatches=2,
                         schedule=schedule, tensor_parallel=tp)
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist], rtol=1e-4)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert out["blocks"]["w_qkv"].shape[0] == cfg.n_layers  # the standard layout


def test_resume_rejects_a_mismatched_stage_layout(tmp_path):
    cfg = TransformerConfig(vocab_size=32, d_model=16, n_heads=2, n_layers=2, d_ff=32,
                            max_seq_len=16)
    _, params = _both(0, JaxConfig(**dataclasses.asdict(cfg)))
    rows = _rows(2000)
    tc = LMTrainConfig(steps=2, batch_size=4, log_every=1)
    train_lm(params, cfg, lm_batches(rows, 4, seed=0, epochs=None), tc, mesh=_cpu_mesh(2),
             num_stages=2, num_microbatches=2,
             checkpoints=CheckpointManager(tmp_path / "ck", keep=2), checkpoint_every=1)
    with pytest.raises(InvalidArgumentError, match="different placement"):
        train_lm(params, cfg, lm_batches(rows, 4, seed=0, epochs=None), tc,
                 checkpoints=CheckpointManager(tmp_path / "ck", keep=2))


def test_schedule_refusals():
    cfg = TransformerConfig(vocab_size=16, d_model=8, n_heads=2, n_layers=2, d_ff=16,
                            max_seq_len=8)
    _, params = _both(0, JaxConfig(**dataclasses.asdict(cfg)))
    rows = np.zeros((4, 9), np.int32)
    with pytest.raises(ValueError, match="pipelined dense LM"):
        train_lm(params, cfg, [rows], LMTrainConfig(steps=1), schedule="1f1b")
    for sched in ("zb", "zb-v", "zb-stash"):  # ported: built, and laid out
        assert callable(make_pipeline_lm_train_step(_cpu_mesh(2), cfg, 2, 2,
                                                    build_optimizer(1e-3), schedule=sched))
        assert all(map(callable, lm_block_layout(sched, 2, 1)))
    with pytest.raises(ValueError, match="dense-LM only"):
        make_pipeline_lm_train_step(_cpu_mesh(2, 1, 2), cfg, 2, 2, build_optimizer(1e-3),
                                    schedule="zb-stash", tensor_parallel=2)
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        make_pipeline_lm_train_step(_cpu_mesh(2), cfg, 2, 2, build_optimizer(1e-3),
                                    schedule="nope")
    # JAX's text for a model axis that does not match tensor_parallel
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    with pytest.raises(ValueError) as jerr:
        jlt.make_pipeline_lm_train_step(_jmesh(2), jcfg, 2, 2, jax_build_optimizer(1e-3),
                                        tensor_parallel=2)
    with pytest.raises(ValueError) as err:
        make_pipeline_lm_train_step(_cpu_mesh(2), cfg, 2, 2, build_optimizer(1e-3),
                                    tensor_parallel=2)
    assert str(err.value) == str(jerr.value)


LM = ["lm", "--steps", "2", "--batch-size", "4", "--seq-len", "24", "--d-model", "16",
      "--heads", "2", "--layers", "2", "--eval-batches", "2"]


def test_cli_lm_stages_tensor_parallel_1f1b_samples_in_the_pipeline(capsys):
    from tpu_dist_nn_torch.cli import main

    argv = ["lm", "--device", "cpu", "--d-model", "32", "--heads", "4", "--layers", "4",
            "--seq-len", "64", "--steps", "3", "--batch-size", "8", "--eval-batches", "2",
            "--log-every", "1", "--stages", "2", "--tensor-parallel", "2", "--schedule",
            "1f1b", "--sample-pipeline-stages", "2", "--sample-bytes", "32"]
    assert main(argv) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(report["final_train_loss"]) and "sample" in report


@pytest.mark.parametrize("flags", [
    ["--tensor-parallel", "2"],
    ["--stages", "2", "--tensor-parallel", "3"],
    ["--schedule", "1f1b"],
    ["--stages", "2", "--tensor-parallel", "2", "--batch-size", "6"],
    ["--sample-pipeline-stages", "2"],
    ["--sample-tensor-parallel", "2"],
    ["--sample-bytes", "4", "--sample-pipeline-stages", "2", "--sample-tensor-parallel", "2"],
    ["--sample-bytes", "4", "--sample-pipeline-stages", "3"],
    ["--sample-bytes", "4", "--sample-tensor-parallel", "3"],
    ["--sample-bytes", "4", "--sample-pipeline-stages", "2", "--eos-id", "3"],
    ["--expert-parallel", "2"],
    ["--sp-mode", "ulysses"],
], ids=["tp-no-stages", "tp-heads", "schedule-no-stages", "tp-batch", "spp-no-sample",
        "stp-no-sample", "two-placements", "spp-layers", "stp-heads", "eos-placement",
        "ep-no-experts", "sp-mode"])
def test_cli_parallel_flags_refused_with_jax_texts(flags):
    from tpu_dist_nn.cli import main as tdn_main
    from tpu_dist_nn_torch.cli import main as port_main

    texts = []
    for main, argv in ((port_main, LM + flags + ["--device", "cpu"]),
                       (tdn_main, ["--platform", "cpu"] + LM + flags)):
        err = io.StringIO()
        with redirect_stderr(err):
            assert main(argv) == 2
        texts.append(err.getvalue().strip().splitlines()[-1])
    assert texts[0] == texts[1]


@pytest.mark.parametrize("flags,refused", [
    # Each case as the JAX package takes it: a refusal in its text, held
    # equal to tdn's last stderr line before any work, or a run that trains.
    (["--experts", "4", "--zero1", "--data-parallel", "2"], True),
    (["--seq-parallel", "2", "--experts", "4", "--tensor-parallel", "2"], True),
    (["--zero1", "--data-parallel", "2"], False),
    (["--fsdp", "--data-parallel", "2"], False),
    (["--stages", "2", "--schedule", "zb", "--seq-parallel", "2", "--zero1"], True),
    (["--stages", "2", "--schedule", "zb-v", "--experts", "4", "--seq-parallel", "2"], True),
    (["--stages", "2", "--schedule", "zb-stash", "--zero1"], True),
    (["--data-parallel", "2"], False),
], ids=["experts", "seq-parallel", "zero1", "fsdp", "zb", "zb-v", "zb-stash", "data-parallel"])
def test_cli_refuses_flags_not_ported_before_training(flags, refused, capsys):
    from tpu_dist_nn.cli import main as tdn_main
    from tpu_dist_nn_torch.cli import main as port_main

    if not refused:
        assert port_main(LM + flags + ["--device", "cpu"]) == 0
        assert "perplexity" in capsys.readouterr().out
        return
    texts = []
    t0 = time.monotonic()
    for main, argv in ((port_main, LM + flags + ["--device", "cpu"]),
                       (tdn_main, ["--platform", "cpu"] + LM + flags)):
        err = io.StringIO()
        with redirect_stderr(err):
            assert main(argv) == 2
        texts.append(err.getvalue().strip().splitlines()[-1])
    assert time.monotonic() - t0 < 10.0  # before the corpus or any training
    assert texts[0] == texts[1] and "not ported" not in texts[0]


@pytest.mark.parametrize("family", ["pp", "pp_tp"])
def test_bf16_and_remat_apply_to_the_pipelined_path(family):
    """tests/test_transformer.py's ``test_bf16_applies_to_pipelined_path``
    (the blocks compute in bf16) and ``test_remat_pipelined_matches_single_chip``
    (remat changes memory, not the loss or the gradients)."""
    tp = family == "pp_tp"
    jcfg, cfg = _cfgs(vocab_size=32, n_layers=4)
    _, params = _both(1, jcfg)
    tokens = torch.from_numpy(_tokens(4, 17, 1, vocab=32))
    m = _cpu_mesh(2, 1, 2 if tp else 1)
    make = tpl.make_pipeline_tp_lm_loss if tp else tpl.make_pipeline_lm_loss
    staged = dict(params, blocks=(tpl.shard_blocks_pp_tp(params["blocks"], cfg, 2, 2) if tp
                                  else tpl.shard_blocks(params["blocks"], 2)))
    seen = set()

    def attn(q, k, v, *, causal):
        seen.add(q.dtype)
        from tpu_dist_nn_torch.models.transformer import dot_product_attention

        return dot_product_attention(q, k, v, causal=causal)

    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    loss16 = float(make(m, bf16, 2, 2, attn)(staged, tokens))
    assert seen == {torch.bfloat16} and np.isfinite(loss16)
    np.testing.assert_allclose(loss16, float(lm_loss(params, tokens, bf16)), rtol=1e-2)
    grads = {}
    for remat in (False, True):
        st = tree_map(lambda a: a.clone().requires_grad_(), staged)
        c = dataclasses.replace(cfg, remat=remat)
        loss = make(m, c, 2, 2)(st, tokens)
        assert abs(float(loss.detach()) - float(lm_loss(params, tokens, c))) < 2e-5
        grads[remat] = torch.autograd.grad(loss, param_leaves(st))
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)
    assert float(grads[True][0].abs().sum()) > 0
