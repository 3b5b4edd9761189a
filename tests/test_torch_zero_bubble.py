"""The zero-bubble LM schedules (zb, zb-v, zb-stash) against the JAX package's.

The same seeded params and tokens go through the JAX package's
``make_pipeline_*_zb*_grad`` functions on conftest's 8 virtual host
devices and through the port's on ``devices=["cpu"] * n`` meshes of
(stage, data, model) slots, at ``tests/test_zero_bubble.py``'s and
``tests/test_zb_v.py``'s shapes and tolerances: the loss at rtol 1e-5,
the gradients at rtol 5e-4 / atol 1e-5. Then the trainer's step, ``tdn
lm --schedule zb|zb-v|zb-stash`` on the CPU, and the refusals in the
JAX package's texts.
"""

import dataclasses
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
    lm_loss,
    param_leaves,
    transformer_params_from_jax,
    tree_map,
)
from tpu_dist_nn_torch.parallel import transformer_pipeline as tpl
from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
from tpu_dist_nn_torch.train.lm_trainer import lm_block_layout, make_pipeline_lm_train_step
from tpu_dist_nn_torch.train.optimizers import build_optimizer

torch.set_num_threads(1)
SHAPE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_seq_len=16)
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


def _close(got: dict, want: dict, path=""):
    for k, v in want.items():
        if isinstance(v, dict):
            _close(got[k], v, f"{path}{k}/")
        else:
            np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(v), err_msg=path + k,
                                       **GRAD_TOL)


def _layouts(schedule, S, v, model, cfg, jcfg):
    return (lm_block_layout(schedule, S, v, cfg=cfg, tp=model)[0],
            jlt.lm_block_layout(schedule, S, v, cfg=jcfg, tp=model)[0])


# (schedule, stage, virtual, microbatches, data, model, layers, batch, remat)
CASES = {
    "zb-2x1x4-data2": ("zb", 2, 1, 4, 2, 1, 4, 8, False),
    "zb-4x1x4-data2": ("zb", 4, 1, 4, 2, 1, 4, 8, False),
    "zb-2x2x4": ("zb", 2, 2, 4, 1, 1, 4, 8, False),
    "zb-2x1x4-remat": ("zb", 2, 1, 4, 1, 1, 4, 8, True),
    "zb-tp": ("zb", 2, 1, 2, 2, 2, 4, 8, False),
    "zb-v-2x2-data2": ("zb-v", 2, 2, 2, 2, 1, 8, 4, False),
    "zb-v-4x4-data2": ("zb-v", 4, 2, 4, 2, 1, 8, 8, False),
    "zb-v-remat": ("zb-v", 2, 2, 2, 1, 1, 8, 4, True),
    "zb-v-tp": ("zb-v", 2, 2, 2, 2, 2, 8, 4, False),
    "zb-stash-2x1x4": ("zb-stash", 2, 1, 4, 1, 1, 4, 8, False),
    "zb-stash-4x1x4": ("zb-stash", 4, 1, 4, 1, 1, 4, 8, False),
    "zb-stash-2x2x2": ("zb-stash", 2, 2, 2, 1, 1, 4, 8, False),
    "zb-stash-remat": ("zb-stash", 2, 1, 4, 1, 1, 4, 8, True),
}


def _jax_vag(schedule, jm, jcfg, v, M, model):
    if schedule == "zb-v":
        make = jtpl.make_pipeline_tp_lm_zb_v_grad if model > 1 else jtpl.make_pipeline_lm_zb_v_grad
        return make(jm, jcfg, M)
    if schedule == "zb-stash":
        return jtpl.make_pipeline_lm_zb_stash_grad(jm, jcfg, v, M)
    make = jtpl.make_pipeline_tp_lm_zb_grad if model > 1 else jtpl.make_pipeline_lm_zb_grad
    return make(jm, jcfg, v, M)


def _port_vag(schedule, m, cfg, v, M, model):
    if schedule == "zb-v":
        make = tpl.make_pipeline_tp_lm_zb_v_grad if model > 1 else tpl.make_pipeline_lm_zb_v_grad
        return make(m, cfg, M)
    if schedule == "zb-stash":
        return tpl.make_pipeline_lm_zb_stash_grad(m, cfg, v, M)
    make = tpl.make_pipeline_tp_lm_zb_grad if model > 1 else tpl.make_pipeline_lm_zb_grad
    return make(m, cfg, v, M)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_jax(case):
    schedule, S, v, M, data, model, layers, batch, remat = CASES[case]
    jcfg, cfg = _cfgs(n_layers=layers, remat=remat)
    jparams, params = _both(1, jcfg)
    tokens = _tokens(batch, 16, 2)
    shard, jshard = _layouts(schedule, S, v, model, cfg, jcfg)
    jl, jg = jax.jit(_jax_vag(schedule, _jmesh(S, data, model), jcfg, v, M, model))(
        dict(jparams, blocks=jshard(jparams["blocks"])), jnp.asarray(tokens))
    staged = dict(params, blocks=shard(params["blocks"]))
    loss, g = _port_vag(schedule, _cpu_mesh(S, data, model), cfg, v, M, model)(
        staged, torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _close(g, jax.tree.map(np.asarray, jg))
    np.testing.assert_allclose(float(loss), float(lm_loss(params, torch.from_numpy(tokens), cfg)),
                               rtol=1e-5)


def test_zb_gradients_equal_the_1f1b_ones_on_the_port():
    """The split only reorders the same backward: zb's gradients within
    rtol 2e-4 / atol 1e-6 of 1f1b's (tests/test_pipeline_1f1b.py's)."""
    _, cfg = _cfgs()
    _, params = _both(4, JaxConfig(**SHAPE))
    tokens = torch.from_numpy(_tokens(8, 17, 5))
    m = _cpu_mesh(2, 2)
    _, g_1f1b = tpl.make_pipeline_lm_1f1b_grad(m, cfg, 2, 4)(
        dict(params, blocks=tpl.shard_blocks(params["blocks"], 2)), tokens)
    for schedule in ("zb", "zb-stash"):
        _, g = _port_vag(schedule, m, cfg, 1, 4, 1)(
            dict(params, blocks=tpl.shard_blocks_interleaved(params["blocks"], 2, 1)), tokens)
        g = dict(g, blocks=tpl.unshard_blocks_interleaved(g["blocks"]))
        ref = dict(g_1f1b, blocks=tpl.unshard_blocks(g_1f1b["blocks"]))
        for a, b in zip(param_leaves(g), param_leaves(ref)):
            torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("layout", ["vshape", "vshape_tp"])
def test_vshape_layouts_equal_jax_and_roundtrip(layout):
    jcfg, cfg = _cfgs(n_layers=8)
    jparams, params = _both(0, jcfg)
    if layout == "vshape":
        staged = tpl.shard_blocks_vshape(params["blocks"], 2)
        jstaged = jtpl.shard_blocks_vshape(jparams["blocks"], 2)
        back = tpl.unshard_blocks_vshape(staged)
    else:
        staged = tpl.shard_blocks_vshape_tp(params["blocks"], cfg, 2, 2)
        jstaged = jtpl.shard_blocks_vshape_tp(jparams["blocks"], jcfg, 2, 2)
        back = tpl.unshard_blocks_vshape_tp(staged, cfg)
    for k, v in staged.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jstaged[k]), err_msg=k)
    for k, v in params["blocks"].items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    with pytest.raises(ValueError, match="divisible"):
        tpl.shard_blocks_vshape(params["blocks"], 3)


@pytest.mark.parametrize("schedule,model", [("zb", 1), ("zb", 2), ("zb-v", 1), ("zb-v", 2),
                                            ("zb-stash", 1)])
def test_train_step_moves_the_weights(schedule, model):
    """Two Adam steps of ``make_pipeline_lm_train_step`` (stage 2 x data
    2 x model): the first step's loss is the single program's, the
    weights move and the second loss is finite."""
    _, cfg = _cfgs(n_layers=8 if schedule == "zb-v" else 4)
    _, params = _both(7, JaxConfig(**dataclasses.asdict(cfg)))
    v = 2 if schedule == "zb-v" else 1
    shard, _ = lm_block_layout(schedule, 2, v, cfg=cfg, tp=model)
    opt = build_optimizer(1e-2)
    step = make_pipeline_lm_train_step(_cpu_mesh(2, 2, model), cfg, 2, 2, opt,
                                       schedule=schedule, num_virtual=v, tensor_parallel=model)
    st = tree_map(lambda a: a.clone(), dict(params, blocks=shard(params["blocks"])))
    before = st["blocks"]["w_qkv"].clone()
    state = opt.init(param_leaves(st))
    tokens = [torch.from_numpy(_tokens(8, 17, 10 + i)) for i in range(2)]
    st, state, loss = step(st, state, tokens[0])
    np.testing.assert_allclose(float(loss), float(lm_loss(params, tokens[0], cfg)), rtol=1e-5)
    assert not torch.equal(st["blocks"]["w_qkv"], before)
    st, state, loss = step(st, state, tokens[1])
    assert np.isfinite(float(loss))


LM = ["lm", "--device", "cpu", "--steps", "2", "--batch-size", "8", "--seq-len", "24",
      "--d-model", "16", "--heads", "2", "--eval-batches", "2", "--log-every", "1",
      "--stages", "2", "--microbatches", "4"]


@pytest.mark.parametrize("schedule,layers", [("zb", 4), ("zb-v", 8), ("zb-stash", 4)])
def test_cli_lm_trains_each_zero_bubble_schedule(capsys, schedule, layers):
    from tpu_dist_nn_torch.cli import main

    assert main(LM + ["--layers", str(layers), "--schedule", schedule]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(report["final_train_loss"]) and report["perplexity"] > 1


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
    ["--layers", "4", "--schedule", "zb-stash", "--tensor-parallel", "2"],
    ["--layers", "12", "--schedule", "zb-v", "--virtual-stages", "3"],
], ids=["zb-stash-tp", "zb-v-virtual-3"])
def test_cli_refusals_in_jax_texts(flags):
    port, jax_text = _last_err_lines(flags)
    assert port == jax_text


def test_trainer_refusals_in_jax_texts():
    jcfg, cfg = _cfgs()
    with pytest.raises(ValueError) as want:
        jlt.make_pipeline_lm_train_step(_jmesh(2, 1, 2), jcfg, 2, 2, jax_build_optimizer(1e-3),
                                        schedule="zb-stash", tensor_parallel=2)
    with pytest.raises(ValueError) as got:
        make_pipeline_lm_train_step(_cpu_mesh(2, 1, 2), cfg, 2, 2, build_optimizer(1e-3),
                                    schedule="zb-stash", tensor_parallel=2)
    assert str(got.value) == str(want.value) and "dense-LM only" in str(got.value)


def test_the_fcnn_pipeline_refuses_zero_bubble_with_jax_texts():
    """JAX's text for zb and zb-v; zb-stash, which the JAX trainer lets
    through to a crash on its layer metadata, gets the same text."""
    import optax

    from tpu_dist_nn.train.pipeline_trainer import make_pipeline_train_step as jax_step
    from tpu_dist_nn_torch.train.pipeline_trainer import make_pipeline_train_step

    with pytest.raises(ValueError) as want:
        jax_step(None, None, 2, optax.adam(1e-3), schedule="zb")
    for schedule in ("zb", "zb-v", "zb-stash"):
        with pytest.raises(ValueError) as got:
            make_pipeline_train_step(_cpu_mesh(2), None, 2, build_optimizer(1e-3),
                                     schedule=schedule)
        assert str(got.value) == str(want.value) and "transformer LM" in str(got.value)


@pytest.mark.parametrize("flags,missing", [
    # ZeRO and the MoE LM are ported: their zero-bubble compositions that
    # the JAX package refuses are refused in its texts.
    (["--schedule", "zb", "--seq-parallel", "2", "--fsdp"],
     "--fsdp shards over the data axis: needs --data-parallel >= 2"),
    (["--schedule", "zb-v", "--seq-parallel", "2", "--experts", "4"],
     "--experts x --seq-parallel x --stages supports --schedule gpipe only"),
    (["--schedule", "zb", "--experts", "4", "--tensor-parallel", "2"],
     "--tensor-parallel x --experts x --stages is out of scope"),
    (["--schedule", "zb-stash", "--experts", "4"], "zb-stash is dense-LM only"),
], ids=["zb-sp", "zb-v-sp", "zb-ep", "zb-stash-ep"])
def test_cli_refuses_zero_bubble_compositions_by_what_they_lack(flags, missing):
    from tpu_dist_nn_torch.cli import main

    err = io.StringIO()
    with redirect_stderr(err):
        assert main(LM + ["--layers", "4"] + flags) == 2
    assert missing in err.getvalue()


def test_resume_into_another_zero_bubble_layout_is_refused(tmp_path):
    from tpu_dist_nn_torch.checkpoint import CheckpointManager
    from tpu_dist_nn_torch.data.text import lm_batches, lm_sequences
    from tpu_dist_nn_torch.train.lm_trainer import LMTrainConfig, train_lm
    from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

    cfg = TransformerConfig(vocab_size=32, d_model=16, n_heads=2, n_layers=4, d_ff=32,
                            max_seq_len=16)
    _, params = _both(0, JaxConfig(**dataclasses.asdict(cfg)))
    rows = lm_sequences(np.random.default_rng(0).integers(0, 32, 2000).astype(np.int32), 16)
    tc = LMTrainConfig(steps=2, batch_size=4, log_every=1)
    common = dict(mesh=_cpu_mesh(2), num_stages=2, num_microbatches=2)
    out, hist = train_lm(params, cfg, lm_batches(rows, 4, seed=0, epochs=None), tc,
                         schedule="zb-v", checkpoints=CheckpointManager(tmp_path / "ck", keep=2),
                         checkpoint_every=1, **common)
    assert out["blocks"]["w_qkv"].shape[0] == 4 and len(hist) == 2
    with pytest.raises(InvalidArgumentError, match="different placement"):
        train_lm(params, cfg, lm_batches(rows, 4, seed=0, epochs=None), tc, schedule="zb",
                 checkpoints=CheckpointManager(tmp_path / "ck", keep=2), **common)
