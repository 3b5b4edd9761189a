"""``steps_per_call`` (the superstep) against the JAX package, on the CPU.

The JAX package's ``make_lm_train_step(steps_per_call=K)`` runs K
optimizer steps in one ``lax.scan``-ed program and ``train_lm`` feeds it
K-batch groups; the port's superstep runs the same K steps in one call
(on a card, one captured CUDA graph). A small LM (2 layers, d 32, T 16)
with the same weights and batches on both sides: losses at rtol 1e-5
on the first step and 1e-4 after, params at the JAX tests' 5e-4, the
history's step stamps equal, and each validation error raised with
JAX's text. On the CPU both packages run the materialised attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist_nn.models import transformer as jt
from tpu_dist_nn.train.lm_trainer import LMTrainConfig as JaxLMTrainConfig
from tpu_dist_nn.train.lm_trainer import make_lm_train_step as jax_make_lm_train_step
from tpu_dist_nn.train.lm_trainer import train_lm as jax_train_lm
from tpu_dist_nn.train.optimizers import build_optimizer as jax_build_optimizer
from tpu_dist_nn_torch.cli import main as port_main
from tpu_dist_nn_torch.data import text
from tpu_dist_nn_torch.models.transformer import (
    TransformerConfig,
    param_leaves,
    transformer_params_from_jax,
    tree_map,
)
from tpu_dist_nn_torch.train.lm_trainer import LMTrainConfig, make_lm_train_step, train_lm
from tpu_dist_nn_torch.train.optimizers import build_optimizer

torch.set_num_threads(1)
CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=16)


def _both(seed=0):
    jcfg = jt.TransformerConfig(**CFG)
    jparams = jt.init_transformer(jax.random.key(seed), jcfg)
    params = transformer_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, TransformerConfig(**CFG), params


def _batches(n, seed=0):
    rows = text.lm_sequences(text.encode(text.synthetic_wikitext(20_000, seed=seed)) % 64, 16)
    return [b for _, b in zip(range(n), text.lm_batches(rows, 4, seed=seed, epochs=None))]


def _jax_leaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


@pytest.mark.parametrize("k", [2, 4])
def test_superstep_matches_jax_superstep(k):
    jcfg, jparams, cfg, params = _both(seed=1)
    kw = dict(learning_rate=3e-3, schedule="cosine", warmup_steps=1, total_steps=8,
              clip_norm=1.0)
    stack = np.stack(_batches(k))
    jopt = jax_build_optimizer(**kw)
    jstep = jax_make_lm_train_step(jcfg, jopt, steps_per_call=k)
    jp, _, jlosses = jstep(jparams, jopt.init(jparams), jnp.asarray(stack))
    opt = build_optimizer(**kw)
    p = tree_map(lambda a: a.clone().requires_grad_(True), params)
    state = opt.init(param_leaves(p))
    _, _, losses = make_lm_train_step(cfg, opt, steps_per_call=k)(
        p, state, torch.as_tensor(stack).long())
    assert losses.shape == (k,) and int(state.count) == k
    np.testing.assert_allclose(losses[0].item(), float(jlosses[0]), rtol=1e-5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4)
    for a, b in zip(param_leaves(p), _jax_leaves(jp)):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=5e-4, rtol=5e-4)


def test_superstep_is_k_single_steps_bit_for_bit():
    _, _, cfg, params = _both(seed=2)
    stack = torch.as_tensor(np.stack(_batches(3, seed=1))).long()
    runs = []
    for k in (1, 3):
        opt = build_optimizer(1e-2, grad_accum=2, total_steps=6)
        p = tree_map(lambda a: a.clone().requires_grad_(True), params)
        state = opt.init(param_leaves(p))
        if k == 1:
            step = make_lm_train_step(cfg, opt)
            losses = torch.stack([step(p, state, t)[2] for t in stack])
        else:
            losses = make_lm_train_step(cfg, opt, steps_per_call=3)(p, state, stack)[2]
        runs.append([losses, *param_leaves(p), *state.mu, *state.nu, *state.acc, state.count])
        assert state.mini_step == 1
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("k,steps", [(2, 6), (4, 6)], ids=["k2", "k4-short-last-group"])
def test_train_lm_superstep_matches_jax_train_lm(k, steps):
    jcfg, jparams, cfg, params = _both(seed=3)
    batches = _batches(steps, seed=2)
    kw = dict(learning_rate=3e-3, steps=steps, batch_size=4, seq_len=16, log_every=k,
              warmup_steps=1, lr_schedule="cosine", steps_per_call=k)
    _, jhist = jax_train_lm(jparams, jcfg, batches, JaxLMTrainConfig(**kw))
    params_out, hist = train_lm(params, cfg, batches, LMTrainConfig(**kw))
    # logged at every k-th step and at the last (a shorter last group)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist]
    assert hist[-1]["step"] == steps
    got, want = np.array([h["loss"] for h in hist]), np.array([h["loss"] for h in jhist])
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert all(b["seconds"] >= a["seconds"] for a, b in zip(hist, hist[1:]))
    # the same run one step a call
    _, one = train_lm(params, cfg, batches, LMTrainConfig(**{**kw, "steps_per_call": 1}))
    ones = {h["step"]: h["loss"] for h in one}
    np.testing.assert_array_equal(got, [ones[h["step"]] for h in hist])


@pytest.mark.parametrize("kw,message", [
    (dict(steps_per_call=0), "steps_per_call must be >= 1, got 0"),
    (dict(steps_per_call=3, log_every=4),
     r"log_every \(4\) must be a multiple of steps_per_call \(3\): per-step timestamps "
     "inside one grouped device call are not fetch barriers"),
], ids=["k0", "log-every"])
def test_superstep_validation_matches_jax(kw, message):
    jcfg, jparams, cfg, params = _both()
    with pytest.raises(ValueError, match=message):
        jax_train_lm(jparams, jcfg, [], JaxLMTrainConfig(**kw))
    with pytest.raises(ValueError, match=message):
        train_lm(params, cfg, [], LMTrainConfig(**kw))


def test_custom_step_fn_refuses_a_superstep_with_jax_text():
    jcfg, jparams, cfg, params = _both()
    message = ("steps_per_call > 1 is the built-in single-chip path only (custom step_fn "
               "and pipelined schedules run one step per call)")
    kw = dict(steps_per_call=2, log_every=2)
    with pytest.raises(ValueError, match=message.replace("(", r"\(").replace(")", r"\)")):
        jax_train_lm(jparams, jcfg, [], JaxLMTrainConfig(**kw),
                     step_fn=lambda opt: jax_make_lm_train_step(jcfg, opt))
    with pytest.raises(ValueError, match=message.replace("(", r"\(").replace(")", r"\)")):
        train_lm(params, cfg, [], LMTrainConfig(**kw),
                 step_fn=lambda opt: make_lm_train_step(cfg, opt))
    # one step a call, a custom step runs
    _, hist = train_lm(params, cfg, _batches(2), LMTrainConfig(steps=2, batch_size=4,
                                                               seq_len=16, log_every=1),
                       step_fn=lambda opt: make_lm_train_step(cfg, opt))
    assert [h["step"] for h in hist] == [1, 2]


def test_cli_lm_steps_per_call(tmp_path, capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(text.synthetic_wikitext(40_000, seed=1))
    metrics = tmp_path / "m.jsonl"
    args = ["lm", "--device", "cpu", "--corpus", str(corpus), "--d-model", "32", "--heads",
            "2", "--layers", "2", "--seq-len", "16", "--steps", "4", "--batch-size", "4",
            "--eval-batches", "1", "--log-every", "2"]
    assert port_main(args + ["--steps-per-call", "2", "--metrics-out", str(metrics)]) == 0
    lines = metrics.read_text().splitlines()
    assert len(lines) == 4  # the begin record, steps 2 and 4, then the report
    capsys.readouterr()
    assert port_main(args + ["--steps-per-call", "3"]) == 2
    assert "log_every (2) must be a multiple of steps_per_call (3)" in capsys.readouterr().err
