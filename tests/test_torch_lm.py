"""The port's LM training slice against the JAX package, on the CPU.

Transformer forward and loss gradients from weights carried across
(``transformer_params_from_jax``), the text pipeline, the optimizer
against optax, ``train_lm`` / ``evaluate_lm`` against the JAX trainer on
the same batches, and the CLI's ``lm`` verb. Inputs are made with numpy
and handed to both packages; the port runs with ``device="cpu"``, where
attention is the materialised ``dot_product_attention`` on both sides.
Tolerances are the JAX tests': atol 1e-5 forward, 5e-4 gradients
(``tests/test_flash_attention.py``), rtol 1e-5 on a first loss and 1e-4
over three steps.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_dist_nn.data import text as jax_text
from tpu_dist_nn.models import transformer as jt
from tpu_dist_nn.train.lm_trainer import LMTrainConfig as JaxLMTrainConfig
from tpu_dist_nn.train.lm_trainer import evaluate_lm as jax_evaluate_lm
from tpu_dist_nn.train.lm_trainer import train_lm as jax_train_lm
from tpu_dist_nn.train.optimizers import build_optimizer as jax_build_optimizer
from tpu_dist_nn_torch.cli import main as port_main
from tpu_dist_nn_torch.data import text
from tpu_dist_nn_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_transformer,
    lm_loss,
    num_params,
    param_leaves,
    transformer_params_from_jax,
    tree_map,
)
from tpu_dist_nn_torch.train.lm_trainer import (
    LMTrainConfig,
    evaluate_lm,
    make_lm_train_step,
    train_lm,
)
from tpu_dist_nn_torch.train.optimizers import apply_updates, build_optimizer
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

torch.set_num_threads(1)
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=32)
REPORT_KEYS = {"train_seconds", "final_train_loss", "eval_split", "loss_nats_per_token",
               "perplexity", "bits_per_byte", "eval_rows_used"}


def _both(seed=0, **over):
    """The JAX params, and the same weights carried into the port."""
    jcfg = jt.TransformerConfig(**{**CFG, **over})
    jparams = jt.init_transformer(jax.random.key(seed), jcfg)
    params = transformer_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, TransformerConfig(**{**CFG, **over}), params


def _tokens(batch=4, t=17, vocab=64, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (batch, t)).astype(np.int32)


def _with_grad(params):
    return tree_map(lambda a: a.clone().requires_grad_(True), params)


def test_forward_and_loss_gradients_match_jax():
    jcfg, jparams, cfg, params = _both()
    tokens = _tokens()
    want = np.asarray(jt.forward(jparams, jnp.asarray(tokens[:, :-1]), jcfg))
    got = forward(params, torch.from_numpy(tokens[:, :-1]), cfg)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    jloss, jgrads = jax.value_and_grad(jt.lm_loss)(jparams, jnp.asarray(tokens), jcfg)
    p = _with_grad(params)
    loss = lm_loss(p, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    grads = torch.autograd.grad(loss, param_leaves(p))
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves) == 16
    for g, w in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4, rtol=5e-4)


def test_init_has_the_jax_layout_and_scales():
    jcfg, jparams, cfg, _ = _both()
    params = init_transformer(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert num_params(params) == jt.num_params(jparams)
    for got, want in zip(param_leaves(params), jax.tree.leaves(jparams)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    big = TransformerConfig(vocab_size=256, d_model=256, n_heads=4, n_layers=2, d_ff=1024)
    p = init_transformer(torch.Generator().manual_seed(1), big, device="cpu")
    b = p["blocks"]
    for leaf, std in ((p["tok_embed"], 256**-0.5), (b["w_qkv"], 256**-0.5),
                      (b["w_o"], 256**-0.5 / 2), (b["w_down"], 1024**-0.5 / 2),
                      (p["pos_embed"], 0.01)):
        assert abs(float(leaf.std()) / std - 1) < 0.05
    assert torch.equal(b["ln1_g"], torch.ones(2, 256)) and not b["b_qkv"].any()
    with pytest.raises(ValueError, match="divisible"):
        TransformerConfig(d_model=30, n_heads=4)
    with pytest.raises(InvalidArgumentError, match="compute_dtype"):
        TransformerConfig(compute_dtype="float16")


def test_causality():
    _, _, cfg, params = _both()
    tokens = torch.from_numpy(_tokens(t=16))
    base = forward(params, tokens, cfg)
    perturbed = tokens.clone()
    perturbed[:, 10:] = (perturbed[:, 10:] + 1) % 64
    got = forward(params, perturbed, cfg)
    torch.testing.assert_close(got[:, :10], base[:, :10], atol=1e-5, rtol=0)
    assert float((got[:, 10:] - base[:, 10:]).abs().max()) > 1e-4


def test_remat_gradients_equal_no_remat():
    _, _, cfg, params = _both()
    tokens = torch.from_numpy(_tokens())
    grads = []
    for c in (cfg, dataclasses.replace(cfg, remat=True)):
        p = _with_grad(params)
        grads.append(torch.autograd.grad(lm_loss(p, tokens, c), param_leaves(p)))
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, atol=1e-7, rtol=1e-6)


def test_bf16_loss_close_to_f32_and_master_grads_stay_f32():
    _, _, cfg, params = _both()
    tokens = torch.from_numpy(_tokens(t=33))
    l32 = float(lm_loss(params, tokens, cfg))
    p = _with_grad(params)
    loss16 = lm_loss(p, tokens, dataclasses.replace(cfg, compute_dtype="bfloat16"))
    assert abs(float(loss16.detach()) - l32) / l32 < 0.05  # bf16 keeps ~3 decimal digits
    for g in torch.autograd.grad(loss16, param_leaves(p)):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())


def test_text_pipeline_matches_jax(tmp_path, monkeypatch):
    s = "Hello = WikiText = \n naïve café"
    assert text.decode(text.encode(s)) == s
    np.testing.assert_array_equal(text.encode(s), jax_text.encode(s))
    assert text.synthetic_wikitext(5000, seed=3) == jax_text.synthetic_wikitext(5000, seed=3)
    tokens = text.encode(text.synthetic_wikitext(20_000, seed=1))
    rows = text.lm_sequences(tokens, 31)
    np.testing.assert_array_equal(rows, jax_text.lm_sequences(tokens, 31))
    got = list(text.lm_batches(rows, 8, seed=5, epochs=2))
    want = list(jax_text.lm_batches(rows, 8, seed=5, epochs=2))
    assert len(got) == len(want) == 2 * (len(rows) // 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(InvalidArgumentError, match="batch_size"):
        next(text.lm_batches(rows[:3], 4))
    # Lookup order: the vendored real corpus by default, the same file as
    # the JAX package's; an explicit path or $TDN_WIKITEXT_PATH first.
    monkeypatch.delenv("TDN_WIKITEXT_PATH", raising=False)
    corpus, source = text.load_corpus()
    assert source == jax_text.load_corpus()[1] and source.endswith("realtext_corpus.txt")
    assert len(corpus) > 5_000_000
    f = tmp_path / "wiki.train.tokens"
    f.write_text("real corpus text here")
    monkeypatch.setenv("TDN_WIKITEXT_PATH", str(f))
    assert text.load_corpus() == ("real corpus text here", str(f))
    missing = tmp_path / "nope.txt"
    monkeypatch.delenv("TDN_WIKITEXT_PATH")
    monkeypatch.setattr(text, "_VENDORED_CORPUS", missing)
    monkeypatch.setattr(text, "_VENDORED_CORPUS_R3", missing)
    monkeypatch.setattr(text, "_DEFAULT_PATHS", ())
    assert text.load_corpus(synthetic_chars=1000) == (text.synthetic_wikitext(1000), "synthetic")
    with pytest.raises(ValueError, match="allow_synthetic"):
        text.load_corpus(allow_synthetic=False)


OPTIMIZERS = {
    "constant": dict(learning_rate=1e-2),
    "cosine-warmup": dict(learning_rate=1e-2, schedule="cosine", warmup_steps=2,
                          total_steps=5),
    "warmup": dict(learning_rate=1e-2, warmup_steps=3),
    "clip": dict(learning_rate=1e-2, clip_norm=1.0),
    "weight-decay": dict(learning_rate=1e-2, weight_decay=0.1),
    "grad-accum": dict(learning_rate=1e-2, schedule="cosine", warmup_steps=1, total_steps=10,
                       clip_norm=2.0, grad_accum=2),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_build_optimizer_matches_optax(name):
    kw = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jopt = jax_build_optimizer(**kw)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    opt = build_optimizer(**kw)
    leaves = [torch.from_numpy(init[k].copy()) for k in sorted(shapes)]
    state = opt.init(leaves)
    for step in range(5 * kw.get("grad_accum", 1)):
        # large enough that the clip triggers on some steps, not all
        g = {k: (rng.standard_normal(s) * (3.0 if step % 2 else 0.2)).astype(np.float32)
             for k, s in shapes.items()}
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate,
                                      jparams)
        jparams = optax.apply_updates(jparams, updates)
        ups = opt.update([torch.from_numpy(g[k]) for k in sorted(shapes)], state, leaves)
        if ups is not None:
            apply_updates(leaves, ups)
        for k, t in zip(sorted(shapes), leaves):
            np.testing.assert_allclose(t.numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7)
    moved = [not np.allclose(t.numpy(), init[k]) for k, t in zip(sorted(shapes), leaves)]
    assert all(moved)


def test_optimizer_schedule_and_validation():
    opt = build_optimizer(1.0, schedule="cosine", warmup_steps=2, total_steps=6)
    # optax reads the schedule at the count before the update: lr 0 first
    assert [opt.lr(c) for c in range(3)] == [0.0, 0.5, 1.0]
    assert opt.lr(6) == pytest.approx(0.0, abs=1e-12) and opt.lr(9) == opt.lr(6)
    for kw, match in ((dict(schedule="linear"), "unknown"), (dict(warmup_steps=-1), "warmup"),
                      (dict(clip_norm=0.0), "clip_norm"), (dict(weight_decay=-1.0), "weight"),
                      (dict(grad_accum=0), "grad_accum"), (dict(schedule="cosine"), "cosine"),
                      (dict(total_steps=1, grad_accum=2), "no optimizer update")):
        with pytest.raises(InvalidArgumentError, match=match):
            build_optimizer(1e-3, **kw)
    with pytest.warns(UserWarning, match="never apply"):
        build_optimizer(1e-3, total_steps=5, grad_accum=2)


def test_train_lm_matches_jax_train_lm():
    jcfg, jparams, cfg, params = _both(seed=3)
    rows = text.lm_sequences(text.encode(text.synthetic_wikitext(30_000, seed=2)) % 64, 24)
    batches = [b for _, b in zip(range(3), text.lm_batches(rows, 4, seed=0, epochs=None))]
    kw = dict(learning_rate=3e-3, steps=3, batch_size=4, seq_len=24, log_every=1,
              warmup_steps=1, lr_schedule="cosine", clip_norm=1.0)
    jparams_out, jhist = jax_train_lm(jparams, jcfg, batches, JaxLMTrainConfig(**kw))
    before = [t.clone() for t in param_leaves(params)]
    params_out, hist = train_lm(params, cfg, batches, LMTrainConfig(**kw))
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [1, 2, 3]
    assert all(set(h) == {"step", "loss", "seconds"} for h in hist)
    got, want = np.array([h["loss"] for h in hist]), np.array([h["loss"] for h in jhist])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the caller's tensors are left as they were
    assert all(torch.equal(a, b) for a, b in zip(before, param_leaves(params)))
    assert not any(torch.equal(a, b) for a, b in zip(before, param_leaves(params_out)))
    want_eval = jax_evaluate_lm(jparams, jcfg, rows[:40], batch_size=8)
    got_eval = evaluate_lm(params, cfg, rows[:40], batch_size=8)
    assert got_eval["eval_rows_used"] == want_eval["eval_rows_used"] == 40
    for key in ("loss_nats_per_token", "perplexity", "bits_per_byte"):
        np.testing.assert_allclose(got_eval[key], want_eval[key], rtol=1e-5)
    assert evaluate_lm(params_out, cfg, rows[:40], batch_size=8, max_batches=2)[
        "eval_rows_used"] == 16
    with pytest.raises(InvalidArgumentError, match="one eval batch"):
        evaluate_lm(params_out, cfg, rows[:3], batch_size=8)


def test_the_superstep_is_not_ported_yet():
    # The superstep is ported (tests/test_torch_superstep.py holds it to
    # JAX's); the refusal that stood here became JAX's validation.
    _, _, cfg, params = _both()
    opt = build_optimizer(1e-3)
    with pytest.raises(ValueError, match="steps_per_call must be >= 1, got 0"):
        make_lm_train_step(cfg, opt, steps_per_call=0)
    assert callable(make_lm_train_step(cfg, opt, steps_per_call=2))
    with pytest.raises(ValueError, match=r"log_every \(50\) must be a multiple"):
        train_lm(params, cfg, [], LMTrainConfig(steps_per_call=4))


def test_cli_lm_on_the_cpu_prints_the_report(tmp_path, capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(text.synthetic_wikitext(40_000, seed=1))
    metrics = tmp_path / "m.jsonl"
    rc = port_main(["lm", "--device", "cpu", "--corpus", str(corpus), "--d-model", "32",
                    "--heads", "2", "--layers", "2", "--seq-len", "32", "--steps", "3",
                    "--batch-size", "4", "--lr", "3e-3", "--log-every", "1", "--remat",
                    "--eval-batches", "2", "--metrics-out", str(metrics)])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == REPORT_KEYS
    assert report["eval_split"] == "held-out" and report["eval_rows_used"] == 8
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert lines[0] == {"run": "begin"} and [r.get("step") for r in lines[1:4]] == [1, 2, 3]
    assert lines[-1]["final_report"] == report
