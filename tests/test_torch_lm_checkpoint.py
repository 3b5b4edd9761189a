"""LM checkpoints and ``tdn lm --checkpoint-dir --sample-bytes`` in the
port, on the CPU.

``train_lm(checkpoints=)`` against the JAX trainer's contract
(``tpu_dist_nn/train/lm_trainer.py``; ``tests/test_checkpoint.py``,
``tests/test_train.py`` and ``tests/test_transformer.py``'s resume
cases): a run interrupted at a checkpoint and resumed is bit-equal in
params, Adam state and history to a straight run (the CPU runs the same
operations in the same order); the asynchronous manager resumes and its
enqueued saves land when the loop raises; ``checkpoint_every`` must be a
multiple of ``steps_per_call`` (JAX's text, raised by both packages).
Then the CLI: a sample from the trained (and resumed) params, trimmed at
``--eos-id``, and each sampling refusal before any training, with the
JAX package's texts.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from tpu_dist_nn.models import transformer as jt
from tpu_dist_nn.train.lm_trainer import LMTrainConfig as JaxLMTrainConfig
from tpu_dist_nn.train.lm_trainer import train_lm as jax_train_lm
from tpu_dist_nn_torch.checkpoint import AsyncCheckpointManager, CheckpointManager
from tpu_dist_nn_torch.cli import main as port_main
from tpu_dist_nn_torch.data import text
from tpu_dist_nn_torch.models.generate import generate
from tpu_dist_nn_torch.models.transformer import (
    TransformerConfig,
    init_transformer,
    param_leaves,
)
from tpu_dist_nn_torch.train.lm_trainer import LMTrainConfig, train_lm
from tpu_dist_nn_torch.train.optimizers import build_optimizer

torch.set_num_threads(1)
CFG = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_seq_len=16)
TINY = ["--device", "cpu", "--d-model", "16", "--heads", "2", "--layers", "1", "--seq-len",
        "16", "--batch-size", "4", "--eval-batches", "1"]


class Interrupted(Exception):
    pass


def _rows():
    return text.lm_sequences(np.random.default_rng(0).integers(0, 32, 4000).astype(np.int32), 16)


def _batches(stop=None):
    for i, b in enumerate(text.lm_batches(_rows(), 4, seed=9, epochs=None)):
        if i == stop:
            raise Interrupted(f"stopped before step {stop + 1}")
        yield b


def _params(seed=1):
    return init_transformer(torch.Generator().manual_seed(seed), TransformerConfig(**CFG),
                            device="cpu")


def _state_arrays(manager, params):
    """The newest checkpoint's params and Adam state, restored."""
    opt = build_optimizer(1e-3)
    step, state = manager.restore({"params": params,
                                   "opt_state": opt.init(param_leaves(params))})
    o = state["opt_state"]
    return step, [*param_leaves(state["params"]), *o.mu, *o.nu, torch.as_tensor(o.count)]


@pytest.mark.parametrize("manager,k,stop,every", [
    (CheckpointManager, 1, 4, 2),
    (AsyncCheckpointManager, 2, 4, 2),
    (CheckpointManager, 4, 3, None),
], ids=["sync", "async-k2", "off-grid-resume-k4"])
def test_interrupted_run_resumes_bit_equal_to_a_straight_run(tmp_path, manager, k, stop, every):
    cfg = TransformerConfig(**CFG)
    tc = LMTrainConfig(learning_rate=3e-3, steps=8, batch_size=4, seq_len=16, log_every=4,
                       warmup_steps=2, lr_schedule="cosine", clip_norm=1.0, steps_per_call=k)
    straight_ck = manager(tmp_path / "straight", keep=5)
    ref, ref_hist = train_lm(_params(), cfg, _batches(), tc, checkpoints=straight_ck,
                             checkpoint_every=every)
    first_ck = manager(tmp_path / "ck", keep=5)
    # the off-grid case checkpoints step 3 one step a call, as JAX's
    # test_steps_per_call_resume_realigns_to_step_grid does
    first_tc = dataclasses.replace(tc, steps_per_call=1) if every is None else tc
    with pytest.raises(Interrupted):
        train_lm(_params(), cfg, _batches(stop), first_tc, checkpoints=first_ck,
                 checkpoint_every=every or stop)
    assert first_ck.latest_step() == stop  # flushed on the way out
    second_ck = manager(tmp_path / "ck", keep=5)
    got, hist = train_lm(_params(), cfg, _batches(), tc, checkpoints=second_ck,
                         checkpoint_every=every)
    for m in (straight_ck, first_ck, second_ck):
        if hasattr(m, "close"):
            m.close()
    assert all(torch.equal(a, b) for a, b in zip(param_leaves(got), param_leaves(ref)))
    assert [h["step"] for h in hist] == [h["step"] for h in ref_hist if h["step"] > stop]
    by_step = {h["step"]: h["loss"] for h in ref_hist}
    assert all(h["loss"] == by_step[h["step"]] for h in hist)
    meta = json.loads((tmp_path / "ck" / "manifest.json").read_text())["metadata"]
    straight_meta = json.loads((tmp_path / "straight" / "manifest.json").read_text())["metadata"]
    assert meta["8"] == straight_meta["8"] == {"step": 8, "loss": by_step[8]}
    s1, a = _state_arrays(CheckpointManager(tmp_path / "ck"), _params())
    s2, b = _state_arrays(CheckpointManager(tmp_path / "straight"), _params())
    assert s1 == s2 == 8 and all(torch.equal(x, y) for x, y in zip(a, b))


def test_async_manager_resumes_and_lands_saves_when_the_loop_raises(tmp_path):
    cfg = TransformerConfig(**CFG)
    tc = LMTrainConfig(steps=4, batch_size=4, seq_len=16, log_every=2)
    mgr = AsyncCheckpointManager(tmp_path, keep=3)
    _, history = train_lm(_params(0), cfg, _batches(), tc, checkpoints=mgr, checkpoint_every=2)
    assert mgr.latest_step() == 4 and [h["step"] for h in history] == [2, 4]
    mgr2 = AsyncCheckpointManager(tmp_path, keep=3)
    _, history2 = train_lm(_params(0), cfg, _batches(), tc, checkpoints=mgr2, checkpoint_every=2)
    assert history2 == []  # resumed at the last step: nothing left to run
    mgr.close()
    mgr2.close()
    crash = AsyncCheckpointManager(tmp_path / "crash", keep=3)
    with pytest.raises(Interrupted):
        train_lm(_params(0), cfg, _batches(2), LMTrainConfig(steps=6, batch_size=4, seq_len=16,
                                                              log_every=2),
                 checkpoints=crash, checkpoint_every=2)
    assert crash.latest_step() == 2  # the enqueued save landed
    crash.close()


def test_checkpoint_every_must_be_a_multiple_of_steps_per_call(tmp_path):
    kw = dict(steps=4, batch_size=4, seq_len=16, log_every=4, steps_per_call=4)
    jparams = jt.init_transformer(jax.random.key(0), jt.TransformerConfig(**CFG))
    with pytest.raises(ValueError) as jerr:
        jax_train_lm(jparams, jt.TransformerConfig(**CFG), [], JaxLMTrainConfig(**kw),
                     checkpoint_every=6)
    with pytest.raises(ValueError) as err:
        train_lm(_params(), TransformerConfig(**CFG), [], LMTrainConfig(**kw),
                 checkpoints=CheckpointManager(tmp_path), checkpoint_every=6)
    assert str(err.value) == str(jerr.value)
    assert "checkpoint_every (6) must be a multiple of steps_per_call (4)" in str(err.value)


def _cli(args, capsys):
    rc = port_main(["lm", *TINY, *args])
    out = capsys.readouterr()
    return rc, out.out.strip().splitlines(), out.err


def test_cli_lm_samples_from_the_trained_params_and_resumes(tmp_path, capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(text.synthetic_wikitext(40_000, seed=1))
    ck = tmp_path / "ck"
    common = ["--corpus", str(corpus), "--steps", "4", "--log-every", "2", "--checkpoint-dir",
              str(ck), "--sample-bytes", "8", "--temperature", "0", "--prompt", "The"]
    rc, lines, _ = _cli(common, capsys)
    assert rc == 0
    report = json.loads(lines[-1])
    assert json.loads((ck / "manifest.json").read_text())["steps"] == [2, 4]
    # the sample is greedy decoding from the step-4 params, decoded as text
    cfg = TransformerConfig(vocab_size=256, d_model=16, n_heads=2, n_layers=1, d_ff=64,
                            max_seq_len=16)
    params = init_transformer(torch.Generator().manual_seed(0), cfg, device="cpu")
    step, state = CheckpointManager(ck).restore(
        {"params": params, "opt_state": build_optimizer(1e-3).init(param_leaves(params))})
    tokens = generate(state["params"], cfg, text.encode("The")[None], 8)[0].numpy()
    assert step == 4 and report["sample"] == text.decode(tokens)
    # Resumed at the last step (nothing to train), trimmed at a stop byte.
    eos = int(tokens[3])
    rc, lines, _ = _cli([*common, "--eos-id", str(eos)], capsys)
    report2 = json.loads(lines[-1])
    assert rc == 0 and report2["final_train_loss"] is None
    assert report2["sample"] == text.decode(tokens[:int(np.flatnonzero(tokens == eos)[0])])
    assert report2["loss_nats_per_token"] == report["loss_nats_per_token"]


@pytest.mark.parametrize("args,message", [
    (["--eos-id", "256"], "--eos-id must be a byte id in [0, 256), got 256"),
    (["--sample-bytes", "4", "--temperature", "-1"], "--temperature must be >= 0"),
    (["--sample-bytes", "4", "--prompt", ""], "--prompt must be non-empty"),
    (["--sample-bytes", "4", "--prompt", "x" * 16],
     "--prompt is 16 bytes but must be shorter than --seq-len 16 to leave room for generation"),
    (["--sample-bytes", "13", "--prompt", "abcd"],
     "--sample-bytes 13 does not fit: the 4-byte prompt leaves 12 positions within "
     "--seq-len 16"),
    (["--sample-bytes", "4", "--top-k", "0"], "top_k must be in [1, 256], got 0"),
    (["--sample-bytes", "4", "--top-p", "1.5"], "top_p must be in (0, 1], got 1.5"),
    (["--sample-bytes", "4", "--temperature", "0", "--top-k", "5"],
     "top_k/top_p shape the sampling distribution; greedy decoding (temperature == 0) "
     "would silently ignore them"),
    (["--checkpoint-dir", "ck", "--checkpoint-format", "orbax"],
     "--checkpoint-format orbax is not ported: the port writes its native .npz store "
     "(drop the flag)"),
], ids=["eos-id", "temperature", "empty-prompt", "long-prompt", "no-room", "top-k", "top-p",
        "greedy-top-k", "orbax"])
def test_cli_lm_refuses_bad_flags_before_training(tmp_path, capsys, monkeypatch, args, message):
    monkeypatch.chdir(tmp_path)
    metrics = tmp_path / "m.jsonl"
    rc, _, err = _cli(["--steps", "2", "--metrics-out", str(metrics), *args], capsys)
    assert rc == 2 and err.strip() == f"error: {message}"
    assert not metrics.exists() and not (tmp_path / "ck").exists()
