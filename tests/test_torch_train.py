"""The port's FCNN training slice against the JAX package's, on the CPU:
``train_fcnn`` / ``evaluate_fcnn`` from the same params and data,
``Engine.train`` (serving the trained weights, int8 re-quantized), the
CLI's ``train`` verb, the int8 warm-up gate, and the slice run with
``jax`` and ``tpu_dist_nn`` blocked from import.

Losses are held to rtol 1e-5 in the first epoch and 1e-4 after it: the
JAX step is one jitted program, the port's eager, so their sums run in
different orders.
"""

import json
import logging
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpu_dist_nn.api.engine import Engine as JaxEngine
from tpu_dist_nn.cli import main as tdn_main
from tpu_dist_nn.data.datasets import synthetic_mnist as jax_synthetic_mnist
from tpu_dist_nn.kernels.quantized import quantize_fcnn as jax_quantize_fcnn
from tpu_dist_nn.models.fcnn import init_fcnn as jax_init_fcnn
from tpu_dist_nn.train.trainer import TrainConfig as JaxTrainConfig
from tpu_dist_nn.train.trainer import evaluate_fcnn as jax_evaluate_fcnn
from tpu_dist_nn.train.trainer import train_fcnn as jax_train_fcnn
from tpu_dist_nn_torch.api import engine as engine_mod
from tpu_dist_nn_torch.api.engine import Engine
from tpu_dist_nn_torch.checkpoint import CheckpointManager
from tpu_dist_nn_torch.cli import main as port_main
from tpu_dist_nn_torch.core.schema import load_model, save_examples, save_model
from tpu_dist_nn_torch.data.datasets import real_digits, synthetic_mnist
from tpu_dist_nn_torch.kernels import forward_quantized, quantize_fcnn
from tpu_dist_nn_torch.models.fcnn import forward, init_fcnn, params_from_jax, spec_from_params
from tpu_dist_nn_torch.models.network import init_conv_mlp
from tpu_dist_nn_torch.train.trainer import (
    TrainConfig,
    cross_entropy,
    evaluate_fcnn,
    export_model,
    train_fcnn,
)
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError, UnavailableError

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
ACTS = ["relu", "relu", "softmax"]


@pytest.fixture(autouse=True)
def _pin_int8_serving(monkeypatch):
    # The gate measures and warns only, unless a test turns it on.
    monkeypatch.setenv("TDN_INT8_AUTO", "0")


def _losses_close(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["epoch"] == w["epoch"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5 if i == 0 else 1e-4)


CONFIGS = {
    "constant": {},
    "cosine-warmup": dict(lr_schedule="cosine", warmup_steps=5),
    "clip-norm": dict(clip_norm=0.1),
    "grad-accum-2": dict(grad_accum=2),
    "weight-decay": dict(weight_decay=1e-2, learning_rate=3e-3),
}


@pytest.mark.parametrize("kw", CONFIGS.values(), ids=CONFIGS.keys())
def test_train_fcnn_matches_jax(kw):
    data = jax_synthetic_mnist(256, num_classes=4, dim=12, seed=3)
    port_data = synthetic_mnist(256, num_classes=4, dim=12, seed=3)
    j0 = jax_init_fcnn(jax.random.key(0), [12, 16, 8, 4])
    jp, jh = jax_train_fcnn(j0, data, JaxTrainConfig(epochs=4, batch_size=32, seed=7, **kw),
                            eval_data=data)
    p0 = params_from_jax(j0, device="cpu")
    pp, ph = train_fcnn(p0, port_data, TrainConfig(epochs=4, batch_size=32, seed=7, **kw),
                        eval_data=port_data)
    _losses_close(ph, jh)
    assert [h["eval"] for h in ph] == [h["eval"] for h in jh]
    # The caller's params are untouched; the trained ones keep the ids.
    assert torch.equal(p0[0]["w"], params_from_jax(j0, device="cpu")[0]["w"])
    assert [p["act"] for p in pp] == [p["act"] for p in p0]
    assert all(p["w"].is_contiguous() and not p["w"].requires_grad for p in pp)


def test_activation_ids_stay_out_of_the_optimizer():
    # tests/test_train.py:47's check: ids come back as they went in.
    p0 = init_fcnn(torch.Generator().manual_seed(0), [12, 8, 4], ["tanh", "softmax"],
                   device="cpu")
    trained, _ = train_fcnn(p0, synthetic_mnist(64, num_classes=4, dim=12),
                            TrainConfig(epochs=1, batch_size=32, weight_decay=0.1))
    assert [p["act"] for p in trained] == [p["act"] for p in p0]


def test_cross_entropy_matches_jax():
    from tpu_dist_nn.train.trainer import cross_entropy as jax_cross_entropy

    rng = np.random.default_rng(0)
    logits = rng.normal(size=(9, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 9).astype(np.int32)
    want = float(jax_cross_entropy(logits, labels))
    got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_evaluate_fcnn_matches_jax():
    data = jax_synthetic_mnist(700, num_classes=5, dim=20, noise=0.9, seed=1)
    j0 = jax_init_fcnn(jax.random.key(2), [20, 16, 5])
    want = jax_evaluate_fcnn(j0, data, batch_size=256)
    got = evaluate_fcnn(params_from_jax(j0, device="cpu"),
                        synthetic_mnist(700, num_classes=5, dim=20, noise=0.9, seed=1),
                        batch_size=256)
    assert got == want
    assert 0.0 < got["accuracy"] < 1.0


@pytest.fixture(scope="module")
def digits_recipe():
    """The digits record's recipe on the port (64-128-64-10, 40 epochs,
    cosine after 50 warm-up steps), trained once for the module."""
    tr, te = real_digits("train"), real_digits("test")
    p0 = init_fcnn(torch.Generator().manual_seed(0), [64, 128, 64, 10], device="cpu")
    params, history = train_fcnn(
        p0, tr, TrainConfig(epochs=40, batch_size=64, lr_schedule="cosine", warmup_steps=50))
    return params, history, evaluate_fcnn(params, te), te


def test_digits_recipe_reaches_the_bar_on_the_cpu(digits_recipe):
    # BASELINE.md's >= 97 % held-out accuracy and F1 (tests/test_real_data.py:73-81).
    _, history, metrics, _ = digits_recipe
    assert len(history) == 40 and history[-1]["loss"] < history[0]["loss"]
    assert metrics["accuracy"] >= 0.97
    assert metrics["f1_score"] >= 0.97


def test_exported_digits_model_serves_at_the_eval_accuracy(digits_recipe, tmp_path):
    params, _, metrics, te = digits_recipe
    path = tmp_path / "digits.json"
    spec = export_model(params, ACTS, path, metrics=metrics, extra_metadata={"source": "t"})
    back = load_model(path)
    assert back.metadata == {"source": "t", "inference_metrics": metrics}
    np.testing.assert_array_equal(back.layers[0].weights, spec.layers[0].weights)
    res = Engine.up(path, device="cpu").run_inference(te.x, te.y, batch_size=100)
    assert res.metrics["accuracy"] == metrics["accuracy"]


def _model_file(tmp_path, sizes, seed=0):
    p0 = init_fcnn(torch.Generator().manual_seed(seed), sizes,
                   ["relu"] * (len(sizes) - 2) + ["softmax"], device="cpu")
    path = tmp_path / "m.json"
    save_model(spec_from_params(p0, ["relu"] * (len(sizes) - 2) + ["softmax"]), path)
    return path


def test_engine_train_then_infer_serves_the_trained_weights(tmp_path):
    path = _model_file(tmp_path, [12, 16, 4])
    data = synthetic_mnist(160, num_classes=4, dim=12, seed=4)
    eng = Engine.up(path, device="cpu")
    before = eng.infer(data.x[:8])
    hist = eng.train(data, TrainConfig(epochs=2, batch_size=32), eval_data=data)
    assert len(hist) == 2 and "eval" in hist[1]
    after = eng.infer(data.x[:8])
    assert not np.array_equal(before, after)
    with torch.no_grad():
        np.testing.assert_array_equal(after, forward(eng._params, torch.from_numpy(data.x[:8])).numpy())
    # The model holds the trained weights in float64, and its export
    # serves the same outputs.
    np.testing.assert_array_equal(eng.model.layers[0].weights,
                                  eng._params[0]["w"].double().numpy())
    assert eng.model.layers[0].weights.dtype == np.float64
    eng.export(tmp_path / "trained.json", metrics=hist[-1]["eval"])
    np.testing.assert_array_equal(Engine.up(tmp_path / "trained.json", device="cpu").infer(
        data.x[:8]), after)
    assert load_model(path).layers[0].weights is not None  # the source file is untouched
    # Resume through the engine: 1 + resume to 3 epochs == 3 straight.
    straight = Engine.up(path, device="cpu")
    straight.train(data, TrainConfig(epochs=3, batch_size=32))
    ck = CheckpointManager(tmp_path / "ck")
    Engine.up(path, device="cpu").train(data, TrainConfig(epochs=1, batch_size=32), checkpoints=ck)
    resumed = Engine.up(path, device="cpu")
    assert len(resumed.train(data, TrainConfig(epochs=3, batch_size=32), checkpoints=ck)) == 2
    for a, b in zip(resumed._params, straight._params):
        np.testing.assert_allclose(a["w"].numpy(), b["w"].numpy(), rtol=1e-6, atol=1e-7)


def test_training_records_epoch_spans_and_metric_families(tmp_path):
    from tpu_dist_nn_torch.obs.registry import REGISTRY, render
    from tpu_dist_nn_torch.obs.trace import TRACER

    steps = REGISTRY.counter("tdn_train_steps_total", labels=("trainer",))
    before = steps.labels(trainer="classifier").value
    TRACER.reset()
    data = synthetic_mnist(96, num_classes=4, dim=12, seed=1)
    eng = Engine.up(_model_file(tmp_path, [12, 8, 4]), device="cpu")
    hist = eng.train(data, TrainConfig(epochs=2, batch_size=32),
                     checkpoints=CheckpointManager(tmp_path / "ck"))
    assert steps.labels(trainer="classifier").value - before == 6
    spans = TRACER.snapshot()
    epochs = [s for s in spans if s.name == "epoch"]
    assert [s.attrs["epoch"] for s in epochs] == [0, 1]
    assert [s.attrs["loss"] for s in epochs] == [h["loss"] for h in hist]
    run = [s for s in spans if s.name == "train.classifier"]
    assert len(run) == 1 and all(s.parent_id == run[0].span_id for s in epochs)
    loss = REGISTRY.gauge("tdn_train_loss", labels=("trainer",))
    assert loss.labels(trainer="classifier").value == hist[-1]["loss"]
    text = render()
    assert 'tdn_checkpoint_saves_total{trainer="classifier"}' in text
    assert "tdn_train_epoch_seconds_bucket" in text


def test_engine_train_requantizes_the_int8_path(tmp_path):
    path = _model_file(tmp_path, [12, 16, 8, 4])
    data = synthetic_mnist(128, num_classes=4, dim=12, seed=5)
    eng = Engine.up(path, device="cpu", quantize="int8")
    stale = eng._q
    eng.train(data, TrainConfig(epochs=2, batch_size=32))
    want = jax_quantize_fcnn([{k: (v.numpy() if torch.is_tensor(v) else v) for k, v in p.items()}
                              for p in eng._params])
    port = quantize_fcnn(eng._params)
    for got, w, p in zip(eng._q, want, port):
        np.testing.assert_array_equal(got["wq"].numpy(), np.asarray(w["wq"]))
        np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(w["scale"]))
        np.testing.assert_array_equal(got["wq_packed"].numpy(), p["wq_packed"].numpy())
    x = torch.from_numpy(data.x[:16])
    served = eng.infer(data.x[:16])
    np.testing.assert_array_equal(served, forward_quantized(port, x).numpy())
    assert not np.array_equal(served, forward_quantized(stale, x).numpy())


def test_engine_train_refusals_match_jax(tmp_path):
    path = _model_file(tmp_path, [12, 8, 4])
    data = synthetic_mnist(64, num_classes=4, dim=12)
    jeng = JaxEngine.up(str(path))
    eng = Engine.up(path, device="cpu")
    for schedule in ("1f1b", "interleaved", "zb", "bogus"):
        with pytest.raises(ValueError) as want:
            jeng.train(data, JaxTrainConfig(epochs=1, batch_size=32), schedule=schedule)
        with pytest.raises(ValueError) as got:
            eng.train(data, TrainConfig(epochs=1, batch_size=32), schedule=schedule)
        assert str(got.value) == str(want.value)
    # A collapsed interleaved request trains with the default schedule.
    veng = Engine.up(path, [1, 1], virtual_stages=2, device="cpu")
    assert len(veng.train(data, TrainConfig(epochs=1, batch_size=32),
                          schedule="interleaved")) == 1
    with pytest.raises(InvalidArgumentError, match="not divisible by virtual_stages=3"):
        Engine.up(path, [1, 1], virtual_stages=3, device="cpu")
    # A conv model trains single-program, "gpipe" only, as in JAX.
    conv = Engine.up(init_conv_mlp(torch.Generator().manual_seed(0), in_shape=(6, 6, 1),
                                   conv_filters=(2,), hidden=(4,), num_classes=3), device="cpu")
    conv_data = synthetic_mnist(32, num_classes=3, dim=36)
    assert len(conv.train(conv_data, TrainConfig(epochs=1, batch_size=16))) == 1
    with pytest.raises(ValueError, match="placed single-program"):
        conv.train(conv_data, TrainConfig(epochs=1, batch_size=16), schedule="1f1b")
    eng.down()
    with pytest.raises(UnavailableError, match="engine is down"):
        eng.train(data, TrainConfig(epochs=1, batch_size=32))
    with pytest.raises(InvalidArgumentError, match="no full batch"):
        Engine.up(path, device="cpu").train(data, TrainConfig(epochs=1, batch_size=65))


def _epoch_lines(caplog):
    """The per-epoch report lines, digits zeroed."""
    return [re.sub(r"\d", "0", r.getMessage()) for r in caplog.records
            if r.getMessage().startswith("epoch ")]


def test_cli_train_on_the_cpu(tmp_path, caplog):
    out, metrics, ck = tmp_path / "m.json", tmp_path / "h.jsonl", tmp_path / "ck"
    args = ["train", "--device", "cpu", "--data", "synthetic", "--num-examples", "400",
            "--layers", "16,8,4", "--batch-size", "32", "--seed", "3", "--epochs", "2"]
    with caplog.at_level(logging.INFO):
        assert port_main(args + ["--out", str(out), "--metrics-out", str(metrics)]) == 0
    got = _epoch_lines(caplog)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert tdn_main(args[:1] + args[3:]) == 0
    assert got == _epoch_lines(caplog) == ["epoch 0: loss 0.0000 (0.00s) eval_acc 0.0000"] * 2
    records = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    assert records[0] == {"run": "begin"} and [r["epoch"] for r in records[1:]] == [0, 1]
    spec = load_model(out)
    assert [layer.weights.shape for layer in spec.layers] == [(16, 8), (8, 4)]
    assert spec.metadata["inference_metrics"] == records[-1]["eval"]
    # --checkpoint-dir: a rerun with more epochs resumes after the last.
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert port_main(args + ["--checkpoint-dir", str(ck), "--async-checkpoints"]) == 0
        assert port_main([*args[:-1], "3", "--checkpoint-dir", str(ck)]) == 0
    assert [ln[:8] for ln in _epoch_lines(caplog)] == ["epoch 0:", "epoch 0:",
                                                                "epoch 0:"]
    assert CheckpointManager(ck).steps() == [1, 2, 3]


def test_cli_train_refusals(tmp_path, capsys):
    base = ["train", "--device", "cpu", "--epochs", "1"]
    assert port_main(base + ["--data", "digits", "--layers", "784,10"]) == 2
    assert "data has 64 features but the model expects 784" in capsys.readouterr().err
    assert port_main(base + ["--checkpoint-dir", str(tmp_path), "--checkpoint-format",
                             "orbax"]) == 2
    assert "orbax is not ported" in capsys.readouterr().err
    assert port_main(base + ["--trace-sample-rate", "2"]) == 2
    assert "--trace-sample-rate" in capsys.readouterr().err
    ex = tmp_path / "e.json"
    save_examples(np.zeros((4, 3)), np.array([0, 1, -1, 0]), ex)
    assert port_main(base + ["--data", f"json:{ex}", "--layers", "3,2"]) == 2
    assert "without labels cannot be trained on" in capsys.readouterr().err
    assert port_main(base + ["--data", "mnist", "--layers", "3,2"]) == 2


def test_cli_train_on_json_and_idx_data(tmp_path, capsys):
    ex = tmp_path / "e.json"
    data = synthetic_mnist(120, num_classes=3, dim=6, seed=2)
    data.to_examples_json(ex)
    assert port_main(["train", "--device", "cpu", "--data", f"json:{ex}", "--layers", "6,3",
                      "--epochs", "1", "--batch-size", "16", "--out",
                      str(tmp_path / "a.json")]) == 0
    assert load_model(tmp_path / "a.json").output_dim == 3
    assert port_main(["train", "--device", "cpu", "--data", f"idx:{tmp_path}",
                      "--epochs", "1"]) == 2
    assert "MNIST IDX files not found" in capsys.readouterr().err


class _Clock:
    """A fake clock for the gate: each Engine.infer advances it by the
    arm's cost (the f32 arm runs with ``_q`` cleared)."""

    def __init__(self, monkeypatch, f32_cost, int8_cost):
        self.t = 0.0
        monkeypatch.setattr(engine_mod, "time", types.SimpleNamespace(monotonic=lambda: self.t))
        infer = Engine.infer

        def timed(eng, x):
            self.t += f32_cost if eng._q is None else int8_cost
            return infer(eng, x)

        monkeypatch.setattr(Engine, "infer", timed)


def _gauge():
    return engine_mod._INT8_RATIO.labels().value


@pytest.mark.parametrize("f32_cost,int8_cost,kept", [(1.0, 2.0, False), (2.0, 1.0, True)],
                         ids=["int8-slower", "int8-faster"])
def test_int8_gate_reroutes_by_its_measurement(tmp_path, monkeypatch, caplog, f32_cost,
                                               int8_cost, kept):
    path = _model_file(tmp_path, [12, 16, 8, 4])
    x = synthetic_mnist(20, num_classes=4, dim=12).x
    f32 = Engine.up(path, device="cpu").infer(x)
    int8 = Engine.up(path, device="cpu", quantize="int8").infer(x)
    assert not np.array_equal(f32, int8)
    monkeypatch.setenv("TDN_INT8_AUTO", "1")
    _Clock(monkeypatch, f32_cost, int8_cost)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="tpu_dist_nn_torch.engine"):
        eng = Engine.up(path, device="cpu", quantize="int8", warm_rows=4)
    assert eng.int8_speedup_ratio == f32_cost / int8_cost == _gauge()
    assert eng.int8_auto_disabled is not kept
    events = [getattr(r, "tdn_event", None) for r in caplog.records]
    assert events.count("int8.speedup") == int(kept)
    assert events.count("int8.slower_than_f32") == events.count("int8.auto_disabled") == int(not kept)
    np.testing.assert_array_equal(eng.infer(x), int8 if kept else f32)
    # The measurement ran once, on the first warm; later warms add buckets only.
    assert eng.warm_buckets(16) == [8, 16] and eng.int8_speedup_ratio == f32_cost / int8_cost


def test_int8_gate_remeasures_the_real_int8_path(tmp_path, monkeypatch):
    path = _model_file(tmp_path, [12, 8, 4])
    monkeypatch.setenv("TDN_INT8_AUTO", "1")
    _Clock(monkeypatch, 1.0, 3.0)
    eng = Engine.up(path, device="cpu", quantize="int8")
    assert eng.int8_auto_disabled
    _Clock(monkeypatch, 3.0, 1.0)
    assert eng.measure_int8_speedup(rows=4) == 3.0
    assert not eng.int8_auto_disabled
    assert Engine.up(path, device="cpu").measure_int8_speedup() is None


def test_int8_gate_environment_switches(tmp_path, monkeypatch):
    path = _model_file(tmp_path, [12, 8, 4])
    x = synthetic_mnist(8, num_classes=4, dim=12).x
    int8 = Engine.up(path, device="cpu", quantize="int8").infer(x)
    # TDN_INT8_AUTO=0: measure and warn, keep serving int8 (and clear a
    # reroute an earlier measurement armed).
    monkeypatch.setenv("TDN_INT8_AUTO", "0")
    _Clock(monkeypatch, 1.0, 2.0)
    eng = Engine.up(path, device="cpu", quantize="int8")
    assert eng.int8_speedup_ratio == 0.5 and not eng.int8_auto_disabled
    np.testing.assert_array_equal(eng.infer(x), int8)
    eng.int8_auto_disabled = True
    eng.measure_int8_speedup()
    assert not eng.int8_auto_disabled
    # TDN_INT8_WARMUP_MEASURE=0: no measurement at warm-up at all.
    monkeypatch.setenv("TDN_INT8_AUTO", "1")
    monkeypatch.setenv("TDN_INT8_WARMUP_MEASURE", "0")
    engine_mod._INT8_RATIO.set(float("nan"))
    eng = Engine.up(path, device="cpu", quantize="int8", warm_rows=8)
    assert eng.int8_speedup_ratio is None and not eng.int8_auto_disabled
    assert np.isnan(_gauge())
    np.testing.assert_array_equal(eng.infer(x), int8)


_BLOCKED_TRAIN = r"""
import importlib.abc, sys
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "tpu_dist_nn"):
        del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpu_dist_nn"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
from tpu_dist_nn_torch.api.engine import Engine
from tpu_dist_nn_torch.checkpoint import AsyncCheckpointManager
from tpu_dist_nn_torch.cli import main
from tpu_dist_nn_torch.core.schema import load_model
from tpu_dist_nn_torch.data.datasets import real_digits
from tpu_dist_nn_torch.train.trainer import TrainConfig
out, ck = sys.argv[1] + "/m.json", sys.argv[1] + "/ck"
assert main(["train", "--device", "cpu", "--data", "digits", "--epochs", "2", "--out", out,
             "--checkpoint-dir", ck, "--async-checkpoints"]) == 0
spec = load_model(out)
eng = Engine.up(spec, device="cpu", quantize="int8", warm_rows=4)
hist = eng.train(real_digits("train"), TrainConfig(epochs=1), eval_data=real_digits("test"))
assert len(hist) == 1 and eng.infer(real_digits("test").x).shape == (359, 10)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpu_dist_nn")]
assert not bad, bad
print("trained without jax")
"""


def test_train_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_TRAIN, str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "trained without jax" in proc.stdout
