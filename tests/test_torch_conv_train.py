"""The port's conv-network training against the JAX package, on the CPU.

Mirrors ``tests/test_conv.py:97-146``: the same seeded model (JAX's
``init_conv_mlp`` weights carried over through the model JSON), data and
shuffling seeds go through the JAX ``train_network`` and the port's.
Tolerances are the JAX package's own hetero-vs-single ones
(``tests/test_hetero_pipeline.py:127-135``): per-epoch losses rtol 1e-4,
weights rtol 5e-4 / atol 5e-6; the engine against the float64 oracle at
rtol 5e-4 / atol 1e-5 (``test_conv.py``). The training forward is held
to JAX's lax forward and its gradients to ``jax.grad`` on edge plans (a
pool after no conv, a strided VALID conv, a dense layer before the
convs, a softmax conv, SAME padding with stride 2).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import tpu_dist_nn.models.network as jax_network
from tpu_dist_nn.core import schema as jax_schema
from tpu_dist_nn.data.datasets import synthetic_mnist as jax_synthetic_mnist
from tpu_dist_nn.train.trainer import TrainConfig as JaxTrainConfig
from tpu_dist_nn.train.trainer import cross_entropy as jax_cross_entropy
from tpu_dist_nn.train.trainer import evaluate_network as jax_evaluate_network
from tpu_dist_nn.train.trainer import train_network as jax_train_network
from tpu_dist_nn_torch.api.engine import Engine
from tpu_dist_nn_torch.checkpoint import CheckpointManager
from tpu_dist_nn_torch.cli import main as port_main
from tpu_dist_nn_torch.core import schema as pt_schema
from tpu_dist_nn_torch.data.datasets import synthetic_mnist
from tpu_dist_nn_torch.models import network
from tpu_dist_nn_torch.testing.oracle import oracle_forward_batch
from tpu_dist_nn_torch.train.trainer import (
    TrainConfig,
    cross_entropy,
    evaluate_network,
    train_network,
)

torch.set_num_threads(1)
LOSS_RTOL = 1e-4
W_TOL = dict(rtol=5e-4, atol=5e-6)


def _port_model(jmodel, tmp_path, name="model.json"):
    """The JAX spec written to the reference JSON and read by the port:
    both packages then hold the same float64 weights."""
    path = tmp_path / name
    jax_schema.save_model(jmodel, path)
    return pt_schema.load_model(path)


def _small(seed=1, **kw):
    kw = {"in_shape": (6, 6, 1), "conv_filters": (4,), "hidden": (16,), "num_classes": 3, **kw}
    return jax_network.init_conv_mlp(jax.random.key(seed), **kw)


def _weights_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), **W_TOL)


CONFIGS = {
    "constant": {},
    "cosine-clip-wd": dict(lr_schedule="cosine", warmup_steps=5, clip_norm=0.5,
                           weight_decay=1e-3),
}


@pytest.mark.parametrize("kw", CONFIGS.values(), ids=CONFIGS.keys())
def test_train_network_matches_jax(tmp_path, kw):
    jmodel = _small()
    data = jax_synthetic_mnist(400, num_classes=3, dim=36, noise=0.25, seed=7)
    train, test = data.split(0.8, seed=1)
    ptrain, ptest = synthetic_mnist(400, num_classes=3, dim=36, noise=0.25, seed=7).split(
        0.8, seed=1)
    jplan, jparams = jax_network.build_network(jmodel)
    jp, jh = jax_train_network(jplan, jparams, train,
                               JaxTrainConfig(epochs=4, batch_size=32, seed=2, **kw),
                               eval_data=test)
    plan, params = network.build_network(_port_model(jmodel, tmp_path), device="cpu")
    p0 = [{k: t.clone() for k, t in p.items()} for p in params]
    pp, ph = train_network(plan, params, ptrain,
                           TrainConfig(epochs=4, batch_size=32, seed=2, **kw), eval_data=ptest)
    np.testing.assert_allclose([h["loss"] for h in ph], [h["loss"] for h in jh],
                               rtol=LOSS_RTOL)
    assert [h["eval"]["accuracy"] for h in ph] == [h["eval"]["accuracy"] for h in jh]
    _weights_close(pp, jp)
    # The caller's params are untouched; the trained ones are detached.
    for a, b in zip(params, p0):
        for k in a:
            assert torch.equal(a[k], b[k])
    assert all(not t.requires_grad for p in pp for t in p.values())
    assert pp[1] == {}  # the pool keeps no params


def _edge_model():
    rng = np.random.default_rng(5)
    return jax_schema.ModelSpec([
        jax_schema.LayerSpec(rng.normal(size=(12, 48)) * 0.3, rng.normal(size=48) * 0.1, "tanh"),
        jax_schema.MaxPool2DSpec(in_shape=(4, 4, 3), window=(2, 2), stride=(1, 1)),
        jax_schema.Conv2DSpec((3, 3, 3), rng.normal(size=(2, 2, 3, 5)) * 0.3,
                              rng.normal(size=5) * 0.1, stride=(1, 1), padding="valid",
                              activation="softmax"),
        jax_schema.Conv2DSpec((2, 2, 5), rng.normal(size=(2, 2, 5, 4)) * 0.3,
                              rng.normal(size=4) * 0.1, stride=(2, 2), padding="same",
                              activation="gelu"),
        jax_schema.LayerSpec(rng.normal(size=(4, 3)) * 0.5, rng.normal(size=3) * 0.1, "softmax"),
    ])


@pytest.mark.parametrize("which", ["conv_mlp", "edges", "strided_valid"])
def test_training_forward_and_its_gradients_match_jax(tmp_path, which):
    if which == "conv_mlp":
        jmodel = jax_network.init_conv_mlp(jax.random.key(0), in_shape=(8, 8, 3),
                                           conv_filters=(4, 8), hidden=(16,), num_classes=4)
    elif which == "edges":
        jmodel = _edge_model()
    else:
        rng = np.random.default_rng(6)
        jmodel = jax_schema.ModelSpec([
            jax_schema.Conv2DSpec((9, 7, 2), rng.normal(size=(3, 3, 2, 3)) * 0.3,
                                  rng.normal(size=3) * 0.1, stride=(2, 2), padding="valid",
                                  activation="relu"),
            jax_schema.MaxPool2DSpec(in_shape=(4, 3, 3), window=(2, 2)),
            jax_schema.LayerSpec(rng.normal(size=(6, 2)) * 0.5, np.zeros(2), "sigmoid"),
        ])
    jplan, jparams = jax_network.build_network(jmodel)
    plan, params = network.build_network(_port_model(jmodel, tmp_path), device="cpu")
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (9, jmodel.input_dim)).astype(np.float32)
    y = rng.integers(0, jmodel.output_dim, 9)
    want = np.asarray(jax_network.network_forward_lax(jplan, jparams, jnp.asarray(x)))
    got = network.network_forward_lax(plan, params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-6)

    def jloss(p):
        return jax_cross_entropy(jax_network.network_logits(jplan, p, jnp.asarray(x)),
                                 jnp.asarray(y))

    jl, jg = jax.value_and_grad(jloss)(jparams)
    leaves = [t.requires_grad_(True) for p in params for t in p.values()]
    loss = cross_entropy(network.network_logits(plan, params, torch.from_numpy(x)),
                         torch.from_numpy(y))
    grads = iter(torch.autograd.grad(loss, leaves))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    for jp in jg:
        for k in ("w", "b") if jp else ():
            np.testing.assert_allclose(next(grads).numpy(), np.asarray(jp[k]),
                                       rtol=1e-4, atol=1e-6)


def test_conv_training_learns():
    # tests/test_conv.py::test_conv_training_learns, on the port.
    model = network.init_conv_mlp(torch.Generator().manual_seed(1), in_shape=(6, 6, 1),
                                  conv_filters=(4,), hidden=(16,), num_classes=3)
    data = synthetic_mnist(400, num_classes=3, dim=36, noise=0.25, seed=7)
    train, test = data.split(0.8, seed=1)
    plan, params = network.build_network(model, device="cpu")
    params, history = train_network(plan, params, train, TrainConfig(epochs=25, batch_size=32),
                                    eval_data=test)
    assert history[-1]["loss"] < history[0]["loss"] * 0.7
    assert history[-1]["eval"]["accuracy"] > 0.8
    trained = network.network_model_from_params(model, params)
    assert trained.layers[1].kind == "maxpool2d"
    assert not np.allclose(trained.layers[0].weights, model.layers[0].weights)


def test_evaluate_network_matches_jax(tmp_path):
    jmodel = _small(seed=3)
    data = jax_synthetic_mnist(300, num_classes=3, dim=36, noise=0.4, seed=9)
    jplan, jparams = jax_network.build_network(jmodel)
    plan, params = network.build_network(_port_model(jmodel, tmp_path), device="cpu")
    assert (evaluate_network(plan, params, synthetic_mnist(300, num_classes=3, dim=36,
                                                           noise=0.4, seed=9), batch_size=64)
            == jax_evaluate_network(jplan, jparams, data, batch_size=64))


def test_engine_trains_conv_model_and_exports(tmp_path):
    # tests/test_conv.py::test_engine_trains_conv_model, on the port.
    model = network.init_conv_mlp(torch.Generator().manual_seed(2), in_shape=(6, 6, 1),
                                  conv_filters=(4,), hidden=(8,), num_classes=3)
    data = synthetic_mnist(200, num_classes=3, dim=36, noise=0.3, seed=8)
    engine = Engine.up(model, device="cpu")
    history = engine.train(data, TrainConfig(epochs=3, batch_size=32))
    assert history[-1]["loss"] < history[0]["loss"]
    out = tmp_path / "conv_trained.json"
    engine.export(out)
    reloaded = pt_schema.load_model(out)
    x = np.random.default_rng(6).uniform(size=(3, 36))
    np.testing.assert_allclose(engine.infer(x), oracle_forward_batch(reloaded, x),
                               rtol=5e-4, atol=1e-5)
    assert not np.allclose(reloaded.layers[0].weights, model.layers[0].weights)
    with pytest.raises(ValueError, match="dense pipelined placement only"):
        engine.train(data, TrainConfig(epochs=1, batch_size=32), schedule="1f1b")


def test_train_network_resumes_from_a_checkpoint(tmp_path):
    model = network.init_conv_mlp(torch.Generator().manual_seed(4), in_shape=(6, 6, 1),
                                  conv_filters=(4,), hidden=(8,), num_classes=3)
    data = synthetic_mnist(96, num_classes=3, dim=36, seed=2)
    plan, params = network.build_network(model, device="cpu")
    full, _ = train_network(plan, params, data, TrainConfig(epochs=2, batch_size=24, seed=3))
    d = tmp_path / "ck"
    train_network(plan, params, data, TrainConfig(epochs=1, batch_size=24, seed=3),
                  checkpoints=CheckpointManager(d))
    resumed, hist = train_network(plan, params, data, TrainConfig(epochs=2, batch_size=24, seed=3),
                                  checkpoints=CheckpointManager(d))
    assert [h["epoch"] for h in hist] == [1]
    for g, w in zip(resumed, full):
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), w[k].numpy(), rtol=1e-5, atol=1e-7)


def test_cli_trains_a_conv_config(tmp_path, capsys):
    model = network.init_conv_mlp(torch.Generator().manual_seed(5), in_shape=(6, 6, 1),
                                  conv_filters=(4,), hidden=(8,), num_classes=3)
    cfg = tmp_path / "conv.json"
    pt_schema.save_model(model, cfg)
    out = tmp_path / "trained.json"
    n = len(model.layers)
    for dist in ([], ["--distribution", f"2,{n - 2}"]):
        assert port_main(["train", "--device", "cpu", "--config", str(cfg), "--num-examples",
                          "240", "--epochs", "2", "--batch-size", "24", "--out", str(out),
                          *dist]) == 0
        trained = pt_schema.load_model(out)
        assert trained.layers[1].kind == "maxpool2d"
        assert trained.metadata["inference_metrics"]["accuracy"] >= 0.0
