"""The port's heterogeneous (conv / pool / dense) pipeline against the JAX
package's, on the CPU.

Mirrors the eight tests of ``tests/test_hetero_pipeline.py`` on CPU
stage slots (``devices=["cpu"] * S``: one slot a stage; the JAX tests
place stages on eight virtual host devices), with their tolerances:
the forward within rtol 2e-5 / atol 1e-6 of the single program, the
trained losses within rtol 1e-4 and weights within rtol 5e-4 / atol 5e-6
of the single-program trainer, a resume within rtol 1e-5 / atol 1e-7 of
the straight run. Then the port's ``train_hetero`` against JAX's on the
same model, data, split and seeds, with and without ``clip_norm``.
"""

import numpy as np
import pytest
import torch

import jax
import tpu_dist_nn.models.network as jax_network
from tpu_dist_nn.core import schema as jax_schema
from tpu_dist_nn.data.datasets import synthetic_mnist as jax_synthetic_mnist
from tpu_dist_nn.parallel.hetero_pipeline import HeteroPipeline as JaxHeteroPipeline
from tpu_dist_nn.parallel.hetero_pipeline import train_hetero as jax_train_hetero
from tpu_dist_nn.train.trainer import TrainConfig as JaxTrainConfig
from tpu_dist_nn_torch.api.engine import Engine
from tpu_dist_nn_torch.checkpoint import CheckpointManager
from tpu_dist_nn_torch.core import schema as pt_schema
from tpu_dist_nn_torch.data.datasets import synthetic_mnist
from tpu_dist_nn_torch.models.network import build_network, network_forward
from tpu_dist_nn_torch.parallel.hetero_pipeline import (
    HeteroPipeline,
    measure_dispatch_overlap,
    stage_params_from_jax,
)
from tpu_dist_nn_torch.testing.oracle import oracle_forward_batch
from tpu_dist_nn_torch.train.hetero_trainer import train_hetero
from tpu_dist_nn_torch.train.trainer import TrainConfig, train_network
from tpu_dist_nn_torch.utils.errors import UnavailableError

torch.set_num_threads(1)
W_TOL = dict(rtol=5e-4, atol=5e-6)


@pytest.fixture(scope="module")
def jax_conv_model():
    return jax_network.init_conv_mlp(jax.random.key(0), in_shape=(8, 8, 3),
                                     conv_filters=(4, 8), hidden=(16,), num_classes=4)


@pytest.fixture(scope="module")
def conv_model(jax_conv_model, tmp_path_factory):
    path = tmp_path_factory.mktemp("hetero") / "conv.json"
    jax_schema.save_model(jax_conv_model, path)
    return pt_schema.load_model(path)


def _x(model, n=12, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (n, model.input_dim)).astype(np.float32)


def _cpu(n):
    return ["cpu"] * n


def _flat(params_list):
    return [p for stage in params_list for p in stage]


def _close(got, want, **tol):
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]), **tol)


def test_forward_matches_single_program(conv_model, jax_conv_model):
    x = _x(conv_model)
    jplan, jparams = jax_network.build_network(jax_conv_model)
    want = np.asarray(jax_network.network_forward(jplan, jparams, x))
    n_layers = len(conv_model.layers)
    hp = HeteroPipeline(conv_model, [2, 2, n_layers - 4], devices=_cpu(3))
    np.testing.assert_allclose(hp.forward(x), want, rtol=2e-5, atol=1e-6)
    # Microbatched, with a ragged tail.
    np.testing.assert_allclose(hp.forward(x, microbatch_size=5), want, rtol=2e-5, atol=1e-6)
    plan, params = build_network(conv_model, device="cpu")
    np.testing.assert_array_equal(hp.forward(x, microbatch_size=5),
                                  network_forward(plan, params, torch.from_numpy(x)).numpy())


def test_stage_devices_are_distinct(conv_model):
    # Each stage has its own slot; on a card each slot has its own
    # stream (the JAX test's distinct devices); on the CPU they share it.
    hp = HeteroPipeline(conv_model, [2, len(conv_model.layers) - 2], devices=_cpu(2))
    summary = hp.placement_summary()
    assert summary["num_stages"] == 2
    assert summary["stage_devices"] == ["cpu", "cpu"]
    assert hp.stages[0].slot is not hp.stages[1].slot
    assert summary["stage_kinds"][0][0] == "conv2d"
    assert summary["stage_layers"] == [2, len(conv_model.layers) - 2]


def test_rejects_more_stages_than_devices(conv_model):
    with pytest.raises(ValueError, match="devices"):
        HeteroPipeline(conv_model, [1] * len(conv_model.layers), devices=_cpu(2))
    with pytest.raises(ValueError, match="layer_distribution"):
        HeteroPipeline(conv_model, [1, 1], devices=_cpu(2))


def test_engine_places_conv_pipeline(conv_model):
    n_layers = len(conv_model.layers)
    engine = Engine.up(conv_model, [2, n_layers - 2], devices=_cpu(2))
    place = engine.placement()
    assert place["pipelined"] and place["num_stages"] == 2
    assert "stage_devices" in place
    x = _x(conv_model)
    plan, params = build_network(conv_model, device="cpu")
    want = network_forward(plan, params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(engine.infer(x), want, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(engine.infer(x), oracle_forward_batch(conv_model, x),
                               rtol=5e-4, atol=1e-5)
    # Empty batch: (0, out_dim), as every other executor.
    assert engine.infer(np.zeros((0, conv_model.input_dim))).shape == (0, 4)
    engine.down()
    with pytest.raises(UnavailableError):
        engine.infer(x)
    # Too few slots: the single program, as the dense pipeline collapses.
    one = Engine.up(conv_model, [2, n_layers - 2], device="cpu")
    assert not one.placement()["pipelined"]
    np.testing.assert_allclose(one.infer(x), want, rtol=2e-5, atol=1e-6)


def test_engine_trains_hetero_placed_conv_model(conv_model):
    data = synthetic_mnist(200, num_classes=4, dim=conv_model.input_dim, noise=0.3, seed=3)
    engine = Engine.up(conv_model, [2, len(conv_model.layers) - 2], devices=_cpu(2))
    history = engine.train(data, TrainConfig(epochs=2, batch_size=32))
    assert history[-1]["loss"] < history[0]["loss"]
    # Still hetero-placed and serving the trained weights.
    assert "stage_devices" in engine.placement()
    got = engine._hp.stages[0].params[0]["w"].numpy()
    np.testing.assert_allclose(got, np.asarray(engine.model.layers[0].weights, np.float32),
                               rtol=1e-6)
    # The JAX Engine's refusals.
    with pytest.raises(ValueError, match="placed heterogeneous"):
        engine.train(data, TrainConfig(epochs=1, batch_size=32), schedule="1f1b")
    with pytest.raises(ValueError, match="needs an interleaved placement"):
        engine.train(data, TrainConfig(epochs=1, batch_size=32), schedule="interleaved")


def test_hetero_pipeline_training_matches_single_program(conv_model):
    data = synthetic_mnist(192, num_classes=4, dim=conv_model.input_dim, noise=0.3, seed=5)
    cfg = TrainConfig(epochs=2, batch_size=24, seed=7)
    plan, params = build_network(conv_model, device="cpu")
    ref_params, ref_hist = train_network(plan, params, data, cfg)
    hp = HeteroPipeline(conv_model, [2, 2, len(conv_model.layers) - 4], devices=_cpu(3))
    params_list, hist = train_hetero(hp, data, cfg, num_microbatches=3)
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in ref_hist],
                               rtol=1e-4)
    _close(_flat(params_list), ref_params, **W_TOL)
    # The trained weights are installed back into the serving placement.
    x = _x(conv_model)
    np.testing.assert_allclose(
        hp.forward(x), network_forward(plan, ref_params, torch.from_numpy(x)).numpy(), **W_TOL)


def test_hetero_training_global_norm_clipping_matches_single_program(conv_model):
    data = synthetic_mnist(96, num_classes=4, dim=conv_model.input_dim, seed=1)
    cfg = TrainConfig(epochs=2, batch_size=24, seed=4, clip_norm=0.05)
    plan, params = build_network(conv_model, device="cpu")
    ref_params, ref_hist = train_network(plan, params, data, cfg)
    hp = HeteroPipeline(conv_model, [2, len(conv_model.layers) - 2], devices=_cpu(2))
    params_list, hist = train_hetero(hp, data, cfg, num_microbatches=2)
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in ref_hist],
                               rtol=1e-4)
    _close(_flat(params_list), ref_params, **W_TOL)


def test_hetero_training_checkpoint_resume(conv_model, tmp_path):
    data = synthetic_mnist(96, num_classes=4, dim=conv_model.input_dim, seed=2)
    cfg = TrainConfig(epochs=2, batch_size=24, seed=3)
    dist = [2, len(conv_model.layers) - 2]
    full, _ = train_hetero(HeteroPipeline(conv_model, dist, devices=_cpu(2)), data, cfg,
                           num_microbatches=2)
    d = tmp_path / "ck"
    train_hetero(HeteroPipeline(conv_model, dist, devices=_cpu(2)), data,
                 TrainConfig(epochs=1, batch_size=24, seed=3),
                 checkpoints=CheckpointManager(d), num_microbatches=2)
    resumed, hist = train_hetero(HeteroPipeline(conv_model, dist, devices=_cpu(2)), data, cfg,
                                 checkpoints=CheckpointManager(d), num_microbatches=2)
    assert [h["epoch"] for h in hist] == [1]
    for got_sp, want_sp in zip(resumed, full):
        _close(got_sp, want_sp, rtol=1e-5, atol=1e-7)


def test_microbatched_forward_dispatch_overlaps_stages():
    # The JAX test's measurement, on CPU slots: the keys and counts. The
    # CPU runs each call as it is issued, so no overlap can show here;
    # chip_smoke.py and tests/test_torch_cuda.py read the ratio on a card.
    rng = np.random.default_rng(0)
    layers = [pt_schema.LayerSpec(rng.normal(size=(a, b)) * 0.05, np.zeros(b), act)
              for a, b, act in ((256, 256, "relu"), (256, 256, "relu"), (256, 10, "softmax"))]
    hp = HeteroPipeline(pt_schema.ModelSpec(layers), [1, 1, 1], devices=_cpu(3))
    x = rng.uniform(0, 1, (1024, 256)).astype(np.float32)
    m = measure_dispatch_overlap(hp, x, microbatch_size=128)
    assert m["num_chunks"] == 8 and m["num_stages"] == 3
    assert m["blocked_s"] > 0 and m["dispatch_ratio"] == m["dispatch_s"] / m["blocked_s"]
    assert 0 < m["dispatch_s"] <= m["total_s"] and m["fetch_rtt_s"] >= 0
    with pytest.raises(ValueError, match="devices"):
        HeteroPipeline(pt_schema.ModelSpec(layers), [1, 1, 1], devices=_cpu(2))


@pytest.mark.parametrize("hetero", [False, True], ids=["single", "hetero"])
def test_steps_run_every_conv_under_conv_flags(conv_model, hetero, monkeypatch):
    # Every conv a training step runs (the hetero forward wave, its
    # recomputing backward, the single program) sees cuDNN's TF32 off,
    # deterministic algorithms and no autotuning, set by the step itself:
    # the process here keeps PyTorch's defaults (TF32 on).
    import torch.nn.functional as F

    from tpu_dist_nn_torch.train.hetero_trainer import make_hetero_train_step
    from tpu_dist_nn_torch.train.optimizers import build_optimizer
    from tpu_dist_nn_torch.train.trainer import _leaves, _trainable, make_network_train_step

    seen = []
    conv2d = F.conv2d

    def spy(*args, **kwargs):
        cudnn = torch.backends.cudnn
        seen.append((cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(F, "conv2d", spy)
    opt = build_optimizer(1e-3)
    if not hetero:
        plan, params = build_network(conv_model, device="cpu")
        p, step = _trainable(params), make_network_train_step(plan, opt)
    else:
        hp = HeteroPipeline(conv_model, [2, 2, len(conv_model.layers) - 4], devices=_cpu(3))
        p, step = _trainable(hp.stage_params()), make_hetero_train_step(hp, opt, 2)
    x = torch.from_numpy(_x(conv_model))
    y = torch.arange(len(x)) % conv_model.output_dim
    with torch.backends.cudnn.flags(enabled=True, benchmark=True, deterministic=False,
                                    allow_tf32=True):
        step(p, opt.init(_leaves(p)), x, y)
        assert torch.backends.cudnn.allow_tf32  # restored after the step
    n_convs = sum(layer.kind == "conv2d" for layer in conv_model.layers)
    # forward, then the backward's recompute (hetero: per microbatch)
    assert len(seen) >= n_convs * (2 if hetero else 1)
    assert set(seen) == {(False, True, False)}


# ---------------------------------------------- the port against the JAX package


@pytest.mark.parametrize("clip_norm,dist,microbatches", [(None, "2,2,rest", 3),
                                                         (0.05, "2,rest", 2)],
                         ids=["plain", "clip_norm"])
def test_train_hetero_matches_jax(conv_model, jax_conv_model, clip_norm, dist, microbatches):
    n = len(conv_model.layers)
    dist = [int(d) if d != "rest" else 0 for d in dist.split(",")]
    dist[-1] = n - sum(dist)
    data = jax_synthetic_mnist(240, num_classes=4, dim=conv_model.input_dim, noise=0.3, seed=5)
    train, test = data.split(0.8, seed=1)
    ptrain, ptest = synthetic_mnist(240, num_classes=4, dim=conv_model.input_dim, noise=0.3,
                                    seed=5).split(0.8, seed=1)
    jhp = JaxHeteroPipeline(jax_conv_model, dist)
    jparams, jhist = jax_train_hetero(
        jhp, train, JaxTrainConfig(epochs=2, batch_size=24, seed=7, clip_norm=clip_norm),
        eval_data=test, num_microbatches=microbatches)
    hp = HeteroPipeline(conv_model, dist, devices=_cpu(len(dist)))
    # Start from JAX's initial weights in their per-stage form.
    hp.set_stage_params(stage_params_from_jax([s["params"] for s in
                                               JaxHeteroPipeline(jax_conv_model, dist).stages],
                                              hp))
    params_list, hist = train_hetero(
        hp, ptrain, TrainConfig(epochs=2, batch_size=24, seed=7, clip_norm=clip_norm),
        eval_data=ptest, num_microbatches=microbatches)
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist],
                               rtol=1e-4)
    assert [h["eval"]["accuracy"] for h in hist] == [h["eval"]["accuracy"] for h in jhist]
    assert [len(s) for s in params_list] == [len(s) for s in jparams] == dist
    _close(_flat(params_list), _flat(jparams), **W_TOL)
    x = _x(conv_model)
    np.testing.assert_allclose(hp.forward(x), np.asarray(jhp.forward(x)), **W_TOL)
