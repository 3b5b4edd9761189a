"""The data-sharded single program (the Engine's data-parallel placement
and ``train_fcnn(mesh=)``) against the JAX package's, on the CPU.

The JAX Engine and trainer run over ``data`` axes of conftest's 8
virtual host devices; the port over ``devices=["cpu"] * N`` data slots
(each slot runs its rows through the kernels' plain versions here).
Tolerances: f32 serving the float64 oracle's 1e-5 and the JAX engine's
test_torch_engine limits; int8 bit for bit against the port's own single
program (the chain's contract) and at test_torch_kernels' int8 limits
against the JAX data-sharded engine, whose jitted jnp chain contracts
the rescale differently by a few 1e-8; conv at test_torch_conv's engine
limits; training losses rtol 1e-5 in the first epoch and 1e-4 after
(test_torch_train's). Every served batch leaves a pad tail.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from tpu_dist_nn.api.engine import Engine as JaxEngine
from tpu_dist_nn.data.datasets import synthetic_mnist as jax_synthetic_mnist
from tpu_dist_nn.models import network as jax_network
from tpu_dist_nn.models.fcnn import init_fcnn as jax_init_fcnn
from tpu_dist_nn.parallel.mesh import MeshSpec as JaxMeshSpec
from tpu_dist_nn.parallel.mesh import build_mesh as jax_build_mesh
from tpu_dist_nn.core.schema import save_model as jax_save_model
from tpu_dist_nn.testing.factories import random_inputs, random_model
from tpu_dist_nn.train.trainer import TrainConfig as JaxTrainConfig
from tpu_dist_nn.train.trainer import train_fcnn as jax_train_fcnn
from tpu_dist_nn_torch.api.engine import Engine
from tpu_dist_nn_torch.core.schema import load_model
from tpu_dist_nn_torch.data.datasets import synthetic_mnist
from tpu_dist_nn_torch.models.fcnn import params_from_jax
from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
from tpu_dist_nn_torch.testing.oracle import oracle_forward_batch
from tpu_dist_nn_torch.train.trainer import TrainConfig, train_fcnn

torch.set_num_threads(1)
PLACEMENT_KEYS = ("devices", "distribution", "data_parallel", "pipelined", "num_stages",
                  "input_dim", "output_dim")


@pytest.fixture(autouse=True)
def _pin_int8_serving(monkeypatch):
    monkeypatch.setenv("TDN_INT8_AUTO", "0")


@pytest.fixture
def dense_file(tmp_path):
    path = tmp_path / "model.json"
    jax_save_model(random_model([24, 32, 16, 4], seed=0), path)
    return path


@pytest.fixture
def conv_file(tmp_path):
    model = jax_network.init_conv_mlp(jax.random.key(0), in_shape=(8, 8, 3),
                                      conv_filters=(4, 8), hidden=(16,), num_classes=4)
    rng = np.random.default_rng(9)
    for layer in model.layers:
        if layer.kind != "maxpool2d":
            layer.biases = rng.normal(0.0, 0.05, layer.biases.shape)
    path = tmp_path / "conv.json"
    jax_save_model(model, path)
    return path


def _engines(path, n, quantize=None):
    jeng = JaxEngine.up(str(path), data_parallel=n, quantize=quantize)
    eng = Engine.up(path, data_parallel=n, devices=["cpu"] * n, quantize=quantize)
    return jeng, eng


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["f32", "int8"])
def test_dense_engine_serves_over_data_slots_as_jax_does(dense_file, quantize):
    """4 data slots, 101 rows (a pad tail of 3) and 32-row chunks (a
    last chunk of 5 over 4 slots): the placement JAX reports, the JAX
    engine's outputs, the oracle's (f32) and the single program's bits."""
    jeng, eng = _engines(dense_file, 4, quantize)
    place = eng.placement()
    assert {k: place[k] for k in PLACEMENT_KEYS} == {
        k: jeng.placement()[k] for k in PLACEMENT_KEYS}
    assert place["data_parallel"] == 4 and place["slots"] == [["cpu"] * 4]
    assert eng.data_sharded and jeng.data_sharded
    x = random_inputs(101, 24, seed=3)
    labels = np.random.default_rng(4).integers(0, 4, 101)
    got = eng.run_inference(x, labels, batch_size=32)
    want = jeng.run_inference(x, labels, batch_size=32)
    assert got.outputs.shape == (101, 4) and len(got.batch_seconds) == 4
    if quantize is None:
        np.testing.assert_allclose(got.outputs, oracle_forward_batch(load_model(dense_file), x),
                                   atol=1e-5)
        np.testing.assert_allclose(got.outputs, want.outputs, atol=1e-6, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.outputs, want.outputs, atol=1e-7, rtol=1e-6)
    assert got.metrics == want.metrics
    single = Engine.up(dense_file, device="cpu", quantize=quantize)
    np.testing.assert_array_equal(eng.infer(x), single.infer(x))
    np.testing.assert_array_equal(eng.infer(x[:3]), single.infer(x[:3]))  # 1 row of pad


def test_conv_engine_serves_over_data_slots_and_trains_one_program(conv_file):
    """A conv model on 4 data slots: JAX's placement and outputs (its
    conv engine limits), the single program's bits; training runs the
    one-program network trainer, as the JAX Engine's does, and the slots
    serve the trained weights."""
    jeng, eng = _engines(conv_file, 4)
    assert {k: eng.placement()[k] for k in PLACEMENT_KEYS} == {
        k: jeng.placement()[k] for k in PLACEMENT_KEYS}
    x = np.random.default_rng(1).normal(size=(10, 192)).astype(np.float32)
    got = eng.infer(x)
    np.testing.assert_allclose(got, jeng.infer(x), rtol=5e-4, atol=1e-5)
    single = Engine.up(conv_file, device="cpu")
    np.testing.assert_array_equal(got, single.infer(x))
    data = synthetic_mnist(32, num_classes=4, dim=192)
    hist = eng.train(data, TrainConfig(epochs=1, batch_size=16))
    single.train(data, TrainConfig(epochs=1, batch_size=16))
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    np.testing.assert_array_equal(eng.infer(x), single.infer(x))


def test_engine_train_over_data_slots_follows_jax(dense_file):
    """``Engine.train`` on a data-sharded dense engine trains with the
    rows over the slots (JAX passes its mesh to ``train_fcnn``); the
    history and the served weights follow the JAX engine's, and int8
    re-quantizes."""
    jeng, eng = _engines(dense_file, 4, "int8")
    jdata = jax_synthetic_mnist(128, num_classes=4, dim=24, seed=3)
    data = synthetic_mnist(128, num_classes=4, dim=24, seed=3)
    jh = jeng.train(jdata, JaxTrainConfig(epochs=3, batch_size=32, seed=7), eval_data=jdata)
    ph = eng.train(data, TrainConfig(epochs=3, batch_size=32, seed=7), eval_data=data)
    for i, (g, w) in enumerate(zip(ph, jh)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5 if i == 0 else 1e-4)
    assert [h["eval"] for h in ph] == [h["eval"] for h in jh]
    x = random_inputs(37, 24, seed=8)
    np.testing.assert_allclose(eng.infer(x), jeng.infer(x), atol=1e-5)


@pytest.mark.parametrize("n", [4, 3], ids=["divides", "does-not-divide"])
def test_train_fcnn_mesh_follows_jax_history(n, caplog):
    """``train_fcnn(mesh=)``: JAX's history over a data axis of ``n``;
    a batch of 32 that ``n`` does not divide trains on one device, with
    JAX's warning."""
    jdata = jax_synthetic_mnist(256, num_classes=4, dim=12, seed=3)
    data = synthetic_mnist(256, num_classes=4, dim=12, seed=3)
    j0 = jax_init_fcnn(jax.random.key(0), [12, 16, 8, 4])
    kw = dict(epochs=3, batch_size=32, seed=7, clip_norm=0.5)
    with caplog.at_level(logging.WARNING):
        _, jh = jax_train_fcnn(j0, jdata, JaxTrainConfig(**kw),
                               mesh=jax_build_mesh(JaxMeshSpec(data=n)))
        jax_warned = [r.getMessage() for r in caplog.records if "not divisible" in r.getMessage()]
        caplog.clear()
        pp, ph = train_fcnn(params_from_jax(j0, device="cpu"), data, TrainConfig(**kw),
                            mesh=build_mesh(MeshSpec(data=n), ["cpu"] * n))
        warned = [r.getMessage() for r in caplog.records if "not divisible" in r.getMessage()]
    assert warned == jax_warned and bool(warned) == (n == 3)
    for i, (g, w) in enumerate(zip(ph, jh)):
        assert g["epoch"] == w["epoch"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5 if i == 0 else 1e-4)
    assert all(p["w"].is_contiguous() and not p["w"].requires_grad for p in pp)


def test_data_slots_train_the_single_programs_steps():
    """The mesh step's losses and weights against the port's own one-
    program step (the same batches): the mean over rows is partition
    invariant; the gradients summed in slot order differ by rounding."""
    data = synthetic_mnist(128, num_classes=4, dim=12, seed=5)
    p0 = params_from_jax(jax_init_fcnn(jax.random.key(1), [12, 16, 8, 4]), device="cpu")
    cfg = TrainConfig(epochs=2, batch_size=32, seed=2, weight_decay=1e-2, grad_accum=2)
    one, h1 = train_fcnn(p0, data, cfg)
    four, h4 = train_fcnn(p0, data, cfg, mesh=build_mesh(MeshSpec(data=4), ["cpu"] * 4))
    np.testing.assert_allclose([h["loss"] for h in h4], [h["loss"] for h in h1], rtol=1e-5)
    for a, b in zip(one, four):
        np.testing.assert_allclose(a["w"].numpy(), b["w"].numpy(), atol=1e-5)
    again, h4b = train_fcnn(p0, data, cfg, mesh=build_mesh(MeshSpec(data=4), ["cpu"] * 4))
    assert [h["loss"] for h in h4b] == [h["loss"] for h in h4]
    assert all(torch.equal(a["w"], b["w"]) for a, b in zip(four, again))


def test_engine_collapses_only_without_enough_slots(dense_file, caplog):
    """With fewer slots than data replicas the placement collapses to one
    program (logged), as the JAX Engine's does; enough slots place it."""
    with caplog.at_level(logging.INFO):
        eng = Engine.up(dense_file, data_parallel=4, device="cpu")
    assert "collapsing to the single-program executor" in caplog.text
    assert not eng.data_sharded and eng.placement()["data_parallel"] == 1
    assert Engine.up(dense_file, data_parallel=2, devices=["cpu"] * 3).data_sharded
