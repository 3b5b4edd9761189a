"""Training through the port's pipeline against the JAX package's, on the CPU.

The same padded batches (``prepare_pipeline_batch``, numpy-seeded) go
through the JAX loss-and-grad executors on conftest's 8 virtual host
devices and through the port's schedules on ``devices=["cpu"] * n``,
from the same padded params. Tolerances are ``tests/test_pipeline_1f1b.py``'s
and ``tests/test_interleaved.py``'s: first-step loss within rtol 1e-5,
gradients (inside the real blocks; the port's are zero outside them)
within rtol 1e-4, atol 1e-6; ``train_pipelined`` losses within rtol 1e-4
over a few epochs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_dist_nn.api.engine import Engine as JaxEngine
from tpu_dist_nn.core.schema import partition_model as jax_partition
from tpu_dist_nn.core.schema import save_model
from tpu_dist_nn.data.datasets import real_digits as jax_real_digits
from tpu_dist_nn.parallel import pipeline as jp
from tpu_dist_nn.parallel.mesh import MeshSpec as JaxMeshSpec
from tpu_dist_nn.parallel.mesh import build_mesh as jax_build_mesh
from tpu_dist_nn.parallel.one_f_one_b import (
    compiled_1f1b_grad,
    compiled_interleaved_dense_grad,
)
from tpu_dist_nn.testing.factories import random_model
from tpu_dist_nn.train import pipeline_trainer as jpt
from tpu_dist_nn.train.trainer import TrainConfig as JaxTrainConfig
from tpu_dist_nn_torch.api.engine import Engine
from tpu_dist_nn_torch.checkpoint import CheckpointManager
from tpu_dist_nn_torch.checkpoint.store import restore_pytree
from tpu_dist_nn_torch.core.schema import load_model
from tpu_dist_nn_torch.data.datasets import Dataset, real_digits
from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
from tpu_dist_nn_torch.parallel.pipeline import (
    PipelineParams,
    PipelineWeights,
    extract_model,
    pipeline_params_from_jax,
)
from tpu_dist_nn_torch.train.optimizers import build_optimizer
from tpu_dist_nn_torch.train.pipeline_trainer import (
    _leaves,
    make_pipeline_train_step,
    pipeline_loss_and_grad,
    place_leaves,
    evaluate_pipelined,
    prepare_pipeline_batch,
    train_pipelined,
)
from tpu_dist_nn_torch.train.trainer import TrainConfig

torch.set_num_threads(1)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _pin_int8_serving(monkeypatch):
    monkeypatch.setenv("TDN_INT8_AUTO", "0")


def _cpu_mesh(stage, data=1):
    return build_mesh(MeshSpec(stage=stage, data=data), ["cpu"] * (stage * data))


def _batch(dims, rows, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, dims[0])).astype(np.float32),
            rng.integers(0, dims[-1], size=rows))


def _gpipe_value_and_grad(mesh, jparams, micro, xs, labels, mask):
    """tests/test_pipeline_1f1b.py's GPipe reference (AD through the schedule)."""
    weights, meta = jparams
    apply = jp.compiled_pipeline(mesh, meta, micro, True, weights.w.dtype)

    def loss_fn(w):
        logp = jax.nn.log_softmax(apply(w, xs), axis=-1)
        ll = jnp.take_along_axis(logp, labels.reshape(-1)[:, None], axis=-1)[:, 0]
        return -(ll * mask.reshape(-1)).sum() / mask.sum()

    return jax.jit(jax.value_and_grad(loss_fn))(weights)


# (dims, distribution, stage, data, microbatches, rows, virtual):
# tests/test_pipeline_1f1b.py's dense cases and test_interleaved.py's.
GRAD_CASES = {
    "canonical": ([12, 10, 8, 6], [1, 1, 1], 3, 2, 4, 24, 1),
    "single-stage": ([9, 7, 5], [2], 1, 4, 2, 16, 1),
    "multi-layer": ([12, 10, 8, 6, 4], [2, 2], 2, 4, 6, 48, 1),
    "short": ([12, 10, 8, 6], [1, 1, 1], 3, 2, 2, 12, 1),
    "one-microbatch": ([12, 10, 8, 6], [1, 1, 1], 3, 1, 1, 3, 1),
    "empty-stage": ([12, 10, 8, 6], [2, 0, 1], 3, 1, 3, 9, 1),
    "interleaved": ([12, 10, 8, 6, 4], [1, 1, 1, 1], 2, 2, 4, 32, 2),
}


@pytest.fixture(scope="module")
def jax_first_steps():
    """Each case's JAX (loss, grads, params, batch), built once."""
    cache = {}

    def get(case, schedule):
        if (case, schedule) not in cache:
            dims, dist, stage, data, micro, rows, v = GRAD_CASES[case]
            jparams = jp.build_pipeline_params(jax_partition(random_model(dims, seed=0), dist))
            x, y = _batch(dims, rows)
            xs, labels, mask = jpt.prepare_pipeline_batch(jparams.meta, x, y, micro, data)
            args = (jnp.asarray(xs), jnp.asarray(labels), jnp.asarray(mask))
            if schedule == "interleaved":
                mesh = jax_build_mesh(JaxMeshSpec(stage=stage, data=data))
                loss, grads = compiled_interleaved_dense_grad(
                    mesh, jparams.meta, v, micro, jnp.float32)(jparams.weights, *args)
            elif schedule == "1f1b":
                mesh = jax_build_mesh(JaxMeshSpec(stage=stage, data=data))
                loss, grads = compiled_1f1b_grad(mesh, jparams.meta, micro, jnp.float32)(
                    jparams.weights, *args)
            else:
                mesh = jax_build_mesh(JaxMeshSpec(stage=len(dist), data=data))
                loss, grads = _gpipe_value_and_grad(mesh, jparams, micro, *args)
            cache[(case, schedule)] = (float(loss), grads, jparams, (xs, labels, mask))
        return cache[(case, schedule)]

    return get


FIRST_STEP = [(case, schedule) for case in GRAD_CASES
              for schedule in (("interleaved",) if GRAD_CASES[case][6] > 1
                               else ("gpipe", "1f1b"))]


@pytest.mark.parametrize("case,schedule", FIRST_STEP,
                         ids=[f"{c}-{s}" for c, s in FIRST_STEP])
def test_first_step_loss_and_grads_match_jax(jax_first_steps, case, schedule):
    dims, dist, stage, data, micro, rows, v = GRAD_CASES[case]
    loss_j, grads_j, jparams, (xs, labels, mask) = jax_first_steps(case, schedule)
    params = pipeline_params_from_jax(jparams)
    got_batch = prepare_pipeline_batch(params.meta, *_batch(dims, rows), micro, data)
    for a, b in zip(got_batch, (xs, labels, mask)):
        np.testing.assert_array_equal(a, np.asarray(b))
    loss, grads = pipeline_loss_and_grad(_cpu_mesh(stage, data), params, *got_batch,
                                         schedule=schedule, num_microbatches=micro,
                                         num_virtual=v)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    w_mask, b_mask = params.meta.grad_masks()
    np.testing.assert_allclose(grads.w, np.asarray(grads_j.w) * w_mask, **GRAD_TOL)
    np.testing.assert_allclose(grads.b, np.asarray(grads_j.b) * b_mask, **GRAD_TOL)
    # Outside the real blocks nothing is a leaf: exactly zero.
    assert not (grads.w * (1 - w_mask)).any() and not (grads.b * (1 - b_mask)).any()


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_one_adam_step_matches_jax(schedule):
    dims, dist, stage, data, micro, rows = [12, 10, 8, 6], [1, 1, 1], 3, 2, 4, 24
    jparams = jp.build_pipeline_params(jax_partition(random_model(dims, seed=0), dist))
    xs, labels, mask = jpt.prepare_pipeline_batch(jparams.meta, *_batch(dims, rows), micro, data)
    opt = optax.adam(1e-3)
    step = jpt.make_pipeline_train_step(jax_build_mesh(JaxMeshSpec(stage=stage, data=data)),
                                        jparams.meta, micro, opt, schedule=schedule)
    w_j, _, loss_j = step(jparams.weights, opt.init(jparams.weights), jnp.asarray(xs),
                          jnp.asarray(labels), jnp.asarray(mask))
    params = pipeline_params_from_jax(jparams)
    mesh = _cpu_mesh(stage, data)
    placed = place_leaves(mesh, params)
    optimizer = build_optimizer(1e-3)
    port_step = make_pipeline_train_step(mesh, params.meta, micro, optimizer, schedule=schedule)
    placed, _, loss = port_step(placed, optimizer.init(_leaves(placed)), xs, labels, mask)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    from tpu_dist_nn_torch.parallel.pipeline import pad_blocks

    got = pad_blocks(params.meta, placed.chunks[0])
    np.testing.assert_allclose(got.w, np.asarray(w_j.w), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.b, np.asarray(w_j.b), rtol=1e-4, atol=1e-6)
    # The replicas stayed identical.
    for a, b in zip(_leaves(placed, 0), _leaves(placed, 1)):
        assert torch.equal(a, b)


def test_schedule_validation_matches_jax():
    params = pipeline_params_from_jax(
        jp.build_pipeline_params(jax_partition(random_model([9, 7, 5], seed=0), [1, 1])))
    opt = build_optimizer(1e-3)
    jmesh = jax_build_mesh(JaxMeshSpec(stage=2, data=2))
    for kwargs in (dict(schedule="pipedream"), dict(schedule="zb"),
                   dict(schedule="1f1b", num_virtual=2)):
        with pytest.raises(ValueError) as want:
            jpt.make_pipeline_train_step(jmesh, params.meta, 2, optax.adam(1e-3), **kwargs)
        with pytest.raises(ValueError) as got:
            make_pipeline_train_step(_cpu_mesh(2, 2), params.meta, 2, opt, **kwargs)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="distribution"):
        make_pipeline_train_step(_cpu_mesh(2, 2), params.meta, 2, opt, schedule="interleaved",
                                 num_virtual=2)


def _data(seed=5, n=96, dim=12, classes=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, dim)) * 2
    y = rng.integers(0, classes, n)
    x = (centers[y] + rng.normal(size=(n, dim))).astype(np.float32)
    return x, y.astype(np.int32)


@pytest.mark.parametrize("schedule,dist,stage,data,virtual", [
    ("gpipe", [1, 1, 1], 3, 2, 1),
    ("1f1b", [1, 1, 1], 3, 1, 1),
    ("interleaved", [1, 1, 1, 1], 2, 1, 2),
], ids=["gpipe-data2", "1f1b", "interleaved"])
def test_train_pipelined_losses_and_eval_match_jax(schedule, dist, stage, data, virtual):
    from tpu_dist_nn.data.datasets import Dataset as JaxDataset

    x, y = _data()
    dims = [12, 10, 8, 6, 4][:len(dist) + 1]
    jparams = jp.build_pipeline_params(jax_partition(random_model(dims, seed=6, scale=1.0),
                                                     dist))
    cfg = dict(learning_rate=3e-3, epochs=3, batch_size=32, seed=0)
    jmesh = jax_build_mesh(JaxMeshSpec(stage=stage, data=data))
    trained_j, hist_j = jpt.train_pipelined(
        jparams, jmesh, JaxDataset(x, y, 4),
        JaxTrainConfig(**cfg), num_microbatches=2, eval_data=JaxDataset(x[:40], y[:40], 4),
        schedule=schedule, num_virtual=virtual)
    trained, hist = train_pipelined(
        pipeline_params_from_jax(jparams), _cpu_mesh(stage, data), Dataset(x, y, 4),
        TrainConfig(**cfg), num_microbatches=2, eval_data=Dataset(x[:40], y[:40], 4),
        schedule=schedule, num_virtual=virtual)
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in hist_j],
                               rtol=1e-4)
    for h, hj in zip(hist, hist_j):
        assert h["eval"]["accuracy"] == pytest.approx(hj["eval"]["accuracy"])
    assert isinstance(trained, PipelineParams) and trained.weights.w.dtype == np.float32
    # The trained contract evaluated again, as the JAX package does.
    got = evaluate_pipelined(trained, _cpu_mesh(stage, data), Dataset(x, y, 4),
                             num_microbatches=2, num_virtual=virtual)
    want = jpt.evaluate_pipelined(trained_j, jmesh, JaxDataset(x, y, 4), num_microbatches=2,
                                  num_virtual=virtual)
    assert got["accuracy"] == pytest.approx(want["accuracy"])


def test_resume_equals_a_straight_run_and_checkpoints_hold_the_padded_layout(tmp_path):
    x, y = _data(seed=7)
    jparams = jp.build_pipeline_params(jax_partition(random_model([12, 10, 8, 4], seed=8),
                                                     [1, 0, 2]))
    params = pipeline_params_from_jax(jparams)
    mesh = _cpu_mesh(3)
    data = Dataset(x, y, 4)
    cfg = TrainConfig(learning_rate=3e-3, epochs=3, batch_size=32, seed=0, clip_norm=1.0)
    straight, hist = train_pipelined(params, mesh, data, cfg, num_microbatches=2,
                                     schedule="1f1b")
    ckpt = CheckpointManager(tmp_path / "ck", keep=3)
    train_pipelined(params, mesh, data, TrainConfig(**{**cfg.__dict__, "epochs": 1}),
                    num_microbatches=2, checkpoints=ckpt, schedule="1f1b")
    resumed, hist_r = train_pipelined(params, mesh, data, cfg, num_microbatches=2,
                                      checkpoints=ckpt, schedule="1f1b")
    assert len(hist_r) == 2 and ckpt.latest_step() == 3
    np.testing.assert_allclose(resumed.weights.w, straight.weights.w, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose([h["loss"] for h in hist_r], [h["loss"] for h in hist[1:]],
                               rtol=1e-6)
    # The checkpoint's weights are the padded contract: extract_model
    # reads the trained blocks, filler and padding untouched.
    template = {"weights": {"w": params.weights.w, "b": params.weights.b}}
    state = restore_pytree({**template, "opt_state": _opt_template(params)},
                           ckpt._path(3))
    np.testing.assert_array_equal(state["weights"]["w"], resumed.weights.w)
    w_mask, _ = params.meta.grad_masks()
    np.testing.assert_array_equal(state["weights"]["w"] * (1 - w_mask),
                                  params.weights.w * (1 - w_mask))
    assert not (state["opt_state"]["mu"]["w"] * (1 - w_mask)).any()


def _opt_template(params):
    zeros = {"w": np.zeros_like(params.weights.w), "b": np.zeros_like(params.weights.b)}
    return {"count": 0, "mini_step": 0, "mu": zeros, "nu": dict(zeros), "acc": None}


def test_data_parallel_replicas_stay_identical_and_match_one_replica():
    x, y = _data(seed=9)
    params = pipeline_params_from_jax(jp.build_pipeline_params(
        jax_partition(random_model([12, 10, 8, 4], seed=10), [1, 1, 1])))
    cfg = TrainConfig(learning_rate=3e-3, epochs=2, batch_size=32, seed=0)
    mesh = _cpu_mesh(3, 2)
    placed = place_leaves(mesh, params)
    optimizer = build_optimizer(3e-3)
    step = make_pipeline_train_step(mesh, params.meta, 2, optimizer, schedule="1f1b")
    state = optimizer.init(_leaves(placed))
    for i in range(3):
        batch = prepare_pipeline_batch(params.meta, x[32 * i:32 * (i + 1)],
                                       y[32 * i:32 * (i + 1)], 2, 2)
        placed, state, _ = step(placed, state, *batch)
        for a, b in zip(_leaves(placed, 0), _leaves(placed, 1)):
            assert torch.equal(a, b)
    one, h1 = train_pipelined(params, _cpu_mesh(3), Dataset(x, y, 4), cfg, num_microbatches=2)
    two, h2 = train_pipelined(params, mesh, Dataset(x, y, 4), cfg, num_microbatches=2)
    np.testing.assert_allclose([h["loss"] for h in h2], [h["loss"] for h in h1], rtol=1e-5)
    np.testing.assert_allclose(two.weights.w, one.weights.w, rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def digits_model(tmp_path_factory):
    from tpu_dist_nn.models.fcnn import init_fcnn, spec_from_params

    path = tmp_path_factory.mktemp("digits") / "m.json"
    params = init_fcnn(jax.random.key(20), [64, 24, 16, 12, 10])
    save_model(spec_from_params(params, ["relu"] * 3 + ["softmax"]), path)
    return path


@pytest.mark.parametrize("dist,kw,schedule", [
    ([1, 1, 1, 1], {}, "gpipe"),
    ([1, 1, 1, 1], {}, "1f1b"),
    ([1, 1, 1, 1], dict(virtual_stages=2, data_parallel=2), "gpipe"),
], ids=["gpipe", "1f1b", "interleaved"])
def test_engine_train_matches_the_jax_engine_and_exports(digits_model, tmp_path, dist, kw,
                                                         schedule):
    tr, te = real_digits("train"), real_digits("test")
    jtr, jte = jax_real_digits("train"), jax_real_digits("test")
    cfg = dict(epochs=1, batch_size=64)
    want_eng = JaxEngine.up(digits_model, dist, **kw)
    want = want_eng.train(jtr, JaxTrainConfig(**cfg), eval_data=jte, schedule=schedule)
    eng = Engine.up(digits_model, dist, devices=["cpu"] * 4, **kw)
    got = eng.train(tr, TrainConfig(**cfg), eval_data=te, schedule=schedule)
    assert eng.pipelined
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=1e-4)
    assert got[0]["eval"]["accuracy"] == pytest.approx(want[0]["eval"]["accuracy"], abs=1e-6)
    # The trained weights serve on every path, and the exported model on
    # one program gives the pipelined outputs.
    out = tmp_path / "trained.json"
    eng.export(out)
    assert load_model(out).metadata["layer_distribution"] == dist
    pipelined = eng.infer(te.x)
    np.testing.assert_allclose(Engine.up(out, device="cpu").infer(te.x), pipelined,
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pipelined, want_eng.infer(jte.x), rtol=1e-3, atol=1e-5)
    params = extract_model(PipelineParams(
        PipelineWeights(*(np.asarray(a) for a in want_eng._pp.weights)),
        pipeline_params_from_jax(want_eng._pp).meta), load_model(digits_model), dist)
    for a, b in zip(eng.model.layers, params.layers):
        np.testing.assert_allclose(a.weights, b.weights, rtol=1e-3, atol=1e-5)


def test_engine_train_schedule_errors_match_jax(digits_model):
    tr = real_digits("train")
    cfg = TrainConfig(epochs=1, batch_size=64)
    eng_i = Engine.up(digits_model, [1, 1, 1, 1], virtual_stages=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="1f1b.*interleaved|interleaved.*1f1b"):
        eng_i.train(tr, cfg, schedule="1f1b")
    eng_g = Engine.up(digits_model, [1, 1, 1, 1], devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="virtual_stages"):
        eng_g.train(tr, cfg, schedule="interleaved")
    with pytest.raises(ValueError, match="zero-bubble"):
        eng_g.train(tr, cfg, schedule="zb")
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        eng_g.train(tr, cfg, schedule="pipedream")
    one = Engine.up(digits_model, device="cpu")
    with pytest.raises(ValueError, match="single-program"):
        one.train(tr, cfg, schedule="1f1b")
    # A collapsed interleaved request trains with the default schedule.
    collapsed = Engine.up(digits_model, [1, 1, 1, 1], virtual_stages=2, device="cpu")
    assert not collapsed.pipelined
    assert len(collapsed.train(Dataset(tr.x[:128], tr.y[:128], 10), cfg,
                               schedule="interleaved")) == 1


def test_trained_int8_pipeline_is_requantized_and_bit_equal_to_one_program(digits_model):
    tr, te = real_digits("train"), real_digits("test")
    eng = Engine.up(digits_model, [2, 2], devices=["cpu"] * 2, quantize="int8")
    stale = eng.infer(te.x)
    eng.train(Dataset(tr.x[:256], tr.y[:256], 10), TrainConfig(epochs=1, batch_size=64),
              schedule="1f1b")
    got = eng.infer(te.x)
    assert (got != stale).any()
    one = Engine.up(eng.model, device="cpu", quantize="int8")
    np.testing.assert_array_equal(got, one.infer(te.x))
