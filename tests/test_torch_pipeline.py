"""The port's layer-distribution pipeline against the JAX package's, on the CPU.

Both packages build the same padded contract from the same model file,
and the same numpy-seeded rows go through the JAX pipeline (on
conftest's 8 virtual host devices) and the port's (stage slots on
``devices=["cpu"] * n``, every kernel's plain version). Tolerances are
``tests/test_pipeline.py``'s: forwards within rtol 2e-5, atol 1e-6 of
JAX and the float64 oracle; int8 bit-equal to the port's single
program and within rtol 1e-6, atol 1e-7 of JAX's int8 pipeline (XLA
may contract the rescale into a fused multiply-add); the contract,
``grad_masks``, the int8 contract and the schedule tables exactly
equal.
"""

import numpy as np
import pytest
import torch

from tpu_dist_nn.api.engine import Engine as JaxEngine
from tpu_dist_nn.cli import main as tdn_main
from tpu_dist_nn.core.schema import partition_model as jax_partition
from tpu_dist_nn.core.schema import save_examples, save_model
from tpu_dist_nn.kernels.quantized import quantize_pipeline_weights as jax_quantize_pipeline
from tpu_dist_nn.parallel import pipeline as jp
from tpu_dist_nn.parallel import schedule_table as jst
from tpu_dist_nn.parallel.mesh import MeshSpec as JaxMeshSpec
from tpu_dist_nn.parallel.mesh import build_mesh as jax_build_mesh
from tpu_dist_nn.testing.factories import random_inputs, random_model
from tpu_dist_nn_torch.api.engine import Engine
from tpu_dist_nn_torch.cli import main as port_main
from tpu_dist_nn_torch.core.schema import load_model, partition_model
from tpu_dist_nn_torch.kernels.quantized import forward_quantized, pack_wq, quantize_fcnn
from tpu_dist_nn_torch.kernels.quantized import quantize_pipeline_weights
from tpu_dist_nn_torch.models.fcnn import params_from_spec
from tpu_dist_nn_torch.parallel import schedule_table as pst
from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
from tpu_dist_nn_torch.parallel.pipeline import (
    _masked_activation,
    _stage_apply,
    build_pipeline_params,
    extract_model,
    pad_batch,
    pipeline_forward,
    pipeline_forward_interleaved,
    pipeline_forward_interleaved_quantized,
    pipeline_forward_quantized,
    pipeline_params_from_jax,
    pipeline_spec_summary,
    place_pipeline,
    regroup_chunks,
    place_pipeline_quantized,
    run_placed,
    split_rows,
)
from tpu_dist_nn_torch.testing.oracle import oracle_forward_batch
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=1e-6)
INT8_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True)
def _pin_int8_serving(monkeypatch):
    monkeypatch.setenv("TDN_INT8_AUTO", "0")


def _port_model(jax_model, tmp_path, name="m.json"):
    path = tmp_path / name
    save_model(jax_model, path)
    return path, load_model(path)


def _cpu_mesh(stage, data=1):
    return build_mesh(MeshSpec(stage=stage, data=data), ["cpu"] * (stage * data))


@pytest.mark.parametrize("dist", [[1, 1, 1, 1], [2, 0, 2], [4], [0, 3, 1]],
                         ids=["one-a-stage", "empty-stage", "one-stage", "empty-first"])
def test_padded_contract_and_grad_masks_equal_jax(tmp_path, dist):
    model = random_model([12, 10, 8, 6, 4], seed=0)
    _, port_model = _port_model(model, tmp_path)
    want = jp.build_pipeline_params(jax_partition(model, dist))
    got = build_pipeline_params(partition_model(port_model, dist))
    np.testing.assert_array_equal(got.weights.w, np.asarray(want.weights.w))
    np.testing.assert_array_equal(got.weights.b, np.asarray(want.weights.b))
    for w_got, w_want in zip(got.meta.grad_masks(), want.meta.grad_masks()):
        np.testing.assert_array_equal(w_got, w_want)
    assert got.meta == pipeline_params_from_jax(want).meta
    assert pipeline_spec_summary(got) == jp.pipeline_spec_summary(want)
    q_got, q_want = quantize_pipeline_weights(got.weights), jax_quantize_pipeline(want.weights)
    for key in ("wq", "scale", "b"):
        np.testing.assert_array_equal(q_got[key], np.asarray(q_want[key]))
    # Each stage's real int8 blocks, as placed, are quantize_fcnn of its
    # layers code for code.
    placed = place_pipeline_quantized(_cpu_mesh(len(dist)), q_got, got.meta)
    cursor = 0
    for s, count in enumerate(dist):
        ref = quantize_fcnn(params_from_spec(
            type(port_model)(port_model.layers[cursor:cursor + count]), device="cpu"))
        cursor += count
        assert len(placed.chunks[0][s]) == count
        for layer, r in zip(placed.chunks[0][s], ref):
            for key in ("wq", "scale", "b", "act"):
                assert torch.equal(torch.as_tensor(layer[key]), torch.as_tensor(r[key])), key
            assert torch.equal(layer["wq_packed"], pack_wq(r["wq"]))


@pytest.mark.parametrize("act", ["linear", "relu", "sigmoid", "tanh", "gelu", "softmax"])
def test_masked_activation_and_padded_stage_match_jax(act):
    from tpu_dist_nn.core.activations import activation_id

    rng = np.random.default_rng(1)
    z = rng.normal(size=(5, 9)).astype(np.float32)
    want = np.asarray(jp._masked_activation(z, activation_id(act), 6))
    got = _masked_activation(torch.from_numpy(z), activation_id(act), 6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got[:, 6:] == 0).all()
    # A padded stage (the reference) equals the placed real layers.
    model = random_model([7, 9, 5], seed=2)
    for layer in model.layers:
        layer.activation = act
    pp = pipeline_params_from_jax(jp.build_pipeline_params(jax_partition(model, [2])))
    x = rng.uniform(size=(4, 7)).astype(np.float32)
    xs, _ = pad_batch(pp.meta, x, 1, 1)
    ref = _stage_apply(torch.from_numpy(pp.weights.w[0]), torch.from_numpy(pp.weights.b[0]),
                       pp.meta.act[0], pp.meta.width[0], torch.from_numpy(xs[0]))
    placed = place_pipeline(_cpu_mesh(1), pp)
    got = run_placed(placed, torch.from_numpy(x), 1)
    np.testing.assert_allclose(got.numpy(), ref[:, :5].numpy(), rtol=1e-6, atol=1e-7)


# (dims, distribution, stage, data, rows, microbatches): tests/test_pipeline.py's cases.
FORWARD_CASES = {
    "four-stage": ([20, 12, 8, 6, 4], [1, 1, 1, 1], 4, 1, 16, 4),
    "multi-layer-stages": ([10, 9, 8, 7, 6, 5], [2, 2, 1], 3, 1, 8, 2),
    "data-x-stage": ([20, 12, 8, 6, 4], [1, 1, 1, 1], 4, 2, 24, 3),
    "ragged-rows": ([12, 8, 4], [1, 1], 2, 1, 7, 3),
    "single-stage": ([12, 8, 4], [2], 1, 1, 6, 1),
    "empty-stage": ([12, 8, 4], [1, 0, 1], 3, 1, 6, 2),
    "eight-stages": ([24, 20, 18, 16, 14, 12, 10, 8, 6], [1] * 8, 8, 1, 16, 4),
    "fewer-rows-than-microbatches": ([12, 8, 4], [1, 1], 2, 2, 3, 4),
}


@pytest.mark.parametrize("case", FORWARD_CASES, ids=list(FORWARD_CASES))
def test_pipeline_forward_matches_jax_and_the_oracle(tmp_path, case):
    dims, dist, stage, data, n, micro = FORWARD_CASES[case]
    model = random_model(dims, seed=len(dims) + n)
    _, port_model = _port_model(model, tmp_path)
    x = random_inputs(n, dims[0], seed=42)
    jparams = jp.build_pipeline_params(jax_partition(model, dist))
    want = np.asarray(jp.pipeline_forward(jax_build_mesh(JaxMeshSpec(stage=stage, data=data)),
                                          jparams, x, num_microbatches=micro))
    params = build_pipeline_params(partition_model(port_model, dist))
    got = pipeline_forward(_cpu_mesh(stage, data), params, x, num_microbatches=micro)
    assert got.shape == (n, dims[-1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), oracle_forward_batch(port_model, x), **TOL)


def test_logits_variant_matches_jax():
    model = random_model([12, 8, 4], seed=7)
    jparams = jp.build_pipeline_params(jax_partition(model, [1, 1]))
    x = random_inputs(6, 12, seed=9)
    want = np.asarray(jp.pipeline_forward(jax_build_mesh(JaxMeshSpec(stage=2)), jparams, x,
                                          logits=True))
    params = pipeline_params_from_jax(jparams)
    mesh = _cpu_mesh(2)
    got = pipeline_forward(mesh, params, x, logits=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(torch.softmax(got, -1).numpy(),
                               pipeline_forward(mesh, params, x).numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("virtual,data", [(1, 1), (1, 2), (2, 1), (2, 2)],
                         ids=["plain", "data2", "interleaved", "interleaved-data2"])
def test_int8_pipeline_matches_jax_and_is_bit_equal_to_one_program(virtual, data):
    model = random_model([12, 10, 8, 6, 4], seed=3)
    dist = [1, 1, 1, 1]
    stage = len(dist) // virtual
    x = random_inputs(23, 12, seed=4)
    jparams = jp.build_pipeline_params(jax_partition(model, dist))
    jq = jax_quantize_pipeline(jparams.weights)
    jmesh = jax_build_mesh(JaxMeshSpec(stage=stage, data=data))
    params = pipeline_params_from_jax(jparams)
    q = quantize_pipeline_weights(params.weights)
    mesh = _cpu_mesh(stage, data)
    if virtual > 1:
        want = jp.pipeline_forward_interleaved_quantized(jmesh, jq, jparams.meta, x,
                                                         num_virtual=virtual, num_microbatches=3)
        got = pipeline_forward_interleaved_quantized(mesh, q, params.meta, x,
                                                     num_virtual=virtual, num_microbatches=3)
    else:
        want = jp.pipeline_forward_quantized(jmesh, jq, jparams.meta, x, num_microbatches=3)
        got = pipeline_forward_quantized(mesh, q, params.meta, x, num_microbatches=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **INT8_TOL)
    one = forward_quantized(quantize_fcnn(params_from_spec(
        model_from_jax(model), device="cpu")), torch.from_numpy(x.astype(np.float32)))
    assert torch.equal(got, one)


def model_from_jax(model):
    from tpu_dist_nn_torch.core.schema import ModelSpec

    return ModelSpec.from_json_dict(model.to_json_dict())


@pytest.mark.parametrize("data", [1, 2])
def test_interleaved_forward_matches_jax_and_the_plain_pipeline(data):
    model = random_model([12, 10, 8, 6, 4], seed=11)
    x = random_inputs(23, 12, seed=12)
    jparams = jp.build_pipeline_params(jax_partition(model, [1, 1, 1, 1]))
    want = np.asarray(jp.pipeline_forward_interleaved(
        jax_build_mesh(JaxMeshSpec(stage=2, data=data)), jparams, x, num_virtual=2,
        num_microbatches=4))
    params = pipeline_params_from_jax(jparams)
    got = pipeline_forward_interleaved(_cpu_mesh(2, data), params, x, num_virtual=2,
                                       num_microbatches=4)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = pipeline_forward(_cpu_mesh(4, data), params, x, num_microbatches=4)
    np.testing.assert_array_equal(regroup_chunks(params.weights.w, 2, 2),
                                  np.asarray(jp.regroup_chunks(jparams.weights.w, 2, 2)))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6, atol=1e-8)
    # One slot, two chunks: every hand-off is the self loopback.
    one = pipeline_forward_interleaved(_cpu_mesh(1), pipeline_params_from_jax(
        jp.build_pipeline_params(jax_partition(model, [2, 2]))), x, num_virtual=2,
        num_microbatches=2)
    np.testing.assert_allclose(one.numpy(), plain.numpy(), **TOL)


def _error(fn, *args, **kwargs) -> str:
    with pytest.raises(ValueError) as info:
        fn(*args, **kwargs)
    return str(info.value)


def test_checks_and_error_texts_match_jax():
    model = random_model([10, 8, 6], seed=2)
    jparams = jp.build_pipeline_params(jax_partition(model, [1, 1]))
    params = pipeline_params_from_jax(jparams)
    x = random_inputs(4, 10)
    # Stage count against the mesh.
    assert (_error(pipeline_forward, _cpu_mesh(4), params, x)
            == _error(jp.pipeline_forward, jax_build_mesh(JaxMeshSpec(stage=4)), jparams, x))
    # Input width.
    bad = random_inputs(4, 11)
    assert (_error(pipeline_forward, _cpu_mesh(2), params, bad)
            == _error(jp.pipeline_forward, jax_build_mesh(JaxMeshSpec(stage=2)), jparams, bad))
    # Chunk count of an interleaved placement.
    assert (_error(pipeline_forward_interleaved, _cpu_mesh(2), params, x, num_virtual=2)
            == _error(jp.pipeline_forward_interleaved, jax_build_mesh(JaxMeshSpec(stage=2)),
                      jparams, x, num_virtual=2))
    with pytest.raises(ValueError, match="only 2 are available"):
        build_mesh(MeshSpec(stage=3), ["cpu", "cpu"])


def test_split_rows_keep_the_pad_batch_grouping():
    meta = pipeline_params_from_jax(jp.build_pipeline_params(
        jax_partition(random_model([6, 4], seed=0), [1]))).meta
    for n, m, d in [(7, 3, 1), (24, 3, 2), (3, 4, 2), (1, 4, 1), (10, 1, 1)]:
        x = np.arange(n * 6, dtype=np.float32).reshape(n, 6) + 1
        xs, _ = pad_batch(meta, x, m, d)
        b = xs.shape[1] // d
        for mi, row in enumerate(split_rows(n, m, d)):
            for di, r in enumerate(row):
                block = xs[mi, di * b:(di + 1) * b]
                real = block[block.any(axis=1)]
                if r is None:
                    assert len(real) == 0
                else:
                    np.testing.assert_array_equal(real, x[r])


@pytest.mark.parametrize("S,v,M", [(2, 1, 4), (2, 2, 4), (4, 2, 8), (3, 2, 5), (2, 3, 1),
                                   (1, 2, 3), (3, 1, 4), (2, 2, 3)])
def test_schedule_tables_equal_jax_and_verify(S, v, M):
    for builder in ("build_interleaved_1f1b", "build_interleaved_forward"):
        want, got = getattr(jst, builder)(S, v, M), getattr(pst, builder)(S, v, M)
        for field in ("num_devices", "num_chunks", "num_microbatches", "ticks", "abuf_slots",
                      "gbuf_slots", "stash_slots", "op", "chunk", "mb", "stash", "abuf_read",
                      "gbuf_read", "abuf_write", "gbuf_write", "is_c0"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field), field)
        np.testing.assert_array_equal(got.send_rev, want.send_rev_or_default())
        for name, table in want.channel_tables().items():
            np.testing.assert_array_equal(got.channel_tables()[name], table, name)
        pst.verify_tables(got, forward_only=builder == "build_interleaved_forward")
        assert got.bubble_ticks == want.bubble_ticks
    with pytest.raises(AssertionError, match="clobbered|read"):
        broken = pst.build_interleaved_1f1b(2, 2, 4)
        object.__setattr__(broken, "abuf_read", np.where(broken.abuf_read >= 0, 0,
                                                         broken.abuf_read))
        pst.verify_tables(broken)


def test_extract_model_equals_jax(tmp_path):
    model = random_model([12, 10, 8, 6, 4], seed=5)
    _, port_model = _port_model(model, tmp_path)
    jparams = jp.build_pipeline_params(jax_partition(model, [2, 0, 2]))
    rng = np.random.default_rng(6)
    bumped = jparams._replace(weights=jparams.weights._replace(
        w=(np.asarray(jparams.weights.w) + rng.normal(size=jparams.weights.w.shape))
        .astype(np.float32)))
    want = jp.extract_model(bumped, model, [2, 0, 2])
    got = extract_model(pipeline_params_from_jax(bumped), port_model, [2, 0, 2])
    for a, b in zip(got.layers, want.layers):
        np.testing.assert_array_equal(a.weights, np.asarray(b.weights, np.float64))
        np.testing.assert_array_equal(a.biases, np.asarray(b.biases, np.float64))
    with pytest.raises(ValueError, match="stages but params"):
        extract_model(pipeline_params_from_jax(bumped), port_model, [2, 2])


@pytest.fixture(scope="module")
def engine_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("engine") / "m.json"
    save_model(random_model([12, 10, 8, 6, 4], seed=11), path)
    return path


# (distribution, kwargs of Engine.up): plain, data x stage, interleaved, int8.
ENGINE_CASES = {
    "plain": ([1, 1, 1, 1], {}),
    "data-x-stage": ([2, 2], dict(data_parallel=2)),
    "interleaved": ([1, 1, 1, 1], dict(virtual_stages=2, data_parallel=2)),
    "int8": ([1, 1, 1, 1], dict(quantize="int8")),
    "int8-interleaved": ([1, 1, 1, 1], dict(quantize="int8", virtual_stages=2)),
}


@pytest.mark.parametrize("case", ENGINE_CASES, ids=list(ENGINE_CASES))
def test_engine_matches_the_jax_engine(engine_file, case):
    dist, kw = ENGINE_CASES[case]
    x = np.random.default_rng(12).uniform(0, 1, (23, 12))
    want_eng = JaxEngine.up(engine_file, dist, num_microbatches=3, **kw)
    eng = Engine.up(engine_file, dist, num_microbatches=3, devices=["cpu"] * 4, **kw)
    place, want_place = eng.placement(), want_eng.placement()
    for key in ("devices", "distribution", "data_parallel", "pipelined", "num_stages",
                "layers_per_stage", "padded_width", "input_dim", "output_dim"):
        assert place[key] == want_place[key], key
    assert place.get("virtual_stages") == want_place.get("virtual_stages")
    assert place["pipelined"] and len(place["slots"]) == want_place["devices"] // place[
        "data_parallel"]
    got = eng.infer(x)
    tol = INT8_TOL if "quantize" in kw else TOL
    np.testing.assert_allclose(got, want_eng.infer(x), **tol)
    if "quantize" in kw:
        one = Engine.up(engine_file, device="cpu", quantize="int8")
        np.testing.assert_array_equal(got, one.infer(x))
    else:
        np.testing.assert_allclose(got, oracle_forward_batch(load_model(engine_file), x), **TOL)
    lat = eng.step_latency(batch_size=8, iters=2)
    assert lat["num_stages"] == place["num_stages"]
    assert lat["p50_per_stage_s"] == pytest.approx(lat["p50_s"] / place["num_stages"])
    # The chunked double-buffered loop and whole-set inference agree.
    res = eng.run_inference(x, batch_size=10)
    np.testing.assert_array_equal(res.outputs, got)


def test_engine_placement_collapse_and_validation_match_jax(engine_file, tmp_path, caplog):
    with pytest.raises(InvalidArgumentError, match=">= 1"):
        Engine.up(engine_file, [1, 1, 1, 1], virtual_stages=0, devices=["cpu"] * 4)
    with pytest.raises(InvalidArgumentError, match="divisible"):
        Engine.up(engine_file, [2, 1, 1], virtual_stages=2, devices=["cpu"] * 4)
    # A shortage of slots collapses, as the JAX Engine does on too few devices.
    with caplog.at_level("INFO"):
        eng = Engine.up(engine_file, [1, 1, 1, 1], virtual_stages=2, data_parallel=8,
                        devices=["cpu"] * 4)
    assert "collapsing to the single-program executor" in caplog.text
    want = JaxEngine.up(engine_file, [1, 1, 1, 1], virtual_stages=2, data_parallel=8)
    assert not eng.pipelined and eng.virtual_stages == want.virtual_stages == 1
    assert eng.requested_virtual_stages == want.requested_virtual_stages == 2
    assert eng.placement()["distribution"] == [4]
    # devices=None on the CPU is one slot: [1, 1, 1] collapses.
    assert not Engine.up(engine_file, [2, 1, 1], device="cpu").pipelined
    # A conv model's multi-stage distribution collapses, logged.
    from tpu_dist_nn_torch.core.schema import save_model as port_save
    from tpu_dist_nn_torch.models.network import init_conv_mlp

    conv = init_conv_mlp(torch.Generator().manual_seed(0), in_shape=(8, 8, 1),
                         conv_filters=(2,), hidden=(6,), num_classes=3)
    port_save(conv, tmp_path / "conv.json")
    caplog.clear()
    with caplog.at_level("INFO"):
        engc = Engine.up(tmp_path / "conv.json", [2, 2], devices=["cpu"] * 2)
    assert "heterogeneous pipeline" in caplog.text and not engc.pipelined
    assert engc.infer(np.zeros((2, 64))).shape == (2, 3)
    eng = Engine.up(engine_file, [1, 1, 1, 1], devices=["cpu"] * 4)
    eng.down()
    assert not eng.is_ready
    with pytest.raises(Exception, match="engine is down"):
        eng.infer(np.zeros((1, 12)))


def test_cli_infer_with_the_placement_flags_prints_what_tdn_prints(tmp_path, capsys):
    model = random_model([10, 8, 8, 6, 4], seed=13)
    mp = tmp_path / "m.json"
    save_model(model, mp)
    x = np.random.default_rng(14).uniform(0, 1, (12, 10))
    save_examples(x, oracle_forward_batch(load_model(mp), x).argmax(-1), tmp_path / "e.json")
    args = ["infer", "--config", str(mp), "--inputs", str(tmp_path / "e.json"),
            "--distribution", "1,1,1,1", "--virtual-stages", "2", "--microbatches", "2"]
    assert tdn_main(args) == 0
    want = capsys.readouterr().out
    # One CPU device: the port collapses the placement and serves on one program.
    assert port_main([*args, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    line = [ln for ln in got.splitlines() if ln.startswith("Correct predictions")]
    assert line and line == [ln for ln in want.splitlines()
                             if ln.startswith("Correct predictions")]
    assert "accuracy 1.0000" in line[0]
