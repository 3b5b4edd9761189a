"""The port's conv-network slice against the JAX package, on the CPU.

The same numpy-seeded images and weights go through a ``tpu_dist_nn``
function and its ``tpu_dist_nn_torch`` counterpart in this process. The
JAX ``fused_conv2d`` runs its Pallas kernel in interpret mode, as
``tests/test_conv_kernel.py`` runs it; the port's wrapper runs its plain
version for CPU tensors. Tolerances are those of the JAX package's own
tests: rtol 2e-5 / atol 1e-5 for the kernel (``test_conv_kernel.py``),
rtol 2e-4 / atol 1e-5 for the network against the float64 oracle, and
rtol 5e-4 / atol 1e-5 for the engine (``test_conv.py``). Images stay
small because interpret-mode Pallas is slow. The conv kernel itself runs
only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_dist_nn.models.network as jax_network
from tpu_dist_nn.api.engine import Engine as JaxEngine
from tpu_dist_nn.cli import main as tdn_main
from tpu_dist_nn.core import schema as jax_schema
from tpu_dist_nn.core.activations import ACTIVATION_NAMES, activation_id
from tpu_dist_nn.kernels.conv2d import fused_conv2d as jax_fused_conv2d
from tpu_dist_nn.testing import oracle as jax_oracle
from tpu_dist_nn_torch.api.engine import Engine
from tpu_dist_nn_torch.cli import main as port_main
from tpu_dist_nn_torch.core import schema as pt_schema
from tpu_dist_nn_torch.kernels import (
    KERNEL_WRAPPERS,
    fused_conv2d,
    fused_conv2d_plain,
    reset_launch_counts,
)
from tpu_dist_nn_torch.kernels.conv2d import SMEM_LIMIT_BYTES, conv_plan, same_pad
from tpu_dist_nn_torch.models import network
from tpu_dist_nn_torch.testing import oracle
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
ACTIVATIONS = ["linear", "relu", "sigmoid", "tanh", "gelu", "softmax"]


def _jax_conv_mlp(seed=0, **kw):
    kw = {"in_shape": (8, 8, 3), "conv_filters": (4, 8), "hidden": (16,),
          "num_classes": 4, **kw}
    return jax_network.init_conv_mlp(jax.random.key(seed), **kw)


@pytest.fixture
def conv_file(tmp_path):
    """A tiny conv-pool-conv-pool-dense-dense model with nonzero biases,
    written by the JAX package in the public JSON schema."""
    model = _jax_conv_mlp()
    rng = np.random.default_rng(9)
    for layer in model.layers:
        if layer.kind != "maxpool2d":
            layer.biases = rng.normal(0.0, 0.05, layer.biases.shape)
    path = tmp_path / "conv.json"
    jax_schema.save_model(model, path)
    return path


def _imgs(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# --------------------------------------------------------------- schema


def test_conv_json_round_trips_between_the_packages(conv_file, tmp_path):
    model = pt_schema.load_model(conv_file)
    jmodel = jax_schema.load_model(conv_file)
    assert [l.kind for l in model.layers] == [l.kind for l in jmodel.layers] == [
        "conv2d", "maxpool2d", "conv2d", "maxpool2d", "dense", "dense"]
    assert not model.is_dense and model.input_dim == 192 and model.output_dim == 4
    assert model.layer_sizes == jmodel.layer_sizes
    assert model.to_json_dict() == jmodel.to_json_dict()
    back = tmp_path / "back.json"
    pt_schema.save_model(model, back)
    assert jax_schema.load_model(back).to_json_dict() == jmodel.to_json_dict()
    pool = pt_schema.MaxPool2DSpec(in_shape=(8, 8, 4), window=(3, 3), stride=(2, 2))
    assert pool.to_json() == jax_schema.MaxPool2DSpec((8, 8, 4), (3, 3), (2, 2)).to_json()
    assert pt_schema.MaxPool2DSpec.from_json(pool.to_json()).out_shape == (3, 3, 4)
    stages = pt_schema.partition_model(model, [2, 2, 2])
    assert [s.expected_input_dim for s in stages] == [
        s.expected_input_dim for s in jax_schema.partition_model(jmodel, [2, 2, 2])]


@pytest.mark.parametrize(
    "in_shape,k,stride,padding",
    [((7, 7, 2), 3, (2, 2), "valid"), ((7, 6, 2), 3, (2, 3), "same"),
     ((8, 8, 2), 2, (1, 1), "same"), ((9, 5, 2), 4, (3, 1), "valid")],
)
def test_conv_spec_shapes_match_jax(in_shape, k, stride, padding):
    w = np.zeros((k, k, in_shape[2], 5))
    spec = pt_schema.Conv2DSpec(in_shape, w, np.zeros(5), stride, padding)
    jspec = jax_schema.Conv2DSpec(in_shape, w, np.zeros(5), stride, padding)
    assert (spec.out_shape, spec.in_dim, spec.out_dim) == (
        jspec.out_shape, jspec.in_dim, jspec.out_dim)
    assert spec.to_json() == jspec.to_json()


_BAD_LAYERS = {
    "channels": {"type": "conv2d", "in_shape": [4, 4, 3],
                 "weights": np.zeros((3, 3, 2, 4)).tolist(), "bias": [0.0] * 4},
    "padding": {"type": "conv2d", "in_shape": [4, 4, 2], "padding": "reflect",
                "weights": np.zeros((3, 3, 2, 4)).tolist(), "bias": [0.0] * 4},
    "bias": {"type": "conv2d", "in_shape": [4, 4, 2],
             "weights": np.zeros((3, 3, 2, 4)).tolist(), "bias": [0.0] * 3},
    "does not fit": {"type": "conv2d", "in_shape": [2, 2, 2], "padding": "valid",
                     "weights": np.zeros((3, 3, 2, 4)).tolist(), "bias": [0.0] * 4},
    "must be positive": {"type": "maxpool2d", "in_shape": [4, 4, 2], "window": [0, 2]},
    "does not fit input": {"type": "maxpool2d", "in_shape": [4, 4, 2], "window": [5, 2]},
}


@pytest.mark.parametrize("match", sorted(_BAD_LAYERS))
def test_conv_validation_errors_match_jax(match):
    obj = {"layers": [_BAD_LAYERS[match]]}
    with pytest.raises(ValueError, match=match) as want:
        jax_schema.ModelSpec.from_json_dict(obj)
    with pytest.raises(ValueError, match=match) as got:
        pt_schema.ModelSpec.from_json_dict(obj)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------- oracle


@pytest.mark.parametrize("conv_act", ["relu", "softmax", "TanH", "unknown"])
def test_oracle_matches_the_jax_oracle_exactly(conv_file, conv_act):
    obj = json.loads(conv_file.read_text())
    obj["layers"][2]["activation"] = conv_act  # the second conv
    # A SAME 2x2 conv that keeps the 4x4x4 shape: even kernel, so the
    # extra padding row and column go after.
    obj["layers"].insert(2, {
        "type": "conv2d", "in_shape": [4, 4, 4], "stride": [1, 1], "padding": "same",
        "weights": (np.random.default_rng(3).normal(size=(2, 2, 4, 4)) * 0.3).tolist(),
        "bias": [0.1, -0.1, 0.0, 0.2], "activation": "sigmoid"})
    model = pt_schema.ModelSpec.from_json_dict(obj)
    jmodel = jax_schema.ModelSpec.from_json_dict(obj)
    x = np.random.default_rng(1).uniform(size=(4, model.input_dim))
    want = jax_oracle.oracle_forward_batch(jmodel, x)
    np.testing.assert_array_equal(oracle.oracle_forward_batch(model, x), want)
    for size, k, s in [(32, 3, 1), (16, 2, 1), (9, 4, 2), (7, 3, 3), (5, 1, 2)]:
        assert oracle._same_pad(size, k, s) == jax_oracle._same_pad(size, k, s)
        assert same_pad(size, k, s) == jax_oracle._same_pad(size, k, s)
    with pytest.raises(ValueError, match="Dimension mismatch"):
        oracle.oracle_forward(model, x[0, :-1])


# ------------------------------------------------- kernel (plain version)


_KERNEL_CASES = {
    **{f"{pad}-s{s}": dict(padding=pad, stride=(s, s), activation="relu")
       for pad in ("valid", "same") for s in (1, 2)},
    "pool2x2": dict(padding="valid", activation="relu", pool_window=(2, 2)),
    "same-pool2x2": dict(padding="same", activation="tanh", pool_window=(2, 2)),
    "pool3x3s2": dict(padding="valid", activation="relu", pool_window=(3, 3),
                      pool_stride=(2, 2)),
    "pool3x3s1": dict(padding="same", activation="linear", pool_window=(3, 3),
                      pool_stride=(1, 1)),
    "k2-same": dict(padding="same", activation="sigmoid", k=2),
    "k4-same": dict(padding="same", activation="gelu", k=4),
    **{f"act-{a}": dict(padding="same", activation=a, pool_window=(2, 2)) for a in ACTIVATIONS},
    "unknown-name": dict(padding="valid", activation="ReLU-Custom"),
    "mixed-case": dict(padding="valid", activation="TanH"),
}


@pytest.mark.parametrize("case", list(_KERNEL_CASES))
def test_plain_conv_matches_the_jax_pallas_kernel(case):
    kw = dict(_KERNEL_CASES[case])
    k = kw.pop("k", 3)
    rng = np.random.default_rng(0)
    imgs = _imgs((5, 9, 9, 3))
    w = (rng.normal(size=(k, k, 3, 7)) * 0.3).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    # The JAX network canonicalises the name before its Pallas call
    # (models/network.py:131-135); the port's wrapper does it itself.
    jax_kw = dict(kw, activation=ACTIVATION_NAMES[activation_id(kw["activation"])])
    want = np.asarray(jax_fused_conv2d(jnp.asarray(imgs), jnp.asarray(w), jnp.asarray(b),
                                       **jax_kw))
    reset_launch_counts()
    got = fused_conv2d(torch.from_numpy(imgs), torch.from_numpy(w), torch.from_numpy(b), **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)
    assert fused_conv2d.launches == 0  # a CPU tensor runs the plain version


def test_conv_wrapper_validates_like_the_jax_kernel():
    imgs, w, b = torch.zeros(2, 5, 5, 3), torch.zeros(3, 3, 4, 6), torch.zeros(6)
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_fused_conv2d(jnp.zeros((2, 5, 5, 3)), jnp.zeros((3, 3, 4, 6)), jnp.zeros(6))
    with pytest.raises(InvalidArgumentError, match="shape mismatch"):
        fused_conv2d(imgs, w, b)
    w = torch.zeros(3, 3, 3, 6)
    with pytest.raises(InvalidArgumentError, match="shape mismatch"):
        fused_conv2d(imgs, w, torch.zeros(5))
    with pytest.raises(InvalidArgumentError, match="dtype"):
        fused_conv2d(imgs.double(), w, b)
    with pytest.raises(InvalidArgumentError, match="contiguous"):
        fused_conv2d(imgs.transpose(1, 2), w, b)
    with pytest.raises(InvalidArgumentError, match="padding"):
        fused_conv2d(imgs, w, b, padding="reflect")
    with pytest.raises(InvalidArgumentError, match="do not fit"):
        fused_conv2d(imgs, w, b, pool_window=(4, 4))


def test_conv_plan_bands_and_shared_memory_limit():
    stage1 = conv_plan((1024, 32, 32, 3), (3, 3, 3, 16), (1, 1), "same", (2, 2))
    stage2 = conv_plan((1024, 16, 16, 16), (3, 3, 16, 32), (1, 1), "same", (2, 2))
    assert stage1.out_shape == (1024, 16, 16, 16) and stage1.band == 8
    assert stage2.out_shape == (1024, 8, 8, 32) and stage2.band == 4
    assert stage2.cc == 32  # the 18.4 KB of weights stage in one chunk
    assert max(stage1.smem_bytes, stage2.smem_bytes) <= 48 * 1024
    assert stage1.pad == (1, 1) and stage1.pool == (2, 2, 2, 2)
    strided = conv_plan((2, 9, 9, 3), (4, 4, 3, 5), (2, 2), "same")
    assert strided.pad == (same_pad(9, 4, 2)[0],) * 2 and strided.conv_hw == (5, 5)
    wide = conv_plan((4, 112, 112, 64), (3, 3, 64, 64), (1, 1), "same")
    assert wide.band >= 1 and wide.smem_bytes <= SMEM_LIMIT_BYTES
    with pytest.raises(InvalidArgumentError, match="232448-byte limit"):
        conv_plan((1, 64, 64, 256), (3, 3, 256, 256), (1, 1), "same")


def test_cpu_path_has_no_shared_memory_limit():
    # One staged row of 34 x 1025 floats, three rows deep, is over a
    # block's shared memory: the card refuses the layer, the plain
    # version on the CPU computes it.
    imgs_shape, w_shape = (1, 3, 32, 1024), (3, 3, 1024, 1)
    with pytest.raises(InvalidArgumentError, match="232448-byte limit"):
        conv_plan(imgs_shape, w_shape, (1, 1), "same")
    rng = np.random.default_rng(9)
    imgs, w = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
               for shape in (imgs_shape, w_shape))
    b = torch.zeros(1)
    got = fused_conv2d(imgs, w, b, padding="same", activation="relu")
    want = fused_conv2d_plain(imgs, w, b, padding="same", activation="relu")
    assert got.shape == (1, 3, 32, 1) and torch.equal(got, want)


# -------------------------------------------------------------- network


@pytest.mark.parametrize("pallas", [False, True], ids=["lax", "pallas"])
def test_network_forward_matches_jax_and_the_oracle(conv_file, monkeypatch, pallas):
    monkeypatch.setattr(jax_network, "_PALLAS_CONV", pallas)
    jmodel = jax_schema.load_model(conv_file)
    jplan, jparams = jax_network.build_network(jmodel)
    x = np.random.default_rng(4).uniform(0, 1, (7, jmodel.input_dim)).astype(np.float32)
    want = np.asarray(jax_network.network_forward(jplan, jparams, jnp.asarray(x)))
    model = pt_schema.load_model(conv_file)
    plan, params = network.build_network(model, device="cpu")
    from_jax = network.network_params_from_jax(jparams, device="cpu")
    assert [sorted(p) for p in from_jax] == [sorted(p) for p in params]
    for a, b in zip(from_jax, params):
        for k in a:
            torch.testing.assert_close(a[k], b[k], atol=0, rtol=0)
    got = network.network_forward(plan, from_jax, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got, oracle.oracle_forward_batch(model, x), rtol=2e-4, atol=1e-5)
    logits = network.network_logits(plan, params, torch.from_numpy(x)).numpy()
    jlogits = np.asarray(jax_network.network_logits(jplan, jparams, jnp.asarray(x)))
    np.testing.assert_allclose(logits, jlogits, rtol=2e-5, atol=1e-5)


def test_network_edge_plans_match_jax():
    """A pool that follows no conv, a conv with no pool, a strided VALID
    conv, a dense layer before the convs, and a softmax conv."""
    rng = np.random.default_rng(5)
    layers = [
        jax_schema.LayerSpec(rng.normal(size=(12, 48)) * 0.3, rng.normal(size=48) * 0.1, "tanh"),
        jax_schema.MaxPool2DSpec(in_shape=(4, 4, 3), window=(2, 2), stride=(1, 1)),
        jax_schema.Conv2DSpec((3, 3, 3), rng.normal(size=(2, 2, 3, 5)) * 0.3,
                              rng.normal(size=5) * 0.1, (1, 1), "valid", "softmax"),
        jax_schema.Conv2DSpec((2, 2, 5), rng.normal(size=(1, 1, 5, 4)) * 0.3,
                              rng.normal(size=4) * 0.1, (2, 2), "valid", "gelu"),
        jax_schema.LayerSpec(rng.normal(size=(4, 3)) * 0.3, np.zeros(3), "softmax", "output"),
    ]
    jmodel = jax_schema.ModelSpec(layers)
    jmodel.validate_chain()
    model = pt_schema.ModelSpec.from_json_dict(jmodel.to_json_dict())
    x = rng.uniform(size=(6, 12)).astype(np.float32)
    jplan, jparams = jax_network.build_network(jmodel)
    want = np.asarray(jax_network.network_forward(jplan, jparams, jnp.asarray(x)))
    plan, params = network.build_network(model, device="cpu")
    assert [p.kind for p in plan] == [p.kind for p in jplan]
    got = network.network_forward(plan, params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got, oracle.oracle_forward_batch(model, x), rtol=2e-4, atol=1e-5)


def test_init_conv_mlp_and_export_match_jax_structure():
    gen = torch.Generator().manual_seed(0)
    model = network.init_conv_mlp(gen)
    jmodel = jax_network.init_conv_mlp(jax.random.key(0))
    assert [(l.kind, l.in_dim, l.out_dim, l.activation) for l in model.layers] == [
        (l.kind, l.in_dim, l.out_dim, l.activation) for l in jmodel.layers]
    n_params = sum(l.weights.size + l.biases.size for l in model.layers if l.kind != "maxpool2d")
    assert n_params == 136_874
    w = model.layers[2].weights  # 3x3x16x32, He-normal
    assert abs(float(w.std()) - (2.0 / 144) ** 0.5) < 0.01
    small = network.init_conv_mlp(torch.Generator().manual_seed(1), in_shape=(6, 6, 1),
                                  conv_filters=(3,), hidden=(), num_classes=2,
                                  pool_after_conv=False)
    assert [l.kind for l in small.layers] == ["conv2d", "dense"]
    plan, params = network.build_network(small, device="cpu")
    params[0]["w"] = params[0]["w"] + 1.0
    back = network.network_model_from_params(small, params)
    np.testing.assert_allclose(back.layers[0].weights, small.layers[0].weights + 1.0, atol=1e-6)
    assert back.layers[1].kind == "dense" and back is not small


# --------------------------------------------------------------- engine


def test_engine_matches_the_jax_engine(conv_file, caplog):
    jmodel = jax_schema.load_model(conv_file)
    x = np.random.default_rng(6).uniform(0, 1, (23, jmodel.input_dim))
    labels = np.random.default_rng(7).integers(0, 4, 23)
    want = JaxEngine.up(jmodel, [len(jmodel.layers)]).run_inference(x, labels, batch_size=8)
    reset_launch_counts()
    with caplog.at_level("INFO"):
        eng = Engine.up(conv_file, [2, 2, 2], device="cpu", warm_rows=3)
    assert "collapsing to the single-program executor" in caplog.text
    got = eng.run_inference(x, labels, batch_size=8)
    assert got.outputs.shape == (23, 4) and len(got.batch_seconds) == 3
    np.testing.assert_allclose(got.outputs, want.outputs, rtol=5e-4, atol=1e-5)
    assert got.metrics == want.metrics
    np.testing.assert_allclose(
        got.outputs, oracle.oracle_forward_batch(eng.model, x), rtol=5e-4, atol=1e-5)
    assert eng.placement()["distribution"] == [6] and eng.warm_bucket_count == 3
    out, seconds = eng.infer_single(x[0])
    np.testing.assert_array_equal(out, eng.infer(x[:1])[0])
    assert [fn.launches for fn in KERNEL_WRAPPERS] == [0] * len(KERNEL_WRAPPERS)


def test_engine_int8_export_and_down_on_a_conv_model(conv_file, tmp_path):
    jmodel = jax_schema.load_model(conv_file)
    with pytest.raises(ValueError, match="dense models only") as want:
        JaxEngine.up(jmodel, quantize="int8")
    with pytest.raises(InvalidArgumentError, match="dense models only") as got:
        Engine.up(conv_file, device="cpu", quantize="int8")
    assert str(got.value) == str(want.value)
    eng = Engine.up(conv_file, device="cpu")
    out = tmp_path / "exported.json"
    eng.export(out, metrics={"accuracy": 0.25})
    back = jax_schema.load_model(out)
    assert back.metadata["inference_metrics"] == {"accuracy": 0.25}
    assert back.to_json_dict()["layers"] == jmodel.to_json_dict()["layers"]
    with pytest.raises(InvalidArgumentError, match="Expected input dimension 192"):
        eng.infer(np.zeros((2, 191)))
    eng.down()
    assert not eng.is_ready


# ------------------------------------------------------------------ CLI


def _lines(text, prefix):
    return [l for l in text.splitlines() if l.startswith(prefix)]


def test_cli_infer_and_oracle_print_the_lines_tdn_prints(conv_file, tmp_path, capsys):
    x = np.random.default_rng(8).uniform(0, 1, (20, 192))
    ex = tmp_path / "ex.json"
    jax_schema.save_examples(x, np.random.default_rng(9).integers(0, 4, 20), ex)
    common = ["--config", str(conv_file), "--inputs", str(ex)]
    assert tdn_main(["infer", *common, "--batch-size", "8"]) == 0
    want = capsys.readouterr().out
    assert port_main(["infer", *common, "--batch-size", "8", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    for prefix in ("Correct predictions:", "Metrics:"):
        assert _lines(got, prefix) == _lines(want, prefix) and _lines(got, prefix)
    pattern = r"Total inference time: \d+\.\d{4} seconds \(\d+\.\d samples/sec\)"
    assert re.fullmatch(pattern, _lines(got, "Total")[0])

    assert tdn_main(["infer", "3", *common]) == 0
    want = capsys.readouterr().out
    assert port_main(["infer", "3", *common, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert _lines(got, "Label:") == _lines(want, "Label:") and _lines(got, "Label:")
    g = json.loads(_lines(got, "Output:")[0][len("Output: "):])
    w = json.loads(_lines(want, "Output:")[0][len("Output: "):])
    np.testing.assert_allclose(g, w, rtol=5e-4, atol=1e-5)

    assert tdn_main(["oracle", *common]) == 0
    want = capsys.readouterr().out.splitlines()
    assert port_main(["oracle", *common]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 22
    for g, w in zip(got, want):
        assert re.sub(r"\d", "0", g) == re.sub(r"\d", "0", w)


_BLOCKED_CONV_RUN = r"""
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
import numpy as np
import torch
from tpu_dist_nn_torch.api.engine import Engine
from tpu_dist_nn_torch.cli import main
from tpu_dist_nn_torch.core.schema import save_examples, save_model
from tpu_dist_nn_torch.kernels import fused_conv2d
from tpu_dist_nn_torch.models.network import init_conv_mlp
from tpu_dist_nn_torch.testing.oracle import oracle_forward_batch

model = init_conv_mlp(torch.Generator().manual_seed(0), in_shape=(8, 8, 3),
                      conv_filters=(4, 8), hidden=(16,), num_classes=4)
save_model(model, sys.argv[1] + "/conv.json")
x = np.random.default_rng(0).uniform(size=(10, 192))
out = Engine.up(sys.argv[1] + "/conv.json", [2, 2, 2], device="cpu").run_inference(
    x, batch_size=4).outputs
assert out.shape == (10, 4)
assert np.abs(out - oracle_forward_batch(model, x)).max() < 1e-5
assert fused_conv2d.launches == 0
save_examples(x, np.zeros(10, np.int32), sys.argv[1] + "/ex.json")
assert main(["infer", "--config", sys.argv[1] + "/conv.json", "--inputs",
             sys.argv[1] + "/ex.json", "--device", "cpu"]) == 0
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpu_dist_nn")]
assert not bad, bad
print("conv model served without jax")
"""


def test_conv_path_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_CONV_RUN, str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "without jax" in proc.stdout
