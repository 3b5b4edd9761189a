"""The PyTorch port's FCNN layer against the JAX package, on the CPU.

Each test feeds the same numpy-seeded inputs to a ``tpu_dist_nn``
function and its ``tpu_dist_nn_torch`` counterpart in this process
(JAX on the CPU, torch with ``device="cpu"``), at the tolerances of the
JAX package's own tests (``tests/test_forward_parity.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist_nn.core import activations as jax_acts
from tpu_dist_nn.core import schema as jax_schema
from tpu_dist_nn.data.feed import batch_iterator as jax_batch_iterator
from tpu_dist_nn.models import fcnn as jax_fcnn
from tpu_dist_nn.testing.factories import random_inputs, random_model
from tpu_dist_nn.testing.oracle import oracle_forward_batch as jax_oracle_batch
from tpu_dist_nn.train.metrics import classification_metrics as jax_metrics
from tpu_dist_nn.utils.profiling import LatencyStats as JaxLatencyStats
from tpu_dist_nn_torch.core import activations as pt_acts
from tpu_dist_nn_torch.core import schema as pt_schema
from tpu_dist_nn_torch.data.feed import batch_iterator
from tpu_dist_nn_torch.models import fcnn
from tpu_dist_nn_torch.testing.oracle import oracle_forward, oracle_forward_batch
from tpu_dist_nn_torch.train.metrics import classification_metrics
from tpu_dist_nn_torch.utils.device import resolve_device
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError, UnavailableError
from tpu_dist_nn_torch.utils.profiling import LatencyStats

torch.set_num_threads(1)


def _port_model(jax_model, tmp_path):
    """The same model through the public JSON schema: JAX writes, port reads."""
    path = tmp_path / "model.json"
    jax_schema.save_model(jax_model, path)
    return pt_schema.load_model(path)


@pytest.mark.parametrize(
    "name", ["linear", "relu", "sigmoid", "softmax", "tanh", "gelu", "ReLU", "mystery"]
)
def test_activation_matches_jax(name):
    x = np.linspace(-4, 4, 48, dtype=np.float32).reshape(6, 8)
    want = np.asarray(jax_acts.apply_activation(jnp.asarray(x), name))
    got = pt_acts.apply_activation(torch.from_numpy(x), name).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert pt_acts.activation_id(name) == jax_acts.activation_id(name)


def test_activation_ids_and_order_match_jax():
    assert pt_acts.ACTIVATION_NAMES == jax_acts.ACTIVATION_NAMES
    assert pt_acts.SOFTMAX_ID == jax_acts.SOFTMAX_ID
    x = np.linspace(-3, 3, 24, dtype=np.float32).reshape(4, 6)
    for i in range(len(pt_acts.ACTIVATION_NAMES)):
        want = np.asarray(jax_acts.apply_activation_by_id(jnp.asarray(x), i))
        got = pt_acts.apply_activation_by_id(torch.from_numpy(x), i).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_gelu_is_the_tanh_form():
    x = torch.linspace(-3, 3, 13)
    got = pt_acts.apply_activation(x, "gelu")
    assert torch.allclose(got, torch.nn.functional.gelu(x, approximate="tanh"))
    assert not torch.allclose(got, torch.nn.functional.gelu(x), atol=1e-6)


def test_softmax_stability():
    out = pt_acts.apply_activation(torch.tensor([[1000.0, 1000.0, 999.0]]), "softmax")
    assert torch.isfinite(out).all()
    assert abs(float(out.sum()) - 1.0) < 1e-6


@pytest.mark.parametrize(
    "sizes,rtol,atol",
    [([6, 5, 4, 3], 2e-5, 2e-6), ([784, 32, 16, 10], 5e-4, 1e-5)],
    ids=["small", "mnist"],
)
def test_forward_matches_jax_and_oracle(tmp_path, sizes, rtol, atol):
    jmodel = random_model(sizes, seed=7)
    model = _port_model(jmodel, tmp_path)
    x = random_inputs(9, sizes[0])
    params = fcnn.params_from_spec(model, device="cpu")
    got = fcnn.forward(params, torch.from_numpy(x.astype(np.float32))).numpy()
    np.testing.assert_allclose(got, oracle_forward_batch(model, x), rtol=rtol, atol=atol)
    jparams = jax_fcnn.params_from_spec(jmodel)
    want = np.asarray(jax_fcnn.forward(jparams, jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_forward_float64_exact():
    model = random_model([12, 8, 4], seed=9)
    pmodel = pt_schema.ModelSpec.from_json_dict(model.to_json_dict())
    x = random_inputs(5, 12)
    params = fcnn.params_from_spec(pmodel, dtype=torch.float64, device="cpu")
    got = fcnn.forward(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, oracle_forward_batch(pmodel, x), rtol=1e-12, atol=1e-14)


def test_logits_mode_skips_final_activation(tmp_path):
    model = _port_model(random_model([6, 4, 3], seed=10), tmp_path)
    params = fcnn.params_from_spec(model, dtype=torch.float64, device="cpu")
    x = torch.from_numpy(random_inputs(4, 6))
    logits = fcnn.forward_logits(params, x)
    np.testing.assert_allclose(
        torch.softmax(logits, -1).numpy(), fcnn.forward(params, x).numpy(), rtol=1e-12
    )


def test_oracle_matches_jax_oracle_and_rejects_dim_mismatch(tmp_path):
    jmodel = random_model([8, 6, 5, 3], ["tanh", "gelu", "softmax"], seed=3)
    model = _port_model(jmodel, tmp_path)
    x = random_inputs(4, 8)
    np.testing.assert_allclose(oracle_forward_batch(model, x), jax_oracle_batch(jmodel, x),
                               rtol=1e-12, atol=1e-15)
    with pytest.raises(ValueError, match="Dimension mismatch"):
        oracle_forward(model, np.zeros(7))


def test_params_from_jax_round_trip():
    jparams = jax_fcnn.init_fcnn(jax.random.key(0), [10, 8, 6, 3],
                                 activations=["relu", "sigmoid", "softmax"])
    params = fcnn.params_from_jax(jparams, device="cpu")
    assert [p["act"] for p in params] == [1, 2, 3]
    for p, jp in zip(params, jparams):
        np.testing.assert_array_equal(p["w"].numpy(), np.asarray(jp["w"]))
        np.testing.assert_array_equal(p["b"].numpy(), np.asarray(jp["b"]))
    acts = ["relu", "sigmoid", "softmax"]
    spec = fcnn.spec_from_params(params, acts)
    jspec = jax_fcnn.spec_from_params(jparams, acts)
    assert spec.to_json_dict() == jspec.to_json_dict()
    x = np.random.default_rng(0).normal(size=(7, 10)).astype(np.float32)
    want = np.asarray(jax_fcnn.forward(jparams, jnp.asarray(x)))
    got = fcnn.forward(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_init_fcnn_seeded_he_init():
    a = fcnn.init_fcnn(torch.Generator().manual_seed(3), [400, 300, 10], device="cpu")
    b = fcnn.init_fcnn(torch.Generator().manual_seed(3), [400, 300, 10], device="cpu")
    assert [p["act"] for p in a] == [1, 3]
    assert torch.equal(a[0]["w"], b[0]["w"]) and torch.equal(a[1]["w"], b[1]["w"])
    assert a[0]["w"].shape == (400, 300) and not a[0]["b"].any()
    assert abs(float(a[0]["w"].std()) - (2.0 / 400) ** 0.5) < 0.005
    with pytest.raises(ValueError, match="need 2 activations"):
        fcnn.init_fcnn(torch.Generator(), [4, 3, 2], ["relu"], device="cpu")


def test_schema_round_trips_with_the_jax_package(tmp_path):
    jmodel = random_model([5, 4, 2], seed=1)
    jmodel.metadata["layer_distribution"] = [1, 1]
    model = _port_model(jmodel, tmp_path)
    assert model.layer_sizes == jmodel.layer_sizes
    assert model.metadata == jmodel.metadata
    back = tmp_path / "back.json"
    pt_schema.save_model(model, back)
    assert jax_schema.load_model(back).to_json_dict() == jmodel.to_json_dict()

    x = random_inputs(3, 5)
    y = np.array([0, 1, -1])
    ex = tmp_path / "ex.json"
    pt_schema.save_examples(x, y, ex)
    jx, jy = jax_schema.load_examples(ex)
    px, py = pt_schema.load_examples(ex)
    np.testing.assert_array_equal(px, jx)
    np.testing.assert_array_equal(py, jy)

    stages = pt_schema.partition_model(model, [0, 2])
    jstages = jax_schema.partition_model(jmodel, [0, 2])
    assert [s.to_stage_json() for s in stages] == [s.to_stage_json() for s in jstages]
    assert [s.port for s in stages] == [s.port for s in jstages]
    with pytest.raises(ValueError, match="sum"):
        pt_schema.partition_model(model, [1])


def test_schema_rejects_conv_layers_not_yet_ported():
    # Conv and pool layers are ported now: a conv object with no weights
    # is rejected as the JAX schema rejects it, and a whole one loads.
    obj = {"layers": [{"type": "conv2d", "in_shape": [4, 4, 1]}]}
    with pytest.raises(KeyError, match="weights"):
        jax_schema.ModelSpec.from_json_dict(obj)
    with pytest.raises(KeyError, match="weights"):
        pt_schema.ModelSpec.from_json_dict(obj)
    obj["layers"][0].update(weights=np.zeros((3, 3, 1, 2)).tolist(), bias=[0.0, 0.0])
    model = pt_schema.ModelSpec.from_json_dict(obj)
    assert model.layers[0].kind == "conv2d" and not model.is_dense
    assert model.to_json_dict() == jax_schema.ModelSpec.from_json_dict(obj).to_json_dict()


@pytest.mark.parametrize("drop", [False, True])
def test_batch_iterator_matches_jax(drop):
    x = np.arange(50).reshape(25, 2)
    y = np.arange(25)
    got = list(batch_iterator(x, y, batch_size=8, drop_remainder=drop))
    want = list(jax_batch_iterator(x, y, batch_size=8, drop_remainder=drop))
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_metrics_and_latency_stats_match_jax():
    rng = np.random.default_rng(4)
    probs = rng.uniform(size=(40, 5))
    labels = rng.integers(0, 5, 40)
    assert classification_metrics(probs, labels) == jax_metrics(probs, labels)
    samples = list(rng.uniform(0, 1, 30))
    got = LatencyStats("s", list(samples), window=20).summary()
    assert got == JaxLatencyStats("s", list(samples), window=20).summary()


def test_resolve_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(UnavailableError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(UnavailableError):
        fcnn.init_fcnn(torch.Generator(), [3, 2])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(InvalidArgumentError):
        resolve_device("meta")
