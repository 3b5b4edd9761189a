"""Dense runs past one chain launch: the port's cut against the JAX Engine.

A chain kernel launch takes at most 32 layers, and its interior rows
must fit a block's shared memory. :func:`chain_segments` cuts a run at
those limits (a wide softmax tail goes to ``fused_dense``) and the
Engine serves every segment. Here, on the CPU, the cut itself is
checked, and the port's ``Engine.up(..., device="cpu")`` is held against
the JAX ``Engine`` on the same model file and numpy-seeded rows at the
tolerances of ``tests/test_torch_engine.py``'s parity test (f32 atol
1e-6 / rtol 1e-5; int8 atol 1e-7 / rtol 1e-6, with the JAX engine's
int8 auto-disable pinned off as there). On the card the same models
run in ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from tpu_dist_nn.api.engine import Engine as JaxEngine
from tpu_dist_nn.core.schema import save_model
from tpu_dist_nn.testing.factories import random_inputs, random_model
from tpu_dist_nn_torch.api.engine import Engine
from tpu_dist_nn_torch.kernels import (
    KERNEL_WRAPPERS,
    fcnn_fused_forward,
    fcnn_fused_forward_plain,
    fcnn_quantized_forward,
    forward_quantized,
    quantize_fcnn,
    reset_launch_counts,
)
from tpu_dist_nn_torch.kernels.fused_dense import (
    MAX_LAYERS,
    SMEM_LIMIT_BYTES,
    Segment,
    activation_ids,
    chain_plan,
    chain_segments,
    int8_plan,
)
from tpu_dist_nn_torch.models.fcnn import params_from_spec
from tpu_dist_nn_torch.models.network import dense_forward
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

torch.set_num_threads(1)

RELU, SOFTMAX = activation_ids(["relu", "softmax"])


@pytest.fixture(autouse=True)
def _pin_int8_serving(monkeypatch):
    monkeypatch.setenv("TDN_INT8_AUTO", "0")


def _acts(n, last=SOFTMAX):
    return (RELU,) * (n - 1) + (last,)


# ------------------------------------------------------------- the cut

@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_chain_segments_cut_at_32_layers(dtype):
    assert chain_segments([16] * 35, _acts(34), dtype) == (Segment(0, 32), Segment(32, 34))
    assert chain_segments([16] * 33, _acts(32), dtype) == (Segment(0, 32),)
    assert chain_segments([16] * 66, _acts(65), dtype) == (
        Segment(0, 32), Segment(32, 64), Segment(64, 65))
    assert chain_segments([784, 128, 64, 10], _acts(3), dtype) == (Segment(0, 3),)


def test_chain_segments_cut_at_every_unfit_boundary():
    # f32: 8 rows of a 4000- or 8192-wide interior and the ring are over
    # 227 KB (232,960 and 367,104 bytes): each wide boundary ends a chain
    # and the next chain streams it as its input.
    assert chain_segments([784, 4000, 10], _acts(2)) == (Segment(0, 1), Segment(1, 2))
    assert chain_segments([64, 8192, 10], _acts(2)) == (Segment(0, 1), Segment(1, 2))
    # 8 rows of 3000 floats fit beside the ring, of 5000 not: one cut.
    assert chain_segments([64, 3000, 32, 5000, 16, 10], _acts(5)) == (
        Segment(0, 3), Segment(3, 5))
    for dims in ([784, 4000, 10], [64, 8192, 10]):
        with pytest.raises(InvalidArgumentError, match=str(SMEM_LIMIT_BYTES)):
            chain_plan(dims, _acts(2), 8)
    # int8: 16 rows of a 60000-wide interior (f32 and codes) do not fit;
    # a 60000-wide input streams and is not cut.
    assert chain_segments([64, 60000, 10], _acts(2), "int8") == (Segment(0, 1), Segment(1, 2))
    assert chain_segments([60000, 16, 10], _acts(2), "int8") == (Segment(0, 2),)
    assert chain_segments([3000, 2000, 10], _acts(2), "int8") == (Segment(0, 2),)
    with pytest.raises(InvalidArgumentError, match=str(SMEM_LIMIT_BYTES)):
        int8_plan([64, 60000, 10], 8)
    # Every segment the cut makes is launchable.
    for dims, dtype in (([784, 4000, 10], "float32"), ([64, 60000, 10], "int8"),
                        ([64, 3000, 32, 5000, 16, 10], "float32")):
        acts = _acts(len(dims) - 1)
        for seg in chain_segments(dims, acts, dtype):
            sub = dims[seg.start:seg.stop + 1]
            if dtype == "int8":
                assert int8_plan(sub, 8192).smem_bytes <= SMEM_LIMIT_BYTES
            else:
                plan = chain_plan(sub, acts[seg.start:seg.stop], 8192)
                assert plan.smem_bytes <= SMEM_LIMIT_BYTES


def test_chain_segments_send_a_wide_softmax_tail_to_fused_dense():
    # A softmax row the f32 chain cannot hold (60000 floats, 8 rows) in a
    # one-layer segment runs as fused_dense; relu at that width streams
    # out of the chain's epilogue and needs no residency.
    assert chain_segments([64, 60000], (SOFTMAX,)) == (Segment(0, 1, dense=True),)
    assert chain_segments([32, 64, 60000], (RELU, SOFTMAX)) == (
        Segment(0, 1), Segment(1, 2, dense=True))
    assert chain_segments([64, 60000], (RELU,)) == (Segment(0, 1),)
    # The int8 chain takes the last layer's softmax over device memory.
    assert chain_segments([32, 64, 60000], (RELU, SOFTMAX), "int8") == (Segment(0, 2),)
    with pytest.raises(InvalidArgumentError, match="dtype"):
        chain_segments([4, 4], (RELU,), "bfloat16")


def test_dense_forward_runs_each_segment_and_a_cut_int8_run_is_bit_equal():
    rng = np.random.default_rng(4)
    model = random_model([32, 64, 60000], ["relu", "softmax"], seed=4)
    params = params_from_spec(_port_spec(model), device="cpu")
    x = torch.from_numpy(rng.uniform(0, 1, (3, 32)).astype(np.float32))
    torch.testing.assert_close(dense_forward(params, x), fcnn_fused_forward_plain(params, x),
                               atol=1e-6, rtol=1e-5)
    deep = params_from_spec(_port_spec(random_model([16] * 35, seed=5)), device="cpu")
    q = quantize_fcnn(deep)
    x16 = torch.from_numpy(rng.uniform(0, 1, (5, 16)).astype(np.float32))
    assert torch.equal(dense_forward(q, x16, quantized=True), forward_quantized(q, x16))


def _port_spec(jax_model):
    from tpu_dist_nn_torch.core.schema import ModelSpec
    return ModelSpec.from_json_dict(jax_model.to_json_dict())


# -------------------------------------------------- the port's Engine vs JAX

_ENGINE_CASES = {
    "34-layers-f32": ([16] * 35, None, 40, 16),
    "34-layers-int8": ([16] * 35, "int8", 40, 16),
    "784-4000-10-f32": ([784, 4000, 10], None, 24, 8),
    "64-8192-10-f32": ([64, 8192, 10], None, 24, 8),
    "60000-16-10-int8": ([60000, 16, 10], "int8", 6, 4),
    "64-60000-10-int8": ([64, 60000, 10], "int8", 6, 4),
}


@pytest.mark.parametrize("case", list(_ENGINE_CASES))
def test_engine_serves_past_one_chain_like_the_jax_engine(case, tmp_path):
    sizes, quantize, rows, batch = _ENGINE_CASES[case]
    path = tmp_path / "model.json"
    save_model(random_model(sizes, seed=len(sizes)), path)
    x = random_inputs(rows, sizes[0], seed=3)
    labels = np.random.default_rng(4).integers(0, sizes[-1], rows)
    want = JaxEngine.up(path, [len(sizes) - 1], quantize=quantize).run_inference(
        x, labels, batch_size=batch)
    reset_launch_counts()
    eng = Engine.up(path, device="cpu", quantize=quantize)
    got = eng.run_inference(x, labels, batch_size=batch)
    atol, rtol = (1e-7, 1e-6) if quantize else (1e-6, 1e-5)
    assert got.outputs.shape == (rows, sizes[-1])
    np.testing.assert_allclose(got.outputs, want.outputs, atol=atol, rtol=rtol)
    assert got.metrics == want.metrics
    assert [fn.launches for fn in KERNEL_WRAPPERS] == [0] * len(KERNEL_WRAPPERS)


# ----------------------------------------- CPU tensors: no plan, no limit

def test_cpu_tensors_take_no_plan_and_no_shared_memory_limit():
    rng = np.random.default_rng(8)

    def params(sizes):
        return params_from_spec(_port_spec(random_model(sizes, seed=sum(sizes))), device="cpu")

    # Past 8 resident f32 rows: the plain version runs, no plan is taken.
    for sizes in ([784, 4000, 10], [64, 8192, 10]):
        p = params(sizes)
        x = torch.from_numpy(rng.uniform(0, 1, (3, sizes[0])).astype(np.float32))
        torch.testing.assert_close(fcnn_fused_forward(p, x), fcnn_fused_forward_plain(p, x),
                                   atol=0, rtol=0)
    # A 60000-wide int8 input or interior on the CPU is the plain chain.
    for sizes in ([60000, 16, 10], [64, 60000, 10]):
        q = quantize_fcnn(params(sizes))
        x = torch.from_numpy(rng.uniform(0, 1, (2, sizes[0])).astype(np.float32))
        assert torch.equal(fcnn_quantized_forward(q, x), forward_quantized(q, x))
    # The wrappers' own layer limit stands: a 34-layer chain is refused
    # by one launch, served by the Engine's cut.
    deep = params([16] * 35)
    with pytest.raises(InvalidArgumentError, match=f"1..{MAX_LAYERS} layers"):
        fcnn_fused_forward(deep, torch.zeros(2, 16))
    with pytest.raises(InvalidArgumentError, match=f"1..{MAX_LAYERS} layers"):
        fcnn_quantized_forward(quantize_fcnn(deep), torch.zeros(2, 16))
