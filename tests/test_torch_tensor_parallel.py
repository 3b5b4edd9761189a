"""The Megatron split over CPU model slots against the JAX package's.

The same seeded params and tokens go through the JAX functions on
conftest's 8 virtual host devices and through the port's on
``devices=["cpu"] * n``. Tolerances are ``tests/test_tensor_parallel.py``'s
(forward atol 3e-4 / rtol 1e-3 against the single chip, remat grads rtol
1e-5 / atol 1e-6) and the roundtrip is bit for bit; the port is also held
to JAX's TP forward at rtol 2e-5. The collectives' fixed-order sum is
checked directly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist_nn.models.fcnn import forward as jax_fcnn_forward
from tpu_dist_nn.models.fcnn import init_fcnn as jax_init_fcnn
from tpu_dist_nn.models.transformer import TransformerConfig as JaxConfig
from tpu_dist_nn.models.transformer import forward as jax_forward
from tpu_dist_nn.models.transformer import init_transformer as jax_init
from tpu_dist_nn.parallel import tensor_parallel as jtp
from tpu_dist_nn.parallel.mesh import MeshSpec as JaxMeshSpec
from tpu_dist_nn.parallel.mesh import build_mesh as jax_build_mesh
from tpu_dist_nn_torch.models.fcnn import params_from_jax as fcnn_from_jax
from tpu_dist_nn_torch.models.transformer import (
    TransformerConfig,
    forward,
    param_leaves,
    transformer_params_from_jax,
)
from tpu_dist_nn_torch.parallel.collectives import all_gather, fan_out, psum
from tpu_dist_nn_torch.parallel.mesh import MeshSpec, StageSlot, build_mesh
from tpu_dist_nn_torch.parallel.tensor_parallel import (
    TP_REPLICATED,
    make_tp_fcnn_forward,
    make_tp_lm_forward,
    tp_shard_blocks,
    tp_shard_fcnn,
    tp_unshard_blocks,
)

torch.set_num_threads(1)
SHAPE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=3, d_ff=64, max_seq_len=32)
JCFG, CFG = JaxConfig(**SHAPE), TransformerConfig(**SHAPE)


def _both(seed, cfg=JCFG):
    jparams = jax_init(jax.random.key(seed), cfg)
    return jparams, transformer_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _tokens(batch=4, t=16, seed=0):
    return np.random.default_rng(seed).integers(0, SHAPE["vocab_size"], (batch, t)).astype(np.int32)


def _cpu_mesh(**axes):
    spec = MeshSpec(**axes)
    return build_mesh(spec, ["cpu"] * spec.num_devices)


@pytest.mark.parametrize("n", [2, 4])
def test_shard_equals_jax_and_roundtrips_bit_for_bit(n):
    jparams, params = _both(0)
    staged = tp_shard_blocks(params["blocks"], CFG, n)
    jstaged = jtp.tp_shard_blocks(jparams["blocks"], JCFG, n)
    for k, v in staged.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jstaged[k]), err_msg=k)
        assert (k in TP_REPLICATED) == (k in jtp.TP_REPLICATED)
    back = tp_unshard_blocks(staged, CFG)
    for k, v in params["blocks"].items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("model,data", [(2, 1), (4, 1), (2, 2)])
def test_forward_matches_jax_and_the_single_program(model, data):
    jparams, params = _both(1)
    tokens = _tokens()
    jmesh = jax_build_mesh(JaxMeshSpec(model=model, data=data))
    jfwd = jtp.make_tp_lm_forward(jmesh, JCFG)
    jtp_params = dict(jparams, blocks=jtp.tp_shard_blocks(jparams["blocks"], JCFG, model))
    want = np.asarray(jax.jit(jfwd)(jtp_params, jnp.asarray(tokens)))
    fwd = make_tp_lm_forward(_cpu_mesh(model=model, data=data), CFG)
    got = fwd(dict(params, blocks=tp_shard_blocks(params["blocks"], CFG, model)),
              torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    single = np.asarray(jax_forward(jparams, jnp.asarray(tokens), JCFG))
    np.testing.assert_allclose(got, single, atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(got, forward(params, torch.from_numpy(tokens), CFG).numpy(),
                               atol=3e-4, rtol=1e-3)


def test_indivisible_heads_and_ffn_raise_like_jax():
    _, params = _both(0)
    with pytest.raises(ValueError, match="n_heads"):
        tp_shard_blocks(params["blocks"], CFG, 3)
    cfg = dataclasses.replace(CFG, n_heads=8, d_ff=60)
    with pytest.raises(ValueError, match="d_ff"):
        tp_shard_blocks({"w_qkv": torch.zeros(1, 32, 96)}, cfg, 8)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_gradients_match_jax(remat):
    """``tests/test_tensor_parallel.py::test_tp_remat_grads_match``'s
    loss (mean squared logits) through both packages, with and without
    remat, at model 2 x data 2."""
    cfg_j, cfg_p = (dataclasses.replace(c, remat=remat) for c in (JCFG, CFG))
    jparams, params = _both(2)
    tokens = _tokens(seed=3)
    jmesh = jax_build_mesh(JaxMeshSpec(model=2, data=2))
    jfwd = jtp.make_tp_lm_forward(jmesh, cfg_j)
    jtp_params = dict(jparams, blocks=jtp.tp_shard_blocks(jparams["blocks"], JCFG, 2))
    jgrads = jax.jit(jax.grad(lambda p, t: jnp.mean(jfwd(p, t) ** 2)))(
        jtp_params, jnp.asarray(tokens))
    fwd = make_tp_lm_forward(_cpu_mesh(model=2, data=2), cfg_p)
    ptp = dict(params, blocks=tp_shard_blocks(params["blocks"], CFG, 2))
    leaves = [t.requires_grad_() for t in param_leaves(ptp)]
    loss = torch.mean(fwd(ptp, torch.from_numpy(tokens)) ** 2)
    grads = torch.autograd.grad(loss, leaves)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=5e-4, atol=1e-5)
    assert all(bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0 for g in grads)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_fcnn_column_split_matches_jax_on_ragged_widths(n):
    acts = ["relu", "relu", "softmax"]
    jparams = jax_init_fcnn(jax.random.key(0), [784, 128, 64, 10], activations=acts)
    x = np.random.default_rng(0).normal(size=(8, 784)).astype(np.float32)
    jtp_params, jdims = jtp.tp_shard_fcnn(jparams, n)
    want = np.asarray(jtp.make_tp_fcnn_forward(jax_build_mesh(JaxMeshSpec(model=n)), jdims)(
        jtp_params, jnp.asarray(x)))
    params = fcnn_from_jax(jparams, device="cpu")
    ptp, dims = tp_shard_fcnn(params, n)
    assert dims == jdims
    for p, jp in zip(ptp, jtp_params):
        np.testing.assert_array_equal(p["w"].numpy(), np.asarray(jp["w"]))
        np.testing.assert_array_equal(p["b"].numpy(), np.asarray(jp["b"]))
    got = make_tp_fcnn_forward(_cpu_mesh(model=n), dims)(ptp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_fcnn_forward(jparams, jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)


def test_collectives_sum_in_shard_order_and_gather_in_order():
    slots = [StageSlot(torch.device("cpu"), None)] * 3
    parts = [torch.tensor([1e8, 1.0]), torch.tensor([-1e8, 1.0]), torch.tensor([1.0, 1e-8])]
    total = psum(parts, slots)
    want = (parts[0] + parts[1]) + parts[2]
    assert torch.equal(total, want)
    assert torch.equal(all_gather(parts, slots), torch.cat(parts))
    x = torch.ones(2, requires_grad=True)
    outs = fan_out(x, slots)
    assert len(outs) == 3 and all(o.data_ptr() == x.data_ptr() for o in outs)
    torch.autograd.backward(psum([o * (m + 1) for m, o in enumerate(outs)], slots).sum())
    assert torch.equal(x.grad, torch.full((2,), 6.0))  # the fanned-out grads add up
