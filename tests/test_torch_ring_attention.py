"""Ring and Ulysses attention and the sequence-parallel LM over CPU seq
slots, against the JAX package's, on the CPU.

The same seeded inputs and params go through the JAX functions on
conftest's 8 virtual host devices (``shard_map`` over the ``seq`` axis)
and through the port's on ``devices=["cpu"] * n`` meshes of seq (and
data) slots. Tolerances are ``tests/test_ring_attention.py``'s and
``tests/test_pipeline_sp.py``'s: the ring against full attention atol
2e-5 / rtol 1e-4, its gradients atol 5e-5 / rtol 1e-3, the LM forward
atol 3e-4 / rtol 1e-3, Ulysses rtol 2e-5 / atol 1e-6 and its gradients
rtol 5e-4 / atol 1e-6, the loss 1e-4 absolute, remat gradients rtol 1e-5
/ atol 1e-6; both rotate modes bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpu_dist_nn.models.transformer import TransformerConfig as JaxConfig
from tpu_dist_nn.models.transformer import dot_product_attention as jax_attention
from tpu_dist_nn.models.transformer import forward as jax_forward
from tpu_dist_nn.models.transformer import init_transformer as jax_init
from tpu_dist_nn.parallel import ring_attention as jra
from tpu_dist_nn.parallel.mesh import AXIS_SEQ
from tpu_dist_nn.parallel.mesh import MeshSpec as JaxMeshSpec
from tpu_dist_nn.parallel.mesh import build_mesh as jax_build_mesh
from tpu_dist_nn_torch.models.transformer import (
    TransformerConfig,
    dot_product_attention,
    forward,
    masked_next_token_ce,
    param_leaves,
    transformer_params_from_jax,
    tree_map,
)
from tpu_dist_nn_torch.parallel import ring_attention as ra
from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh

torch.set_num_threads(1)
SHAPE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=64)
RING_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-5, rtol=1e-3)


def _qkv(b=2, t=32, h=4, dh=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, t, h, dh)).astype(np.float32) for _ in range(3))


def _shards(a, n, grad=False):
    t = torch.from_numpy(a)
    if grad:
        t.requires_grad_()
    return t, list(t.chunk(n, dim=1))


def _jax_ring(n, q, k, v, causal, **kw):
    fn = jax.shard_map(functools.partial(jra.ring_attention, causal=causal, **kw),
                       mesh=jax_build_mesh(JaxMeshSpec(seq=n)),
                       in_specs=(P(None, AXIS_SEQ),) * 3, out_specs=P(None, AXIS_SEQ))
    return fn(*map(jnp.asarray, (q, k, v)))


def _slots(n, data=1):
    return build_mesh(MeshSpec(seq=n, data=data), ["cpu"] * (n * data))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq", [2, 4, 8])
def test_ring_matches_jax_ring_and_full_attention(causal, seq):
    q, k, v = _qkv()
    want = np.asarray(jax_attention(*map(jnp.asarray, (q, k, v)), causal=causal))
    jring = np.asarray(jax.jit(lambda *a: _jax_ring(seq, *a, causal))(q, k, v))
    slots = _slots(seq).seq_leads(0, 0)
    got = torch.cat(ra.ring_attention(*(_shards(a, seq)[1] for a in (q, k, v)), slots,
                                      causal=causal), dim=1).numpy()
    np.testing.assert_allclose(got, want, **RING_TOL)
    np.testing.assert_allclose(got, jring, **RING_TOL)


def test_single_slot_degenerates_to_full_attention():
    q, k, v = _qkv(t=16)
    want = dot_product_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    got = ra.ring_attention(*([torch.from_numpy(a)] for a in (q, k, v)), causal=True)
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), **RING_TOL)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_gradients_match_jax_full_attention(mode):
    """d(sum(out**2))/d(q, k, v) through the seq slots (seq 4) against
    ``jax.grad`` through the JAX package's full attention."""
    q, k, v = _qkv(t=16)

    def full_loss(q, k, v):
        return jnp.sum(jax_attention(q, k, v, causal=True) ** 2)

    want = jax.jit(jax.grad(full_loss, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    leaves, parts = zip(*(_shards(a, 4, grad=True) for a in (q, k, v)))
    attn = ra.ring_attention if mode == "ring" else ra.ulysses_attention
    out = attn(*parts, _slots(4).seq_leads(0, 0), causal=True)
    grads = torch.autograd.grad(sum((o ** 2).sum() for o in out), leaves)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_both_rotate_modes_give_the_same_bits_and_unknown_modes_raise():
    q, k, v = _qkv(t=16, seed=21)
    slots = _slots(4).seq_leads(0, 0)
    outs = [torch.cat(ra.ring_attention(*(_shards(a, 4)[1] for a in (q, k, v)), slots,
                                        causal=True, rotate=r), dim=1)
            for r in ra.ROTATE_MODES]
    assert torch.equal(outs[0], outs[1])
    want = np.asarray(jax_attention(*map(jnp.asarray, (q, k, v)), causal=True))
    np.testing.assert_allclose(outs[0].numpy(), want, rtol=2e-5, atol=2e-5)
    jq = jnp.asarray(q)
    with pytest.raises(ValueError, match="rotate mode") as jerr:
        jra.ring_attention(jq, jq, jq, causal=True, rotate="bogus")
    with pytest.raises(ValueError, match="rotate mode") as err:
        ra.ring_attention([torch.from_numpy(q)], [torch.from_numpy(k)], [torch.from_numpy(v)],
                          causal=True, rotate="bogus")
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="sequence-parallel mode"):
        ra._sp_attn_fn("bogus")


def _cfgs(**over):
    shape = dict(SHAPE, **over)
    return JaxConfig(**shape), TransformerConfig(**shape)


def _both(seed, jcfg):
    jparams = jax_init(jax.random.key(seed), jcfg)
    return jparams, transformer_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _tokens(batch, t, seed, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (batch, t)).astype(np.int32)


@pytest.mark.parametrize("seq,data", [(4, 1), (2, 2), (2, 4)])
def test_sp_forward_matches_jax_and_the_single_program(seq, data):
    jcfg, cfg = _cfgs()
    jparams, params = _both(0, jcfg)
    tokens = _tokens(4, 32, 0)
    jfwd = jra.make_seq_parallel_lm_forward(jax_build_mesh(JaxMeshSpec(seq=seq, data=data)), jcfg)
    want = np.asarray(jax.jit(jfwd)(jparams, jnp.asarray(tokens)))
    got = ra.make_seq_parallel_lm_forward(_slots(seq, data), cfg)(params, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4, rtol=1e-3)
    single = forward(params, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=3e-4, rtol=1e-3)


def test_sp_forward_refuses_rows_it_cannot_split_or_place_as_jax_does():
    jcfg, cfg = _cfgs()
    jparams, params = _both(0, jcfg)
    jfwd = jra.make_seq_parallel_lm_forward(jax_build_mesh(JaxMeshSpec(seq=4)), jcfg)
    fwd = ra.make_seq_parallel_lm_forward(_slots(4), cfg)
    for t in (30, 68):  # not divisible by 4; past the 64-row position table
        tokens = np.zeros((2, t), np.int32)
        with pytest.raises(ValueError) as jerr:
            jfwd(jparams, jnp.asarray(tokens))
        with pytest.raises(ValueError) as err:
            fwd(params, torch.from_numpy(tokens))
        assert str(err.value) == str(jerr.value)


def test_sp_loss_matches_jax_and_the_masked_single_program():
    jcfg, cfg = _cfgs()
    jparams, params = _both(1, jcfg)
    tokens = _tokens(4, 32, 1)
    jmesh = jax_build_mesh(JaxMeshSpec(seq=4, data=2))
    want = float(jra.make_seq_parallel_lm_loss(jmesh, jcfg)(jparams, jnp.asarray(tokens)))
    got = float(ra.make_seq_parallel_lm_loss(_slots(4, 2), cfg)(params, torch.from_numpy(tokens)))
    single = float(masked_next_token_ce(forward(params, torch.from_numpy(tokens), cfg),
                                        torch.from_numpy(tokens)))
    assert abs(got - want) < 1e-4 and abs(got - single) < 1e-4


def _jax_masked_ce(jcfg):
    def loss(p, t):
        logits = jax_forward(p, t, jcfg)
        logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, t[:, 1:][..., None], axis=-1)[..., 0])

    return loss


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sp_loss_gradients_match_jax(mode):
    """tests/test_ring_attention.py::test_ulysses_grads_match_single_chip's
    shape (seq 2 x data 2), both modes: the JAX sp loss's gradients."""
    jcfg, cfg = _cfgs(vocab_size=23, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_seq_len=17)
    jparams, params = _both(1, jcfg)
    rows = _tokens(4, 16, 1, vocab=23)
    jloss = jra.make_seq_parallel_lm_loss(jax_build_mesh(JaxMeshSpec(seq=2, data=2)), jcfg,
                                          mode=mode)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams, jnp.asarray(rows))
    rl, _ = jax.jit(jax.value_and_grad(_jax_masked_ce(jcfg)))(jparams, jnp.asarray(rows))
    p = tree_map(lambda a: a.clone().requires_grad_(), params)
    loss = ra.make_seq_parallel_lm_loss(_slots(2, 2), cfg, mode)(p, torch.from_numpy(rows))
    grads = torch.autograd.grad(loss, param_leaves(p))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(rl), rtol=1e-5)
    for g, w in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4, atol=1e-6)


def test_ulysses_forward_matches_jax():
    jcfg, cfg = _cfgs(vocab_size=23, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_seq_len=16)
    jparams, params = _both(0, jcfg)
    tokens = _tokens(4, 16, 0, vocab=23)
    want = jra.make_seq_parallel_lm_forward(jax_build_mesh(JaxMeshSpec(seq=2, data=2)), jcfg,
                                            mode="ulysses")(jparams, jnp.asarray(tokens))
    got = ra.make_seq_parallel_lm_forward(_slots(2, 2), cfg, "ulysses")(
        params, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-6)


def test_ulysses_refuses_indivisible_heads_with_jax_texts():
    jcfg, cfg = _cfgs(vocab_size=23, d_model=18, n_heads=3, n_layers=1, d_ff=24, max_seq_len=16)
    with pytest.raises(ValueError, match="divisible") as jerr:
        jra.make_seq_parallel_lm_forward(jax_build_mesh(JaxMeshSpec(seq=2, data=2)), jcfg,
                                         mode="ulysses")
    with pytest.raises(ValueError, match="divisible") as err:
        ra.make_seq_parallel_lm_forward(_slots(2, 2), cfg, "ulysses")
    assert str(err.value) == str(jerr.value)
    q = [torch.zeros(1, 4, 3, 6)] * 2
    with pytest.raises(ValueError, match=r"ulysses needs n_heads \(3\) divisible by the seq "
                                         r"axis \(2\)"):
        ra.ulysses_attention(q, q, q, causal=True)


def test_ring_remat_gradients_match_plain():
    """tests/test_ring_attention.py::test_ring_remat_grads_match: remat
    (one checkpoint a block across the seq slots) changes no gradient."""
    cfg = TransformerConfig(vocab_size=32, d_model=16, n_heads=2, n_layers=2, d_ff=32,
                            max_seq_len=16)
    _, params = _both(0, JaxConfig(**dataclasses.asdict(cfg)))
    tokens = torch.from_numpy(_tokens(4, 16, 0, vocab=32))
    grads = []
    for c in (cfg, dataclasses.replace(cfg, remat=True)):
        p = tree_map(lambda a: a.clone().requires_grad_(), params)
        loss = ra.make_seq_parallel_lm_loss(_slots(2, 4), c)(p, tokens)
        grads.append(torch.autograd.grad(loss, param_leaves(p)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
        assert np.isfinite(a.numpy()).all()
