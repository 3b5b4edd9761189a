"""Pipelined and tensor-parallel decoding over CPU slots, against the JAX
package's decoders and the port's single-program ``generate``.

Mirrors ``tests/test_generate.py:475-760``: greedy tokens bit-equal to
the JAX decoders and to the single program on every mesh; sampled tokens
equal to the single program's from a generator in the same state (every
overlapped group reads the same draws, as the JAX groups share one key
schedule; data shards take their rows of one draw); the argument
contract's refusals with the JAX texts.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist_nn.models.generate import generate as jax_generate
from tpu_dist_nn.models.transformer import TransformerConfig as JaxConfig
from tpu_dist_nn.models.transformer import init_transformer as jax_init
from tpu_dist_nn.parallel import pp_generate as jpp
from tpu_dist_nn.parallel.mesh import MeshSpec as JaxMeshSpec
from tpu_dist_nn.parallel.mesh import build_mesh as jax_build_mesh
from tpu_dist_nn.parallel.tensor_parallel import tp_shard_blocks as jax_tp_shard_blocks
from tpu_dist_nn.parallel.tp_generate import tp_generate as jax_tp_generate
from tpu_dist_nn.parallel.transformer_pipeline import shard_blocks as jax_shard_blocks
from tpu_dist_nn_torch.models.generate import generate
from tpu_dist_nn_torch.models.transformer import TransformerConfig, transformer_params_from_jax
from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
from tpu_dist_nn_torch.parallel.pp_generate import (
    make_pipeline_generate,
    make_pipeline_generate_overlapped,
)
from tpu_dist_nn_torch.parallel.tensor_parallel import tp_shard_blocks
from tpu_dist_nn_torch.parallel.tp_generate import tp_generate
from tpu_dist_nn_torch.parallel.transformer_pipeline import shard_blocks

torch.set_num_threads(1)
PP_SHAPE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_seq_len=24)
TP_SHAPE = dict(vocab_size=31, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_seq_len=24)


def _both(seed, shape):
    jcfg, cfg = JaxConfig(**shape), TransformerConfig(**shape)
    jparams = jax_init(jax.random.key(seed), jcfg)
    return jcfg, cfg, jparams, transformer_params_from_jax(jax.tree.map(np.asarray, jparams),
                                                           device="cpu")


def _mesh(stage=1, data=1, model=1):
    spec = MeshSpec(stage=stage, data=data, model=model)
    return build_mesh(spec, ["cpu"] * spec.num_devices)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _staged(params, stage):
    return dict(params, blocks=shard_blocks(params["blocks"], stage))


def _tp(params, cfg, n=2):
    return dict(params, blocks=tp_shard_blocks(params["blocks"], cfg, n))


# ----------------------------------------------------------- tp_generate


@pytest.mark.parametrize("n_new", [8, 1])
def test_tp_generate_greedy_equals_jax_and_the_single_program(n_new):
    jcfg, cfg, jparams, params = _both(7, TP_SHAPE)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 6)).astype(np.int32)
    jmesh = jax_build_mesh(JaxMeshSpec(model=2, data=2))
    want = np.asarray(jax_tp_generate(
        jmesh, dict(jparams, blocks=jax_tp_shard_blocks(jparams["blocks"], jcfg, 2)), jcfg,
        jnp.asarray(prompt), n_new))
    got = tp_generate(_mesh(model=2, data=2), _tp(params, cfg), cfg, torch.from_numpy(prompt),
                      n_new).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, generate(params, cfg, prompt, n_new).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jax_generate(jparams, jcfg, jnp.asarray(prompt), n_new)))


def test_tp_generate_sampled_equals_the_single_program_and_repeats():
    _, cfg, _, params = _both(7, TP_SHAPE)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    kw = dict(temperature=0.8, top_k=10)
    mesh, ptp = _mesh(model=2), _tp(params, cfg)
    a = tp_generate(mesh, ptp, cfg, torch.from_numpy(prompt), 6, generator=_gen(3), **kw)
    b = tp_generate(mesh, ptp, cfg, torch.from_numpy(prompt), 6, generator=_gen(3), **kw)
    assert torch.equal(a, b) and a.shape == (2, 6)
    assert bool(((a >= 0) & (a < cfg.vocab_size)).all())
    ref = generate(params, cfg, prompt, 6, generator=_gen(3), **kw)
    np.testing.assert_array_equal(a.numpy(), ref.numpy())


def test_tp_generate_data_shards_sample_independently():
    _, cfg, _, params = _both(7, TP_SHAPE)
    prompt = np.tile(np.asarray([[1, 2, 3, 4]], np.int32), (4, 1))
    out = tp_generate(_mesh(model=2, data=2), _tp(params, cfg), cfg, torch.from_numpy(prompt), 8,
                      temperature=1.0, generator=_gen(5)).numpy()
    assert not np.array_equal(out[0], out[2]) or not np.array_equal(out[1], out[3])


def test_tp_generate_refuses_what_jax_refuses():
    jcfg, cfg, jparams, params = _both(7, TP_SHAPE)
    jmesh = jax_build_mesh(JaxMeshSpec(model=2, data=2))
    jtp = dict(jparams, blocks=jax_tp_shard_blocks(jparams["blocks"], jcfg, 2))
    mesh, ptp = _mesh(model=2, data=2), _tp(params, cfg)
    bad = dataclasses.replace(cfg, n_heads=3, d_model=18, d_ff=36)
    with pytest.raises(ValueError, match="divisible"):
        tp_generate(mesh, ptp, bad, torch.zeros((2, 3), dtype=torch.long), 2)
    for kw in (dict(temperature=1.0, top_p=1.5), dict(temperature=0.0, top_k=3)):
        with pytest.raises(ValueError) as jerr:
            jax_tp_generate(jmesh, jtp, jcfg, jnp.zeros((2, 3), jnp.int32), 2,
                            key=jax.random.key(0), **kw)
        with pytest.raises(ValueError) as err:
            tp_generate(mesh, ptp, cfg, torch.zeros((2, 3), dtype=torch.long), 2,
                        generator=_gen(0), **kw)
        assert str(err.value) == str(jerr.value)


# ----------------------------------------------------- pipelined decoders


@pytest.mark.parametrize("stage,data", [(2, 2), (4, 1)])
def test_pipeline_generate_equals_jax_and_the_single_program(stage, data):
    jcfg, cfg, jparams, params = _both(51, PP_SHAPE)
    prompt = np.random.default_rng(52).integers(0, 64, (4, 8)).astype(np.int32)
    jfn = jpp.make_pipeline_generate(jax_build_mesh(JaxMeshSpec(stage=stage, data=data)), jcfg,
                                     stage, max_new_tokens=10)
    want = np.asarray(jfn(dict(jparams, blocks=jax_shard_blocks(jparams["blocks"], stage)),
                          jnp.asarray(prompt)))
    fn = make_pipeline_generate(_mesh(stage, data), cfg, stage, max_new_tokens=10)
    got = fn(_staged(params, stage), torch.from_numpy(prompt)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 8:], generate(params, cfg, prompt, 10).numpy())
    one = make_pipeline_generate(_mesh(stage, data), cfg, stage, max_new_tokens=1)
    np.testing.assert_array_equal(one(_staged(params, stage), torch.from_numpy(prompt))[:, 8:],
                                  generate(params, cfg, prompt, 1))


@pytest.mark.parametrize("stage,data", [(2, 2), (4, 1)])
def test_overlapped_equals_jax_and_each_group_alone(stage, data):
    jcfg, cfg, jparams, params = _both(61, PP_SHAPE)
    G, Bg, T, N = 4, 2, 8, 9
    prompts = np.random.default_rng(62).integers(0, 64, (G, Bg, T)).astype(np.int32)
    jfn = jpp.make_pipeline_generate_overlapped(
        jax_build_mesh(JaxMeshSpec(stage=stage, data=data)), jcfg, stage, N, G)
    want = np.asarray(jfn(dict(jparams, blocks=jax_shard_blocks(jparams["blocks"], stage)),
                          jnp.asarray(prompts)))
    fn = make_pipeline_generate_overlapped(_mesh(stage, data), cfg, stage, N, G)
    got = fn(_staged(params, stage), torch.from_numpy(prompts)).numpy()
    assert got.shape == (G, Bg, T + N)
    np.testing.assert_array_equal(got, want)
    for g in range(G):
        np.testing.assert_array_equal(got[g, :, T:], generate(params, cfg, prompts[g], N).numpy(),
                                      err_msg=str(g))


def test_overlapped_refuses_fewer_groups_than_stages_and_decodes_one_token():
    jcfg, cfg, jparams, params = _both(61, PP_SHAPE)
    with pytest.raises(ValueError) as jerr:
        jpp.make_pipeline_generate_overlapped(jax_build_mesh(JaxMeshSpec(stage=4)), jcfg, 4, 5,
                                              num_groups=2)
    with pytest.raises(ValueError) as err:
        make_pipeline_generate_overlapped(_mesh(4), cfg, 4, 5, num_groups=2)
    assert str(err.value) == str(jerr.value)
    prompts = np.random.default_rng(3).integers(0, 64, (4, 2, 8)).astype(np.int32)
    out = make_pipeline_generate_overlapped(_mesh(4), cfg, 4, 1, num_groups=4)(
        _staged(params, 4), torch.from_numpy(prompts))
    for g in range(4):
        np.testing.assert_array_equal(out[g, :, 8:], generate(params, cfg, prompts[g], 1))


def test_pipelined_sampling_equals_the_single_program():
    _, cfg, _, params = _both(71, PP_SHAPE)
    G, Bg, T, N = 2, 2, 8, 7
    prompts = np.random.default_rng(72).integers(0, 64, (G, Bg, T)).astype(np.int32)
    kw = dict(temperature=1.0, top_k=8)
    refs = [generate(params, cfg, prompts[g], N, generator=_gen(9), **kw).numpy()
            for g in range(G)]
    staged = _staged(params, 2)
    for data in (1, 2):
        fn = make_pipeline_generate(_mesh(2, data), cfg, 2, N, **kw)
        for g in range(G):
            out = fn(staged, torch.from_numpy(prompts[g]), generator=_gen(9)).numpy()
            np.testing.assert_array_equal(out[:, T:], refs[g], err_msg=f"{data} {g}")
    fno = make_pipeline_generate_overlapped(_mesh(2), cfg, 2, N, num_groups=G, **kw)
    out = fno(staged, torch.from_numpy(prompts), generator=_gen(9)).numpy()
    for g in range(G):
        np.testing.assert_array_equal(out[g, :, T:], refs[g], err_msg=str(g))
    with pytest.raises(ValueError, match="PRNG key"):
        fn(staged, torch.from_numpy(prompts[0]))


def test_pipelined_data_shards_sample_independently():
    _, cfg, _, params = _both(81, PP_SHAPE)
    staged, mesh = _staged(params, 2), _mesh(2, 2)
    prompt = np.tile(np.asarray([[3, 1, 4, 1, 5, 9]], np.int32), (4, 1))
    out = make_pipeline_generate(mesh, cfg, 2, 8, temperature=1.0)(
        staged, torch.from_numpy(prompt), generator=_gen(5)).numpy()
    assert not np.array_equal(out[0], out[2]) or not np.array_equal(out[1], out[3])
    prompts = np.tile(np.asarray([[2, 7, 1, 8, 2, 8]], np.int32), (2, 4, 1))
    outo = make_pipeline_generate_overlapped(mesh, cfg, 2, 8, num_groups=2, temperature=1.0)(
        staged, torch.from_numpy(prompts), generator=_gen(5)).numpy()
    assert not np.array_equal(outo[0, 0], outo[0, 2]) or not np.array_equal(outo[0, 1],
                                                                             outo[0, 3])


def test_pipelined_decoders_share_the_validator_contract():
    jcfg, cfg, jparams, params = _both(51, PP_SHAPE)
    jstaged = dict(jparams, blocks=jax_shard_blocks(jparams["blocks"], 2))
    jmesh = jax_build_mesh(JaxMeshSpec(stage=2))
    cases = [  # (T, N, kw): past the positional table; top_k at temperature 0
        (8, 18, {}), (8, 4, dict(top_k=3)), (8, 4, dict(temperature=-1.0))]
    for T, N, kw in cases:
        prompt = np.zeros((2, T), np.int32)
        with pytest.raises(ValueError) as jerr:
            jpp.make_pipeline_generate(jmesh, jcfg, 2, N, **kw)(jstaged, jnp.asarray(prompt))
        with pytest.raises(ValueError) as err:
            make_pipeline_generate(_mesh(2), cfg, 2, N, **kw)(_staged(params, 2),
                                                              torch.from_numpy(prompt))
        assert str(err.value) == str(jerr.value)
        with pytest.raises(ValueError) as jerr:
            jpp.make_pipeline_generate_overlapped(jmesh, jcfg, 2, N, 2, **kw)(
                jstaged, jnp.asarray(prompt[None].repeat(2, 0)))
        with pytest.raises(ValueError) as err:
            make_pipeline_generate_overlapped(_mesh(2), cfg, 2, N, 2, **kw)(
                _staged(params, 2), torch.from_numpy(prompt[None].repeat(2, 0)))
        assert str(err.value) == str(jerr.value)


# ------------------------------------------------------------ serving, CLI


def test_serve_stages_generate_round_trip_with_the_jax_client():
    """``serve_lm_generate(num_stages=2)`` over loopback gRPC: the JAX
    client's replies are the overlapped decoder's tokens (= the single
    program's), and concurrent one-row requests coalesce into groups."""
    from concurrent.futures import ThreadPoolExecutor

    from tpu_dist_nn.serving.server import GrpcClient as JaxClient
    from tpu_dist_nn_torch.serving.server import serve_lm_generate

    _, cfg, _, params = _both(61, PP_SHAPE)
    T, N = 8, 6
    prompts = np.random.default_rng(4).integers(0, 64, (5, T))
    want = generate(params, cfg, prompts, N).numpy()
    srv, port = serve_lm_generate(params, cfg, 0, max_new_tokens=N, prompt_len=T, num_stages=2,
                                  num_groups=2, host="127.0.0.1", device="cpu", warm_rows=2)
    try:
        c = JaxClient(f"127.0.0.1:{port}")
        out = c.generate(prompts)
        np.testing.assert_array_equal(out[:, :T], prompts)
        np.testing.assert_array_equal(out[:, T:], want)
        with ThreadPoolExecutor(max_workers=5) as ex:
            outs = list(ex.map(lambda i: c.generate(prompts[i:i + 1]), range(5)))
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o[0, T:], want[i])
        c.close()
    finally:
        srv.stop(0)


LM = ["lm", "--steps", "2", "--batch-size", "4", "--seq-len", "24", "--d-model", "16",
      "--heads", "2", "--layers", "2", "--eval-batches", "2"]


def test_cli_lm_sample_pipeline_stages(capsys):
    """tests/test_generate.py::test_cli_lm_sample_pipeline_stages: greedy
    and sampled decode in the pipeline placement, and the sample equal to
    the single program's; without --sample-bytes the flag is refused."""
    from tpu_dist_nn_torch.cli import main

    base = LM + ["--device", "cpu", "--sample-bytes", "6", "--prompt", "ab"]
    samples = []
    for extra in (["--sample-pipeline-stages", "2"], ["--sample-tensor-parallel", "2"], []):
        for temp in ("0", "0.8"):
            assert main(base + extra + ["--temperature", temp]) == 0
            samples.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1])["sample"])
    assert samples[0] == samples[4] and samples[1] == samples[5]  # pipelined == one program
    assert samples[2] == samples[4]  # greedy tensor-parallel == one program
    assert main(LM + ["--device", "cpu", "--sample-pipeline-stages", "2"]) == 2
