"""The port's Engine and CLI against the JAX package's, on the CPU.

Both engines are brought up from the same model file and fed the same
numpy-seeded rows in this process; the port runs with
``device="cpu"`` (its kernels' plain versions). The int8 comparison
pins the JAX engine's warm-time int8 auto-disable off
(``TDN_INT8_AUTO=0``, as ``tests/test_quantized.py`` does), so both
sides serve the int8 path.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_dist_nn.api.engine import Engine as JaxEngine
from tpu_dist_nn.cli import main as tdn_main
from tpu_dist_nn.core.schema import load_model as jax_load_model
from tpu_dist_nn.core.schema import save_examples, save_model
from tpu_dist_nn.testing.factories import random_inputs, random_model
from tpu_dist_nn_torch.api.engine import Engine
from tpu_dist_nn_torch.cli import main as port_main
from tpu_dist_nn_torch.kernels import KERNEL_WRAPPERS, reset_launch_counts
from tpu_dist_nn_torch.testing.oracle import oracle_forward_batch
from tpu_dist_nn_torch.core.schema import load_model
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError, UnavailableError

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _pin_int8_serving(monkeypatch):
    monkeypatch.setenv("TDN_INT8_AUTO", "0")


@pytest.fixture
def model_file(tmp_path):
    path = tmp_path / "model.json"
    save_model(random_model([24, 32, 16, 4], seed=0), path)
    return path


@pytest.fixture
def inputs_file(tmp_path):
    x = random_inputs(100, 24, seed=1)
    y = np.random.default_rng(2).integers(0, 4, 100)
    path = tmp_path / "inputs.json"
    save_examples(x, y, path)
    return path


@pytest.mark.parametrize(
    "quantize,atol,rtol", [(None, 1e-6, 1e-5), ("int8", 1e-7, 1e-6)], ids=["f32", "int8"]
)
def test_run_inference_matches_jax_engine(model_file, quantize, atol, rtol):
    x = random_inputs(100, 24, seed=3)
    labels = np.random.default_rng(4).integers(0, 4, 100)
    want = JaxEngine.up(model_file, [3], quantize=quantize).run_inference(
        x, labels, batch_size=32)
    eng = Engine.up(model_file, [3], device="cpu", quantize=quantize)
    got = eng.run_inference(x, labels, batch_size=32)
    assert got.outputs.shape == (100, 4) and len(got.batch_seconds) == 4
    np.testing.assert_allclose(got.outputs, want.outputs, atol=atol, rtol=rtol)
    assert got.metrics == want.metrics
    whole = eng.run_inference(x)
    np.testing.assert_array_equal(whole.outputs, got.outputs)
    assert whole.metrics is None and len(whole.batch_seconds) == 1


def test_engine_matches_oracle_and_collapses_placement(model_file, caplog):
    with caplog.at_level("INFO"):
        eng = Engine.up(model_file, [1, 1, 1], device="cpu")
    assert "collapsing to the single-program executor" in caplog.text
    place = eng.placement()
    assert place["distribution"] == [3] and not place["pipelined"]
    assert place["num_stages"] == 1 and place["input_dim"] == 24
    assert eng.setup_seconds is not None and eng.warm_bucket_count == 1
    x = random_inputs(9, 24, seed=5)
    np.testing.assert_allclose(eng.infer(x), oracle_forward_batch(load_model(model_file), x),
                               rtol=2e-5, atol=1e-6)
    out, seconds = eng.infer_single(x[0])
    assert out.shape == (4,) and seconds >= 0
    np.testing.assert_allclose(out, eng.infer(x[:1])[0])


def test_engine_validates_like_the_jax_engine(model_file):
    with pytest.raises(ValueError, match="sum"):
        Engine.up(model_file, [1, 1], device="cpu")
    with pytest.raises(InvalidArgumentError, match="unknown quantize"):
        Engine.up(model_file, device="cpu", quantize="int4")
    with pytest.raises(InvalidArgumentError, match="float32"):
        Engine.up(model_file, device="cpu", dtype=torch.float64)
    eng = Engine.up(model_file, device="cpu", warmup=False)
    assert eng.warm_bucket_count == 0
    with pytest.raises(InvalidArgumentError, match="Expected input dimension 24"):
        eng.infer(np.zeros((2, 23)))
    eng.down()
    eng.down()
    assert not eng.is_ready
    with pytest.raises(UnavailableError, match="engine is down"):
        eng.infer(np.zeros((1, 24)))


def test_warm_buckets_step_latency_and_export(model_file, tmp_path):
    eng = Engine.up(model_file, device="cpu", warm_rows=5)
    assert eng.warm_bucket_count == 4
    assert eng.warm_buckets(8) == []
    assert eng.warm_buckets(9) == [16]
    lat = eng.step_latency(batch_size=8, iters=3)
    assert lat["count"] == 3 and lat["num_stages"] == 1
    assert lat["p50_per_stage_s"] == lat["p50_s"]
    with pytest.raises(InvalidArgumentError):
        eng.step_latency(iters=0)
    out = tmp_path / "exported.json"
    eng.export(out, metrics={"accuracy": 0.5})
    back = jax_load_model(out)
    assert back.metadata["inference_metrics"] == {"accuracy": 0.5}
    assert back.to_json_dict()["layers"] == jax_load_model(model_file).to_json_dict()["layers"]


def test_infer_async_fetch_pairs(model_file):
    eng = Engine.up(model_file, device="cpu")
    a, b = random_inputs(3, 24, seed=6), random_inputs(5, 24, seed=7)
    pa, pb = eng.infer_async(a), eng.infer_async(b)
    np.testing.assert_array_equal(eng.fetch(pb), eng.infer(b))
    np.testing.assert_array_equal(eng.fetch(pa), eng.infer(a))


def test_without_a_card_entry_points_raise_unless_asked_for_cpu(model_file, inputs_file,
                                                                capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(UnavailableError, match="device='cpu'"):
        Engine.up(model_file)
    rc = port_main(["infer", "--config", str(model_file), "--inputs", str(inputs_file)])
    assert rc == 2 and "no CUDA device" in capsys.readouterr().err
    reset_launch_counts()
    Engine.up(model_file, device="cpu").run_inference(random_inputs(40, 24), batch_size=16)
    Engine.up(model_file, device="cpu", quantize="int8").infer(random_inputs(4, 24))
    assert [fn.launches for fn in KERNEL_WRAPPERS] == [0] * len(KERNEL_WRAPPERS)


def _lines(text, prefix):
    return [l for l in text.splitlines() if l.startswith(prefix)]


@pytest.mark.parametrize("quantize", [[], ["--quantize", "int8"]], ids=["f32", "int8"])
def test_cli_infer_prints_the_lines_tdn_prints(model_file, inputs_file, capsys, quantize):
    common = ["--config", str(model_file), "--inputs", str(inputs_file), *quantize]
    assert tdn_main(["infer", *common, "--batch-size", "32"]) == 0
    want = capsys.readouterr().out
    assert port_main(["infer", *common, "--batch-size", "32", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    for prefix in ("Correct predictions:", "Metrics:"):
        assert _lines(got, prefix) == _lines(want, prefix) and _lines(got, prefix)
    pattern = r"Total inference time: \d+\.\d{4} seconds \(\d+\.\d samples/sec\)"
    assert re.fullmatch(pattern, _lines(got, "Total")[0])
    assert re.fullmatch(pattern, _lines(want, "Total")[0])

    assert tdn_main(["infer", "7", *common]) == 0
    want = capsys.readouterr().out
    assert port_main(["infer", "7", *common, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert _lines(got, "Label:") == _lines(want, "Label:") and _lines(got, "Label:")
    g = json.loads(_lines(got, "Output:")[0][len("Output: "):])
    w = json.loads(_lines(want, "Output:")[0][len("Output: "):])
    np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-5)
    assert re.fullmatch(r"Inference time: \d+\.\d{4} seconds", _lines(got, "Inference")[0])


def test_cli_oracle_and_doctor(model_file, inputs_file, capsys):
    args = ["oracle", "--config", str(model_file), "--inputs", str(inputs_file)]
    assert tdn_main(args) == 0
    want = capsys.readouterr().out.splitlines()
    assert port_main(args) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 102
    for g, w in zip(got, want):
        assert re.sub(r"\d", "0", g) == re.sub(r"\d", "0", w)
    assert port_main(["doctor", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["oracle_parity"] and report["fused_dense"] == "ok"


_BLOCKED_RUN = r"""
import importlib, importlib.abc, pkgutil, sys
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
import tpu_dist_nn_torch
mods = [m.name for m in pkgutil.walk_packages(tpu_dist_nn_torch.__path__, "tpu_dist_nn_torch.")]
for m in mods:
    importlib.import_module(m)
from tpu_dist_nn_torch.api.engine import Engine
from tpu_dist_nn_torch.cli import main
from tpu_dist_nn_torch.core.schema import save_model
from tpu_dist_nn_torch.models.fcnn import forward, init_fcnn, spec_from_params
import torch
params = init_fcnn(torch.Generator().manual_seed(0), [12, 8, 3], device="cpu")
x = torch.rand(6, 12)
assert forward(params, x).shape == (6, 3)
save_model(spec_from_params(params, ["relu", "softmax"]), sys.argv[1])
for q in (None, "int8"):
    out = Engine.up(sys.argv[1], [1, 1], device="cpu", quantize=q).run_inference(
        np.random.default_rng(0).uniform(size=(20, 12)), batch_size=8).outputs
    assert out.shape == (20, 3)
assert main(["doctor", "--device", "cpu"]) == 0
# The layer-distribution pipeline on CPU stage slots: served, then
# trained through 1F1B.
from tpu_dist_nn_torch.data.datasets import Dataset
from tpu_dist_nn_torch.testing.oracle import oracle_forward_batch
from tpu_dist_nn_torch.train.trainer import TrainConfig
from tpu_dist_nn_torch.core.schema import load_model
pipe = Engine.up(sys.argv[1], [1, 1], devices=["cpu", "cpu"], num_microbatches=2)
assert pipe.placement()["pipelined"] and pipe.placement()["num_stages"] == 2
xs = np.random.default_rng(0).uniform(size=(9, 12))
assert np.allclose(pipe.infer(xs), oracle_forward_batch(load_model(sys.argv[1]), xs), atol=1e-6)
hist = pipe.train(Dataset(xs[:8].astype(np.float32), np.arange(8) % 3, 3),
                  TrainConfig(epochs=1, batch_size=4), schedule="1f1b")
assert len(hist) == 1 and pipe.infer(xs).shape == (9, 3)
# A conv model trained and served through the heterogeneous pipeline
# on [2, n - 2] CPU slots, then single-program.
from tpu_dist_nn_torch.models.network import init_conv_mlp
conv = init_conv_mlp(torch.Generator().manual_seed(1), in_shape=(6, 6, 1), conv_filters=(4,),
                     hidden=(8,), num_classes=3)
n = len(conv.layers)
cx = np.random.default_rng(1).uniform(size=(16, 36)).astype(np.float32)
for dist, devs in (([2, n - 2], ["cpu", "cpu"]), (None, None)):
    hetero = Engine.up(conv, dist, devices=devs, device="cpu", num_microbatches=2)
    assert hetero.placement()["pipelined"] == (dist is not None)
    hist = hetero.train(Dataset(cx, np.arange(16) % 3, 3), TrainConfig(epochs=2, batch_size=8))
    assert len(hist) == 2 and np.isfinite(hist[-1]["loss"])
    assert np.allclose(hetero.infer(cx), oracle_forward_batch(hetero.model, cx), atol=1e-5)
# The LM training slice: flash attention's plain path with its backward,
# two train_lm steps, evaluate_lm and the CLI's lm verb.
from tpu_dist_nn_torch.data.text import lm_sequences, encode, synthetic_wikitext
from tpu_dist_nn_torch.kernels.flash_attention import flash_attention
from tpu_dist_nn_torch.models.transformer import TransformerConfig, init_transformer
from tpu_dist_nn_torch.train.lm_trainer import LMTrainConfig, evaluate_lm, train_lm
q = torch.rand(2, 9, 2, 4, requires_grad=True)
flash_attention(q, q, q, causal=True).sum().backward()
assert q.grad.shape == q.shape
cfg = TransformerConfig(vocab_size=256, d_model=16, n_heads=2, n_layers=2, d_ff=32,
                        max_seq_len=16, remat=True)
rows = lm_sequences(encode(synthetic_wikitext(4000)), 16)
lm, hist = train_lm(init_transformer(torch.Generator().manual_seed(0), cfg, device="cpu"),
                    cfg, [rows[:2], rows[2:4]], LMTrainConfig(steps=2, log_every=1))
assert len(hist) == 2 and evaluate_lm(lm, cfg, rows[:8], batch_size=4)["eval_rows_used"] == 8
corpus = sys.argv[1] + ".txt"
open(corpus, "w").write(synthetic_wikitext(20000))
assert main(["lm", "--device", "cpu", "--corpus", corpus, "--d-model", "16", "--heads", "2",
             "--layers", "1", "--seq-len", "16", "--steps", "2", "--batch-size", "2",
             "--eval-batches", "1"]) == 0
# LM serving: the continuous scheduler (prefix cache, chunks, a stream)
# and the guarded Process path.
from tpu_dist_nn_torch.serving import ContinuousScheduler
from tpu_dist_nn_torch.utils.errors import IntegrityError
sched = ContinuousScheduler(lm, cfg, slots=2, prompt_len=6, max_new_tokens=4, prefill_chunk=3,
                            prefix_cache_blocks=1, device="cpu")
assert sched.warm()[-1] == "decode_step_slots"
out = sched.submit(np.tile(rows[:1, :6], (3, 1)))
assert out.shape == (3, 10) and (out[0] == out[2]).all() and sched.prefix_hits_total >= 1
stream = sched.submit_stream(rows[:1, :6])
got = []
while True:
    kind, data = stream.next_event(30.0)
    if kind == "end":
        break
    got += data
assert got == out[0, 6:].tolist() and data["reason"] == "max_tokens"
sched.close()
poisoned = np.random.default_rng(0).uniform(size=(2, 12))
poisoned[1, 0] = np.nan
try:
    Engine.up(sys.argv[1], device="cpu").infer(poisoned)
    raise AssertionError("the numeric guard let a non-finite row through")
except IntegrityError:
    pass
# The model-parallel LM: the PP x TP loss and its gradients on (stage 2,
# model 2) CPU slots, and the pipelined decoder, against the single program.
from tpu_dist_nn_torch.models.generate import generate
from tpu_dist_nn_torch.models.transformer import lm_loss
from tpu_dist_nn_torch.parallel import collectives, tensor_parallel, tp_generate
from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
from tpu_dist_nn_torch.parallel.pp_generate import make_pipeline_generate
from tpu_dist_nn_torch.parallel.transformer_pipeline import (
    make_pipeline_tp_lm_loss, shard_blocks, shard_blocks_pp_tp)
cfg4 = TransformerConfig(vocab_size=256, d_model=16, n_heads=2, n_layers=2, d_ff=32,
                         max_seq_len=16)
lm4 = init_transformer(torch.Generator().manual_seed(2), cfg4, device="cpu")
toks = torch.as_tensor(rows[:4]).long()
pptp = dict(lm4, blocks=shard_blocks_pp_tp(lm4["blocks"], cfg4, 2, 2))
loss = make_pipeline_tp_lm_loss(build_mesh(MeshSpec(stage=2, model=2), ["cpu"] * 4), cfg4, 2, 2)(
    pptp, toks)
assert abs(float(loss) - float(lm_loss(lm4, toks, cfg4))) < 1e-4
gen = make_pipeline_generate(build_mesh(MeshSpec(stage=2), ["cpu"] * 2), cfg4, 2, 4)
out = gen(dict(lm4, blocks=shard_blocks(lm4["blocks"], 2)), toks[:, :6])
assert torch.equal(out[:, 6:], generate(lm4, cfg4, toks[:, :6], 4))
# The zero-bubble schedules: a zb step (the recompute split) and the
# cotangent-stash split's B and W of one block, on CPU slots.
import tpu_dist_nn_torch.parallel.split_backward as split_backward
from tpu_dist_nn_torch.models.transformer import param_leaves, tree_map, unstack_blocks
from tpu_dist_nn_torch.parallel.transformer_pipeline import shard_blocks_interleaved
from tpu_dist_nn_torch.train.lm_trainer import make_pipeline_lm_train_step
from tpu_dist_nn_torch.train.optimizers import build_optimizer
zopt = build_optimizer(1e-2)
zb = make_pipeline_lm_train_step(build_mesh(MeshSpec(stage=2), ["cpu"] * 2), cfg4, 2, 2, zopt,
                                 schedule="zb")
zst = tree_map(lambda a: a.clone(), dict(lm4, blocks=shard_blocks_interleaved(lm4["blocks"], 2,
                                                                              1)))
zloss = zb(zst, zopt.init(param_leaves(zst)), toks)[2]
assert abs(float(zloss) - float(lm_loss(lm4, toks, cfg4))) < 1e-4
x0 = torch.rand(2, 5, 16)
_, _, wst = split_backward.block_backward_split(unstack_blocks(lm4["blocks"])[0], x0,
                                                torch.rand(2, 5, 16), cfg4)
assert split_backward.block_weight_grads(wst)["w_up"].shape == (16, 32)
# Sequence parallelism: a step on (seq 2, data 2) CPU slots in each mode,
# and a pp x sp 1f1b step, against the single program's masked CE.
from tpu_dist_nn_torch.models.transformer import forward as lm_forward, masked_next_token_ce
from tpu_dist_nn_torch.train.lm_trainer import (
    make_pipeline_sp_lm_train_step, make_seq_parallel_lm_train_step)
full = torch.as_tensor(rows[:4, :16]).long()
want = float(masked_next_token_ce(lm_forward(lm4, full, cfg4), full))
for mode in ("ring", "ulysses"):
    sp_step = make_seq_parallel_lm_train_step(
        build_mesh(MeshSpec(seq=2, data=2), ["cpu"] * 4), cfg4, zopt, mode)
    sst = tree_map(lambda a: a.clone().requires_grad_(), lm4)
    assert abs(float(sp_step(sst, zopt.init(param_leaves(sst)), full)[2]) - want) < 1e-4
    pp_sp = make_pipeline_sp_lm_train_step(
        build_mesh(MeshSpec(stage=2, seq=2), ["cpu"] * 4), cfg4, 2, 2, zopt, mode,
        schedule="1f1b")
    pst = tree_map(lambda a: a.clone(), dict(lm4, blocks=shard_blocks(lm4["blocks"], 2)))
    assert abs(float(pp_sp(pst, zopt.init(param_leaves(pst)), full)[2]) - want) < 1e-4
# The mixture-of-experts LM: a top-2 step on one program and with the
# experts over (data 2, expert 2) CPU slots, against the grouped program.
from tpu_dist_nn_torch.parallel import expert_parallel as ep
from tpu_dist_nn_torch.train.lm_trainer import make_moe_lm_train_step
mcfg = ep.MoEConfig(vocab_size=256, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_seq_len=16,
                    n_experts=4, router_top_k=2)
moe = ep.init_moe_transformer(torch.Generator().manual_seed(3), mcfg, device="cpu")
for mesh, groups, blocks in ((None, 1, moe["blocks"]),
                             (build_mesh(MeshSpec(data=2, expert=2), ["cpu"] * 4), 4,
                              ep.ep_shard_blocks(moe["blocks"], 2))):
    mst = tree_map(lambda a: a.clone().requires_grad_(), dict(moe, blocks=blocks))
    mloss = make_moe_lm_train_step(mcfg, zopt, mesh)(mst, zopt.init(param_leaves(mst)), toks)[2]
    assert abs(float(mloss) - float(ep.moe_lm_loss(moe, toks, mcfg, n_groups=groups))) < 1e-4
# ZeRO-1 and FSDP over (data 2) CPU slots, and the data-sharded engine,
# against the one-program step and engine.
from tpu_dist_nn_torch.parallel import zero
from tpu_dist_nn_torch.train.lm_trainer import make_lm_train_step
base = make_lm_train_step(cfg4, zopt)
bst = tree_map(lambda a: a.clone().requires_grad_(), lm4)
want = float(base(bst, zopt.init(param_leaves(bst)), toks)[2])
for make in (zero.make_zero_lm_train_step, zero.make_fsdp_lm_train_step):
    zs = make(build_mesh(MeshSpec(data=2), ["cpu"] * 2), cfg4, zopt, lm4)
    zst = zs.shard_params(tree_map(lambda a: a.clone().requires_grad_(), lm4))
    assert abs(float(zs(zst, zs.init_opt_state(param_leaves(zst)), toks)[2]) - want) < 1e-4
dp = Engine.up(sys.argv[1], data_parallel=2, devices=["cpu"] * 2)
assert dp.data_sharded and np.array_equal(dp.infer(xs), Engine.up(sys.argv[1], device="cpu").infer(xs))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpu_dist_nn")]
assert not bad, bad
print("imported", len(mods), "modules without jax")
"""


def test_port_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, str(tmp_path / "m.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "without jax" in proc.stdout


def test_chip_smoke_fails_without_a_card_or_outside_a_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
