"""The port's LM generation endpoint against the JAX package's, on the CPU.

``serve_lm_generate`` on both schedulers (continuous and static) beside
JAX's, on the same weights (``transformer_params_from_jax``) and
prompts, over loopback gRPC: each package's client gets JAX's greedy
``generate`` tokens from the other package's server, and a bad request
gets the same status and message from both; construction refusals
carry JAX's texts; ``num_stages > 1`` serves the pipelined overlapped
decoder (``tests/test_torch_pp_generate.py`` holds it to both decoders
over the wire). ``tdn lm --device cpu --serve-generate 0`` trains a tiny
recipe in a subprocess, prints its report with the ``serving`` block
before it blocks, answers both clients and the ``--stream`` client, and
drains on SIGTERM; its serving flags are refused before training with
JAX's texts. Config: vocab 64, d 32, 4 heads, 4 layers, ``max_seq_len``
24 (``tests/test_serving.py``'s).
"""

import io
import json
import os
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import redirect_stderr
from pathlib import Path

import grpc
import jax
import numpy as np
import pytest
import torch

from tpu_dist_nn.cli import main as tdn_main
from tpu_dist_nn.models import generate as jg
from tpu_dist_nn.models import transformer as jt
from tpu_dist_nn.serving import server as js
from tpu_dist_nn_torch.cli import main as port_main
from tpu_dist_nn_torch.models.transformer import TransformerConfig, transformer_params_from_jax
from tpu_dist_nn_torch.serving import server as ps

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_seq_len=24)
JCFG, PCFG = jt.TransformerConfig(**CFG), TransformerConfig(**CFG)
JPARAMS = jt.init_transformer(jax.random.key(7), JCFG)
PARAMS = transformer_params_from_jax(jax.tree.map(np.asarray, JPARAMS), device="cpu")
T = 8


def _port(**kw):
    return ps.serve_lm_generate(PARAMS, PCFG, 0, prompt_len=T, host="127.0.0.1", device="cpu",
                                **kw)


def _jax(**kw):
    return js.serve_lm_generate(JPARAMS, JCFG, 0, prompt_len=T, host="127.0.0.1", **kw)


@pytest.mark.parametrize("scheduler", ["continuous", "static"])
def test_loopback_parity_with_the_jax_server_both_ways(scheduler):
    prompts = np.random.default_rng(9).integers(0, 64, (5, T))
    eos = int(np.asarray(jg.generate(JPARAMS, JCFG, prompts, 6))[0, 2])
    want = np.asarray(jg.generate(JPARAMS, JCFG, prompts, 6, eos_id=eos))
    psrv, pport = _port(max_new_tokens=6, scheduler=scheduler, gen_slots=3, eos_id=eos,
                        warm_rows=1)
    jsrv, jport = _jax(max_new_tokens=6, scheduler=scheduler, gen_slots=3, eos_id=eos)
    try:
        assert (psrv.scheduler is None) == (scheduler == "static")
        clients = {}
        for name, cls in (("port", ps.GrpcClient), ("jax", js.GrpcClient)):
            for srv, port in (("port", pport), ("jax", jport)):
                clients[name, srv] = cls(f"127.0.0.1:{port}")
        for (name, srv), c in clients.items():
            out = c.generate(prompts)
            np.testing.assert_array_equal(out[:, :T], prompts, err_msg=f"{name} -> {srv}")
            np.testing.assert_array_equal(out[:, T:], want, err_msg=f"{name} -> {srv}")
        # Concurrent one-row requests coalesce (static) or share steps.
        c = clients["jax", "port"]
        with ThreadPoolExecutor(max_workers=5) as ex:
            outs = list(ex.map(lambda i: c.generate(prompts[i:i + 1]), range(5)))
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o[0, T:], want[i])
        # The same status and message from both servers.
        for bad in (np.zeros((1, 5)), np.full((1, T), 0.5), np.full((1, T), 99)):
            got = []
            for srv in ("port", "jax"):
                with pytest.raises(grpc.RpcError) as ei:
                    clients["jax", srv].generate(bad)
                got.append((ei.value.code(), ei.value.details()))
            assert got[0] == got[1] and got[0][0] == grpc.StatusCode.INVALID_ARGUMENT
        for c in clients.values():
            c.close()
    finally:
        psrv.stop(0)
        jsrv.stop(0)
    if psrv.scheduler is not None:
        assert not psrv.scheduler._thread.is_alive()


@pytest.mark.parametrize("kw", [
    dict(scheduler="orca"), dict(num_stages=2, scheduler="continuous"),
    dict(num_stages=2, eos_id=3), dict(scheduler="continuous", coalesce=False),
    dict(scheduler="static", prefix_cache_blocks=2), dict(coalesce=False, prefill_chunk=4),
    dict(temperature=0.0, top_k=5), dict(max_new_tokens=18),
], ids=["scheduler", "single-chip", "eos-stages", "coalesce", "prefix-static",
        "chunk-lock", "top_k", "max_seq_len"])
def test_construction_refusals_carry_jax_texts(kw):
    kw.setdefault("max_new_tokens", 4)
    texts = []
    for serve in (_port, _jax):
        with pytest.raises(ValueError) as ei:
            serve(**kw)
        texts.append(str(ei.value))
    assert texts[0] == texts[1]


def test_pipelined_serving_is_refused_as_not_ported_and_lock_path_serves():
    """Holds that ``num_stages=2`` serves the single program's greedy
    tokens (the pipelined overlapped decoder on the static arm), that the
    24-position boundary boots, and that the lock path serves. The name
    is kept from when ``num_stages > 1`` was refused."""
    prompts = np.random.default_rng(3).integers(0, 64, (3, T))
    srv, port = _port(max_new_tokens=4, num_stages=2)
    try:
        assert srv.scheduler is None and srv.batcher is not None
        c = ps.GrpcClient(f"127.0.0.1:{port}")
        np.testing.assert_array_equal(c.generate(prompts)[:, T:],
                                      np.asarray(jg.generate(JPARAMS, JCFG, prompts, 4)))
        c.close()
    finally:
        srv.stop(0)
    srv, port = _port(max_new_tokens=17)  # the boundary: 8 + 17 - 1 = 24 positions
    srv.stop(0)
    srv, port = _port(max_new_tokens=4, coalesce=False)
    try:
        assert srv.scheduler is None and srv.batcher is None
        c = ps.GrpcClient(f"127.0.0.1:{port}")
        prompts = np.random.default_rng(3).integers(0, 64, (2, T))
        np.testing.assert_array_equal(c.generate(prompts)[:, T:],
                                      np.asarray(jg.generate(JPARAMS, JCFG, prompts, 4)))
        c.close()
    finally:
        srv.stop(0)


def test_sampled_endpoint_draws_fresh_continuations():
    for scheduler in ("continuous", "static"):
        srv, port = _port(max_new_tokens=8, temperature=1.0, scheduler=scheduler)
        try:
            c = ps.GrpcClient(f"127.0.0.1:{port}")
            prompts = np.full((2, T), 3)
            a, b = c.generate(prompts), c.generate(prompts)
            assert not np.array_equal(a, b)
            assert (a[:, T:] >= 0).all() and (a[:, T:] < 64).all()
            c.close()
        finally:
            srv.stop(0)


# ------------------------------------------------------------------ the CLI

LM = ["lm", "--steps", "2", "--batch-size", "4", "--seq-len", "24", "--d-model", "16",
      "--heads", "2", "--layers", "2", "--eval-batches", "2"]


@pytest.mark.parametrize("flags", [
    ["--eos-id", "300"],
    ["--serve-generate", "0", "--serve-stages", "2", "--scheduler", "continuous"],
    ["--serve-generate", "0", "--serve-stages", "2", "--eos-id", "0"],
    ["--serve-generate", "0", "--scheduler", "static", "--prefix-cache-blocks", "2"],
    ["--serve-generate", "0", "--prefix-cache-blocks", "2", "--prefill-chunk", "16"],
    ["--serve-generate", "0", "--serve-stages", "3"],
    ["--serve-generate", "0", "--serve-prompt-len", "20", "--serve-new-tokens", "8"],
    ["--serve-generate", "0", "--serve-stages", "2", "--serve-groups", "1"],
    ["--gen-slots", "0"], ["--prefill-chunk", "0"], ["--prefix-cache-blocks", "-1"],
], ids=["eos", "continuous-stages", "eos-stages", "prefix-static", "no-tier", "layers",
        "positions", "groups", "slots", "chunk", "blocks"])
def test_cli_serving_flags_refused_before_training_with_jax_texts(flags):
    texts = []
    for main, extra in ((port_main, ["--device", "cpu"]), (tdn_main, None)):
        err = io.StringIO()
        argv = (["--platform", "cpu"] + LM + flags) if extra is None else (LM + flags + extra)
        t0 = time.monotonic()
        with redirect_stderr(err):
            assert main(argv) == 2
        assert time.monotonic() - t0 < 20.0  # refused before any training
        texts.append(err.getvalue().strip().splitlines()[-1])
    assert texts[0] == texts[1]


def test_cli_pipelined_serving_refused_as_not_ported(capsys):
    """Holds that ``tdn lm --serve-stages 2`` serves (for 0 seconds here)
    and reports ``serving.stages == 2``, and that ``--stream`` without
    ``--target`` is refused. The name is kept from when ``--serve-stages``
    above 1 was refused."""
    assert port_main(LM + ["--serve-generate", "0", "--serve-stages", "2",
                           "--serve-prompt-len", "8", "--serve-new-tokens", "4",
                           "--serve-seconds", "0", "--drain-grace-seconds", "0",
                           "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["serving"]["stages"] == 2 and report["serving"]["scheduler"] == "static"
    err = io.StringIO()
    with redirect_stderr(err):
        assert port_main(["lm", "--stream"]) == 2
    assert "--target" in err.getvalue()


def test_cli_lm_serve_generate_and_stream_end_to_end():
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_nn_torch.cli", *LM, "--device", "cpu",
         "--serve-generate", "0", "--serve-seconds", "120", "--serve-prompt-len", "8",
         "--serve-new-tokens", "4", "--temperature", "0", "--gen-slots", "2",
         "--prefill-chunk", "4", "--prefix-cache-blocks", "1", "--drain-grace-seconds", "1"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        report = json.loads(proc.stdout.readline())
        serving = report["serving"]
        assert serving["scheduler"] == "continuous" and serving["gen_slots"] == 2
        assert serving["prefill_chunk"] == 4 and report["eval_split"] == "held-out"
        target = f"127.0.0.1:{serving['port']}"
        prompts = np.full((2, 8), 7)
        outs = []
        for cls in (ps.GrpcClient, js.GrpcClient):
            c = cls(target, timeout=30.0)
            outs.append(c.generate(prompts))
            c.close()
        assert outs[0].shape == (2, 12) and (outs[0][:, :8] == 7).all()
        np.testing.assert_array_equal(outs[0], outs[1])
        stream = subprocess.run(
            [sys.executable, "-m", "tpu_dist_nn_torch.cli", "lm", "--stream", "--target",
             target, "--prompt", "\x07" * 8, "--serve-prompt-len", "8"],
            cwd=ROOT, capture_output=True, text=True, env=env, timeout=120)
        assert stream.returncode == 0, stream.stderr
        summary = json.loads(stream.stdout.strip().splitlines()[-1])
        assert summary["tokens"] == 4 and summary["finish"]["reason"] == "max_tokens"
        assert summary["ttft_s"] > 0 and summary["trace_id"]
        proc.send_signal(signal.SIGTERM)  # the graceful drain
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
