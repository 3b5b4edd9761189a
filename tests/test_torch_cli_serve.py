"""The port's ``up`` and ``infer --target`` verbs against the JAX package's.

``python -m tpu_dist_nn_torch.cli up --device cpu --grpc-port 0`` runs
in a subprocess and the clients run in this process: the port's
``infer --target`` and ``tdn infer --target`` print the same report
lines against the port's server and against the JAX server, on the same
model file and examples, as the local ``infer`` does.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_dist_nn.api.engine import Engine as JaxEngine
from tpu_dist_nn.cli import main as tdn_main
from tpu_dist_nn.core.schema import save_examples, save_model
from tpu_dist_nn.serving import serve_engine as jax_serve_engine
from tpu_dist_nn.testing.factories import random_inputs, random_model
from tpu_dist_nn_torch.cli import main as port_main

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_serve")
    model = tmp / "model.json"
    save_model(random_model([24, 32, 16, 4], seed=0), model)
    examples = tmp / "examples.json"
    save_examples(random_inputs(100, 24, seed=1),
                  np.random.default_rng(2).integers(0, 4, 100), examples)
    return model, examples


def _up(model, *extra):
    """Start the port's ``up`` in a subprocess; returns (process, JSON
    lines printed before the port)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_nn_torch.cli", "up", "--config", str(model),
         "--device", "cpu", *extra],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    lines = []
    for line in proc.stdout:
        lines.append(json.loads(line))
        if "grpc_port" in lines[-1]:
            break
    return proc, lines


@pytest.fixture(scope="module")
def port_server(files):
    proc, lines = _up(files[0], "--grpc-port", "0", "--serve-seconds", "120",
                      "--drain-grace-seconds", "1")
    yield proc, lines
    proc.send_signal(signal.SIGTERM)
    proc.wait(timeout=60)


@pytest.fixture(scope="module")
def jax_server(files):
    srv, port = jax_serve_engine(JaxEngine.up(files[0]), 0, host="127.0.0.1")
    yield port
    srv.stop(0)


def _lines(text, prefix):
    return [ln for ln in text.splitlines() if ln.startswith(prefix)]


def test_up_prints_ready_then_the_port(port_server):
    _, lines = port_server
    assert lines[0]["ready"] is True and lines[0]["placement"]["input_dim"] == 24
    assert lines[0]["placement"]["device"] == "cpu" and lines[0]["setup_seconds"] >= 0
    assert isinstance(lines[-1]["grpc_port"], int) and lines[-1]["grpc_port"] > 0


@pytest.mark.parametrize("server", ["port", "jax"])
@pytest.mark.parametrize("client", ["port", "jax"])
def test_infer_target_prints_the_lines_tdn_prints(files, port_server, jax_server, capsys,
                                                  client, server):
    model, examples = files
    port = port_server[1][-1]["grpc_port"] if server == "port" else jax_server
    main = port_main if client == "port" else tdn_main
    assert tdn_main(["infer", "--config", str(model), "--inputs", str(examples),
                     "--batch-size", "32"]) == 0
    want = capsys.readouterr().out
    assert main(["infer", "--target", f"127.0.0.1:{port}", "--inputs", str(examples),
                 "--batch-size", "32"]) == 0
    got = capsys.readouterr().out
    for prefix in ("Correct predictions:", "Metrics:"):
        assert _lines(got, prefix) == _lines(want, prefix) and _lines(got, prefix)
    assert re.fullmatch(r"Total inference time: \d+\.\d{4} seconds \(\d+\.\d samples/sec\)",
                        _lines(got, "Total")[0])
    # One example by index, over the wire.
    assert main(["infer", "7", "--target", f"127.0.0.1:{port}", "--inputs",
                 str(examples)]) == 0
    one = capsys.readouterr().out
    assert tdn_main(["infer", "7", "--config", str(model), "--inputs", str(examples)]) == 0
    local = capsys.readouterr().out
    assert _lines(one, "Label:") == _lines(local, "Label:") and _lines(one, "Label:")
    np.testing.assert_allclose(json.loads(_lines(one, "Output:")[0][8:]),
                               json.loads(_lines(local, "Output:")[0][8:]),
                               atol=1e-6, rtol=1e-5)


def test_port_shorthand_and_client_flags(files, port_server, capsys):
    _, examples = files
    port = port_server[1][-1]["grpc_port"]
    assert port_main(["infer", "--port", str(port), "--inputs", str(examples),
                      "--retry-max-attempts", "1", "--session-key", "s",
                      "--slo-class", "best_effort", "--timeout", "20"]) == 0
    assert _lines(capsys.readouterr().out, "Correct predictions:")


def test_client_mode_refuses_local_engine_flags(files, capsys):
    model, examples = files
    rc = port_main(["infer", "--target", "127.0.0.1:1", "--config", str(model),
                    "--inputs", str(examples), "--quantize", "int8"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "--config, --quantize configure a LOCAL engine" in err
    assert port_main(["infer", "--inputs", str(examples)]) == 2
    assert "requires --config (or --target" in capsys.readouterr().err


def test_up_smoke_inference_latency_probe_and_serve_loop(files, capsys):
    model, examples = files
    t0 = time.monotonic()
    assert port_main(["up", "--config", str(model), "--device", "cpu", "--inputs",
                      str(examples), "--probe-latency", "--serve", "--serve-seconds",
                      "0.3"]) == 0
    assert time.monotonic() - t0 >= 0.3
    got = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [list(d) for d in got] == [["ready", "setup_seconds", "placement"],
                                      ["smoke_inference"], ["step_latency"]]
    assert len(got[1]["smoke_inference"]) == 4
    assert got[2]["step_latency"]["num_stages"] == 1
    assert port_main(["up", "--config", str(model), "--device", "cpu",
                      "--class-watermarks", "gold=1.0"]) == 2
    assert "unknown SLO class 'gold'" in capsys.readouterr().err
    assert port_main(["up", "--config", str(model), "--device", "cpu",
                      "--class-watermarks", "critical"]) == 2
    assert "class=fraction" in capsys.readouterr().err


def test_up_int8_server_drains_on_sigterm(files, capsys):
    model, examples = files
    proc, lines = _up(model, "--quantize", "int8", "--grpc-port", "0", "--max-pending-rows",
                      "4096", "--class-watermarks", "best_effort=0.25",
                      "--drain-grace-seconds", "1")
    try:
        port = lines[-1]["grpc_port"]
        assert port_main(["infer", "--target", f"127.0.0.1:{port}", "--inputs",
                          str(examples), "--batch-size", "50"]) == 0
        got = capsys.readouterr().out
        assert tdn_main(["infer", "--config", str(model), "--inputs", str(examples),
                         "--quantize", "int8", "--batch-size", "50"]) == 0
        want = capsys.readouterr().out
        assert _lines(got, "Correct predictions:") == _lines(want, "Correct predictions:")
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    assert rc == 0
    assert "graceful drain complete" in proc.stderr.read()


def test_up_without_a_card_refuses_unless_asked_for_cpu(files, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    assert port_main(["up", "--config", str(files[0])]) == 2
    assert "no CUDA device" in capsys.readouterr().err
