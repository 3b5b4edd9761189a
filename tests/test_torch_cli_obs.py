"""The port's metrics plane through its CLI, against ``tdn``'s.

``up --grpc-port 0 --metrics-port 0`` of both packages serve one model
file in subprocesses and take the same ``Process`` requests: their
``/metrics`` hold the same ``tdn_*`` families and label sets (the
router and autoscaler planes, which the port does not have yet, aside)
and equal request, row, launch and FLOP counters. The endpoint's client
verbs (``metrics``, ``trace``, ``profile``, ``incident``, ``debug``)
print what ``tdn``'s print against the port's endpoint, every flag of
the plane is refused with ``tdn``'s text, ``--aggregate`` is refused by
name, ``--profile-dir`` writes a trace, ``lm --serve-generate
--metrics-port`` exports the ``tdn_gen_*`` gauges, and an error path
frees the bound port. Counters are compared exactly.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from tpu_dist_nn.cli import main as tdn_main
from tpu_dist_nn.core.schema import save_examples, save_model
from tpu_dist_nn.testing.factories import random_inputs, random_model
from tpu_dist_nn_torch.cli import main as port_main
from tpu_dist_nn_torch.obs.exposition import parse_prometheus_text, split_series

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu", "TDN_INT8_AUTO": "0"}
# Planes the port does not have yet: their families exist only in tdn.
UNPORTED = ("tdn_router_", "tdn_autoscale_")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_obs")
    model = tmp / "model.json"
    save_model(random_model([24, 32, 16, 4], seed=0), model)
    examples = tmp / "examples.json"
    save_examples(random_inputs(40, 24, seed=1),
                  np.random.default_rng(2).integers(0, 4, 40), examples)
    return tmp, model, examples


def _spawn(cmd, until):
    """Start a serving command; returns (process, JSON lines printed up
    to and including the one holding key ``until``)."""
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=ENV)
    lines = []
    for line in proc.stdout:
        if line.startswith("{"):
            lines.append(json.loads(line))
            if until in lines[-1]:
                return proc, lines
    raise AssertionError(f"no {until!r} line: {proc.stderr.read()[-3000:]}")


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=60) == 0


def _ports(lines):
    got = {k: v for ln in lines for k, v in ln.items() if k in ("metrics_port", "grpc_port")}
    return got["metrics_port"], got["grpc_port"]


@pytest.fixture(scope="module")
def servers(files):
    pytest.importorskip("grpc")
    tmp, model, _ = files
    common = ["up", "--config", str(model), "--grpc-port", "0", "--metrics-port", "0",
              "--serve-seconds", "300", "--drain-grace-seconds", "1"]
    port = _spawn([sys.executable, "-m", "tpu_dist_nn_torch.cli", *common, "--device", "cpu",
                   "--incident-dir", str(tmp / "incidents")], "incident_dir")
    jax = _spawn([sys.executable, "-m", "tpu_dist_nn.cli", "--platform", "cpu", *common,
                  "--incident-dir", str(tmp / "jax_incidents")], "incident_dir")
    yield {"port": port, "jax": jax}
    for proc, _ in (port, jax):
        _stop(proc)


def _scrape(mport):
    with urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics", timeout=10) as r:
        return parse_prometheus_text(r.read().decode())


def _shape(parsed):
    """{(family, label set without le / device)} of a scrape."""
    out = set()
    for key in parsed:
        if key.startswith("__type__:"):
            continue
        name, labels = split_series(key)
        if name.startswith(UNPORTED):
            continue
        out.add((name, tuple(sorted((k, v) for k, v in labels.items()
                                    if k not in ("le", "device")))))
    return out


COUNTERS = ('tdn_rpc_requests_total{method="Process"}',
            'tdn_batcher_submits_total{method="Process"}',
            'tdn_batch_launches_total{method="Process"}',
            'tdn_batch_rows_count{method="Process"}',
            'tdn_batch_rows_sum{method="Process"}',
            'tdn_goodput_flops_total{kind="useful"}',
            'tdn_goodput_flops_total{kind="pad"}',
            'tdn_wire_decode_fast_total')


def test_metrics_families_and_counters_match_jax(servers, files):
    from tpu_dist_nn_torch.serving.server import GrpcClient

    xs = random_inputs(23, 24, seed=5)
    before, after = {}, {}
    for name, (_, lines) in servers.items():
        mport, gport = _ports(lines)
        before[name] = _scrape(mport)
        client = GrpcClient(f"127.0.0.1:{gport}")
        try:
            for n in (1, 5, 3, 8, 6):  # one request at a time: one launch each
                client.process(xs[:n])
        finally:
            client.close()
        after[name] = _scrape(mport)
    assert _shape(after["port"]) == _shape(after["jax"])
    for key in COUNTERS:
        deltas = {n: after[n].get(key, 0.0) - before[n].get(key, 0.0) for n in after}
        assert deltas["port"] == deltas["jax"], key
    assert after["port"]['tdn_rpc_requests_total{method="Process"}'] >= 5
    assert after["port"]["tdn_engine_ready"] == 1.0


def _masked(text):
    # Gauges move between two scrapes (RSS, the sampler's tick).
    return [re.sub(r"= \S+$", "= G", ln) if ln.startswith("[gauge]") else ln
            for ln in text.splitlines()]


def _both(capsys, argv, port_argv=None):
    out = {}
    for name, fn, args in (("jax", tdn_main, argv), ("port", port_main, port_argv or argv)):
        rc = fn(args)
        cap = capsys.readouterr()
        out[name] = (rc, cap.out, cap.err)
    return out


def test_client_verbs_print_what_tdn_prints(servers, files, capsys, tmp_path):
    from tpu_dist_nn_torch.serving.server import GrpcClient

    mport, gport = _ports(servers["port"][1])
    target = f"127.0.0.1:{mport}"
    client = GrpcClient(f"127.0.0.1:{gport}")
    try:  # traffic to report, whichever test ran first
        client.process(random_inputs(3, 24, seed=6))
    finally:
        client.close()
    got = _both(capsys, ["metrics", "--target", target])
    assert got["port"][0] == got["jax"][0] == 0
    assert _masked(got["port"][1]) == _masked(got["jax"][1])
    assert "tdn_rpc_requests_total" in got["port"][1] and "healthz: " in got["port"][1]
    got = _both(capsys, ["metrics", "--target", target, "--raw"])
    assert got["port"][1].startswith("# HELP") and got["jax"][1].startswith("# HELP")
    for argv in (["trace", "--target", target, "-o", str(tmp_path / "t.json")],
                 ["trace", "--target", target, "-o", str(tmp_path / "t.json"), "--limit", "3"],
                 ["profile", "--target", target],
                 ["profile", "--target", target, "--json", "--top", "2"],
                 ["incident", "ls", "--target", target]):
        got = _both(capsys, argv)
        assert got["port"] == got["jax"], argv
    got = _both(capsys, ["debug", "bundle", "--target", target, "-o", str(tmp_path / "b.zip"),
                         "--reason", "drill"])
    docs = {n: json.loads(v[1]) for n, v in got.items()}
    # Each capture is a new bundle: its id, and the zip's size with it, differ.
    assert docs["port"].pop("incident_id") != docs["jax"].pop("incident_id")
    assert docs["port"].pop("bytes") > 0 and docs["jax"].pop("bytes") > 0
    assert docs["port"] == docs["jax"]
    assert "trace.json" in docs["port"]["sections"]


def test_healthz_carries_the_fingerprint_and_boot_id(servers):
    docs = {}
    for name, (_, lines) in servers.items():
        mport, _ = _ports(lines)
        with urllib.request.urlopen(f"http://127.0.0.1:{mport}/healthz", timeout=10) as r:
            docs[name] = json.loads(r.read())
    assert docs["port"]["fingerprint"] == docs["jax"]["fingerprint"]
    assert docs["port"].keys() == docs["jax"].keys()
    assert docs["port"]["boot_id"] != docs["jax"]["boot_id"]


@pytest.mark.parametrize("argv", [
    ["up", "--slo-availability", "0.999"],
    ["up", "--slo-latency-p99-ms", "0"],
    ["up", "--metrics-port", "0", "--slo-availability", "1.5"],
    ["up", "--metrics-port", "0", "--slo-availability", "0.99"],
    ["up", "--incident-max", "0"],
    ["up", "--incident-cooldown", "0"],
    ["up", "--incident-dir", "incidents"],
    ["up", "--metrics-port", "0", "--incident-dir", "incidents"],
    ["up", "--trace-sample-rate", "1.5"],
    ["lm", "--metrics-port", "0", "--slo-latency-p99-ms", "10"],
    ["lm", "--metrics-port", "0", "--incident-dir", "incidents"],
    ["lm", "--trace-sample-rate", "-1"],
    ["train", "--trace-sample-rate", "2"],
    ["metrics", "--target", "127.0.0.1:1", "--profile"],
    ["metrics", "--target", "127.0.0.1:1", "--timeseries", "tdn_rpc_requests_total"],
    ["metrics", "--target", "127.0.0.1:1", "--timeout", "0.5"],
    ["trace", "--target", "127.0.0.1:1", "--aggregate", "--since", "3"],
    ["incident", "show", "--target", "127.0.0.1:1"],
    ["debug", "bundle", "--target", "127.0.0.1:1", "--timeout", "0.5"],
])
def test_refusals_are_tdns(files, capsys, argv):
    _, model, _ = files
    if argv[0] == "up":
        argv = [*argv, "--config", str(model)]
    global_ = ["--platform", "cpu"] if argv[0] in ("up", "lm", "train") else []
    got = _both(capsys, [*global_, *argv], argv)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 2 and got["port"][2].startswith("error: ")


@pytest.mark.parametrize("argv", [["metrics", "--aggregate"], ["trace", "--aggregate"],
                                  ["metrics", "--aggregate", "--profile"]])
def test_aggregate_is_refused_by_name(capsys, argv):
    assert port_main([argv[0], "--target", "127.0.0.1:1", *argv[1:]]) == 2
    assert "--aggregate is not ported" in capsys.readouterr().err


def test_profile_dir_writes_a_chrome_trace(files, capsys, tmp_path):
    _, model, examples = files
    out = tmp_path / "prof"
    assert port_main(["infer", "--config", str(model), "--inputs", str(examples), "--device",
                      "cpu", "--batch-size", "16", "--profile-dir", str(out)]) == 0
    assert "Total inference time" in capsys.readouterr().out
    (trace,) = out.glob("trace_*.json")
    assert json.loads(trace.read_text())["traceEvents"]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_error_path_frees_the_metrics_port(capsys):
    port = _free_port()
    argv = ["lm", "--device", "cpu", "--steps", "2", "--batch-size", "4", "--seq-len", "16",
            "--d-model", "16", "--heads", "2", "--layers", "1", "--steps-per-call", "3",
            "--log-every", "50", "--metrics-port", str(port)]
    assert port_main(argv) == 2
    cap = capsys.readouterr()
    assert "log_every" in cap.err and json.loads(cap.out.splitlines()[0]) == {"metrics_port": port}
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", port))  # a leak would raise EADDRINUSE
    finally:
        s.close()
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", port))
    blocker.listen(1)
    try:
        assert port_main(argv) == 2
        assert "could not bind" in capsys.readouterr().err
    finally:
        blocker.close()


def test_lm_serve_generate_exports_the_gen_gauges(tmp_path):
    pytest.importorskip("grpc")
    from tpu_dist_nn_torch.serving.server import GrpcClient

    proc, lines = _spawn(
        [sys.executable, "-m", "tpu_dist_nn_torch.cli", "lm", "--device", "cpu", "--d-model",
         "16", "--heads", "2", "--layers", "1", "--seq-len", "32", "--steps", "2",
         "--batch-size", "4", "--eval-batches", "1", "--serve-generate", "0",
         "--serve-prompt-len", "8", "--serve-new-tokens", "5", "--temperature", "0",
         "--gen-slots", "2", "--serve-seconds", "120", "--metrics-port", "0",
         "--slo-availability", "0.99", "--trace-sample-rate", "1"], "serving")
    try:
        mport = lines[0]["metrics_port"]
        before = _scrape(mport)
        client = GrpcClient(f"127.0.0.1:{lines[-1]['serving']['port']}")
        try:
            out = client.generate(np.full((2, 8), 65, np.int64))
        finally:
            client.close()
        assert out.shape == (2, 13)
        after = _scrape(mport)
        for key in ("tdn_gen_slots_active", "tdn_gen_slot_occupancy_ratio",
                    "tdn_prefix_cache_blocks_used", 'tdn_batcher_queue_depth{method="Generate"}'):
            assert key in after, key
        assert after["tdn_gen_tokens_total"] - before.get("tdn_gen_tokens_total", 0.0) == 10
        assert after['tdn_rpc_requests_total{method="Generate"}'] == 1
        assert after["tdn_train_steps_total{trainer=\"lm\"}"] == 2
        with urllib.request.urlopen(f"http://127.0.0.1:{mport}/slo", timeout=10) as r:
            assert json.loads(r.read())["objectives"][0]["name"] == "availability"
        with urllib.request.urlopen(f"http://127.0.0.1:{mport}/goodput", timeout=10) as r:
            assert "flops" in json.loads(r.read())
    finally:
        _stop(proc)
