"""``python -m tpu_dist_nn_torch.bench``, run small on the CPU.

The bench measures on the card; ``--device cpu`` and ``--samples`` let
it run here through the kernels' plain versions, labelled ``backend:
"cpu"``. Without a card and without ``--device cpu`` it refuses, as
``--serving`` does without grpcio.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_dist_nn_torch.bench import BASELINE_SAMPLES_PER_SEC, main, pipeline_latency_bench

ROOT = Path(__file__).resolve().parents[1]
HEADLINE = {"metric", "value", "unit", "vs_baseline", "backend", "device_kind",
            "power_limit"}


def _run(*args, prelude=""):
    code = prelude + ("import runpy, sys; sys.argv = ['bench'] + sys.argv[1:]; "
                      "runpy.run_module('tpu_dist_nn_torch.bench', run_name='__main__')")
    return subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"})


def test_headline_line_on_the_cpu(capsys):
    torch.set_num_threads(2)
    assert main(["--device", "cpu", "--samples", "1024"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert HEADLINE <= set(line)
    assert (line["backend"], line["device_kind"], line["power_limit"]) == ("cpu", "host cpu", None)
    assert line["unit"] == "samples/sec" and line["samples"] == 1024
    assert line["vs_baseline"] == line["value"] / BASELINE_SAMPLES_PER_SEC
    for key in ("value", "device_resident_samples_per_sec", "int8_resident_samples_per_sec",
                "library_resident_samples_per_sec"):
        assert line[key] > 0
    assert line["int8_vs_f32"] > 0 and line["kernel_vs_library"] > 0
    assert line["agreement"]["rows"] == 1024
    assert line["agreement"]["argmax_agreement"] == 1.0
    assert line["agreement"]["max_abs"] < 1e-5
    assert line["pipeline_num_stages"] == 1 and line["pipeline_step_p50_s"] > 0


def test_pipeline_keys_on_the_cpu():
    # bench.py:432-457's keys. The default placement on the CPU is one
    # device, so [1, 1, 1] collapses to one stage, as the JAX bench
    # reports on one chip.
    torch.set_num_threads(2)
    keys = pipeline_latency_bench(torch.device("cpu"))
    assert set(keys) == {"pipeline_step_p50_s", "pipeline_step_p99_s",
                         "p50_per_stage_pipeline_step_latency_s", "pipeline_num_stages",
                         "pipeline_step_batch"}
    assert keys["pipeline_num_stages"] == 1 and keys["pipeline_step_batch"] == 256
    assert keys["pipeline_step_p99_s"] >= keys["pipeline_step_p50_s"] > 0
    assert keys["p50_per_stage_pipeline_step_latency_s"] == keys["pipeline_step_p50_s"]


def test_without_a_card_it_exits_with_one_error_line():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    proc = _run("--samples", "64")
    assert proc.returncode == 1
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["value"] == 0 and "no CUDA device" in line["error"]


def test_serving_line_on_the_cpu():
    proc = _run("--serving", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert HEADLINE <= set(line) and line["backend"] == "cpu"
    assert line["value"] == line["batch512_rpc_samples_per_sec"] > 0
    assert line["batch4096_rpc_samples_per_sec"] > 0
    for arm in ("coalesced", "locked"):
        assert line[arm]["rpcs"] == 500 and line[arm]["p99_ms"] >= line[arm]["p50_ms"] > 0
    assert 0 < line["coalesced"]["batches"] <= line["coalesced"]["requests"] == 500
    assert np.isclose(line["coalescing_speedup"],
                      line["coalesced"]["rps"] / line["locked"]["rps"])


def test_serving_without_grpcio_names_it():
    block = ("import importlib.abc, sys\n"
             "class B(importlib.abc.MetaPathFinder):\n"
             "    def find_spec(self, name, path=None, target=None):\n"
             "        if name.split('.')[0] == 'grpc':\n"
             "            raise ImportError('blocked: ' + name)\n"
             "sys.meta_path.insert(0, B())\n")
    proc = _run("--serving", "--device", "cpu", prelude=block)
    assert proc.returncode == 1
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "grpcio" in line["error"]
