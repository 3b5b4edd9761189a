"""Two repairs of the port's serving path, on the CPU.

* ``up --grpc-port`` teardown: every thread that can touch the engine
  (the batcher's dispatch and drain threads, the thread that closes the
  batcher after the grace drain) has ended when ``cmd_up`` returns, and
  ``Engine.down`` synchronises a card before it lets go of the state.
* The int8 warm-up gate: on the CPU it times ``infer`` on the host
  clock (the fake-clock tests of ``tests/test_torch_train.py`` hold its
  decisions) and touches no CUDA timer; on a card it takes CUDA-event
  device times (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import logging
import signal
import threading

import numpy as np
import pytest
import torch

from tpu_dist_nn_torch.api import engine as engine_mod
from tpu_dist_nn_torch.api.engine import Engine
from tpu_dist_nn_torch.cli import main as port_main
from tpu_dist_nn_torch.core.schema import save_model
from tpu_dist_nn_torch.models.fcnn import init_fcnn, spec_from_params

torch.set_num_threads(1)
SERVING_THREADS = ("tdn-serve-dispatch", "tdn-serve-drain", "tdn-serve-close")


def _model_file(tmp_path, sizes=(12, 16, 4)):
    acts = ["relu"] * (len(sizes) - 2) + ["softmax"]
    p0 = init_fcnn(torch.Generator().manual_seed(0), list(sizes), acts, device="cpu")
    path = tmp_path / "m.json"
    save_model(spec_from_params(p0, acts), path)
    return path


@pytest.mark.parametrize("quantize", [[], ["--quantize", "int8"]], ids=["f32", "int8"])
def test_no_serving_thread_outlives_cmd_up(tmp_path, monkeypatch, quantize):
    pytest.importorskip("grpc")
    monkeypatch.setenv("TDN_INT8_AUTO", "0")
    path = _model_file(tmp_path)
    before = set(threading.enumerate())
    handler = signal.getsignal(signal.SIGTERM)
    try:
        rc = port_main(["up", "--config", str(path), "--device", "cpu", "--grpc-port", "0",
                        "--serve-seconds", "0.5", "--drain-grace-seconds", "0.2",
                        "--serve-warm-rows", "8", *quantize])
    finally:
        signal.signal(signal.SIGTERM, handler)
    assert rc == 0
    alive = [t.name for t in set(threading.enumerate()) - before
             if t.name in SERVING_THREADS and t.is_alive()]
    assert alive == []


def test_server_join_closed_waits_for_the_batcher(tmp_path):
    pytest.importorskip("grpc")
    from tpu_dist_nn_torch.serving.server import GrpcClient, serve_engine

    eng = Engine.up(_model_file(tmp_path), device="cpu")
    server, port = serve_engine(eng, 0, host="127.0.0.1")
    client = GrpcClient(f"127.0.0.1:{port}")
    try:
        assert client.process(np.zeros((3, 12))).shape == (3, 4)
    finally:
        client.close()
    ev = server.stop(grace=0.2)
    assert server.join_closed(10.0)
    assert ev.is_set() and server.batcher.join(0)  # both batcher threads ended
    assert not [t for t in threading.enumerate()
                if t.name == "tdn-serve-close" and t.is_alive()]
    eng.down()
    eng.down()  # idempotent
    assert not eng.is_ready


def test_int8_gate_times_the_host_on_the_cpu(tmp_path, monkeypatch, caplog):
    def no_cuda_timer(*a, **k):
        raise AssertionError("the CPU gate read a CUDA event")

    monkeypatch.setattr(torch.cuda, "Event", no_cuda_timer)
    monkeypatch.setenv("TDN_INT8_AUTO", "0")
    with caplog.at_level(logging.INFO, logger="tpu_dist_nn_torch.engine"):
        eng = Engine.up(_model_file(tmp_path), device="cpu", quantize="int8", warm_rows=4)
    assert eng.int8_speedup_ratio > 0 and eng._int8_measured
    fields = [getattr(r, "tdn_fields", {}) for r in caplog.records
              if getattr(r, "tdn_event", "").startswith("int8.")]
    assert fields and all(f["clock"] == "host" and f["rows"] == 4 for f in fields)
    assert engine_mod._INT8_RATIO.labels().value == eng.int8_speedup_ratio
