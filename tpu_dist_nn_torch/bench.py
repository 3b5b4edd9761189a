"""The port's headline bench: ``python3 -m tpu_dist_nn_torch.bench``.

Counterpart of the root ``bench.py`` (``throughput_bench`` and
``serving_bench``), on the card. One JSON line on standard output.

Default mode, the headline workload of ``bench.py:246-429``: 60,000
seeded uint8 rows through the MNIST FCNN 784-128-64-10 (seeded
He-normal weights, relu, relu, softmax) at batch 8192, scaled by 1/255
on the device:

* ``host_fed`` (the headline ``value``): one bulk uint8 host-to-device
  copy a pass, then the chain kernel over each batch with
  ``input_scale=1/255`` applied on load; min of 7 passes after one warm
  pass, wall time from the copy to the last batch's result.
* ``resident``: the same with the rows already on the card (CUDA
  events).
* ``int8_resident`` and ``int8_vs_f32``: the int8 chain kernel on the
  same batches (cast and scaled on the device first: the int8 kernel
  reads float32).
* ``library_resident``: the ``addmm`` + activation chain, TF32 off, on
  the same batches: the yardstick of the port's kernel (the JAX bench's
  ``xla_resident``), never run in its place.
* ``agreement``: argmax agreement and max_abs of the f32 outputs
  against the float64 oracle on 2,048 rows.
* ``pipeline_*`` (``bench.py:432-457``): BASELINE's p50 per-stage
  pipeline step latency. The same model brought up by ``Engine.up(model,
  [1, 1, 1])`` with the default placement (the visible cards, each
  once): a 3-stage pipeline on three cards; on one card it collapses to
  one program and ``pipeline_num_stages`` says 1, as the JAX bench does
  on one chip. ``step_latency`` at batch 256, 20 steps.

``--serving``, the loopback gRPC numbers of ``serving_bench``: the
``Process`` RPC at 512 and 4,096 rows a request (min of 7, with each
trace span's median: the client call, the server's handler and its
stages), then 10 concurrent single-row clients x 50 RPCs against the
coalescing server and against ``coalesce=False`` (rps, p50 and p99 ms,
and the coalescing server's batches for its requests). Needs grpcio.

Without a card it exits 1 with one JSON error line. ``--device cpu``
and ``--samples N`` exist for the tests: the kernels' plain versions on
the CPU, timed by the host clock, labelled ``backend: "cpu"``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

MNIST = [784, 128, 64, 10]
ACTS = ["relu", "relu", "softmax"]
BATCH = 8192
SCALE = 1.0 / 255.0
REPS = 7
# Seed of the bench's weights and rows.
SEED = 0
# The reference's own throughput (notebook cell 9: 60,000 rows in
# 4.5490 s), the root bench's baseline.
BASELINE_SAMPLES_PER_SEC = 60000 / 4.5490


def card_label() -> str | None:
    """``name, power.limit`` of card 0 as nvidia-smi prints them (None
    where there is no nvidia-smi)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def _labels(dev: torch.device) -> dict:
    if dev.type == "cuda":
        smi = card_label()
        return {"backend": "cuda", "device_kind": torch.cuda.get_device_name(dev),
                "power_limit": smi.split(",")[-1].strip() if smi else None}
    return {"backend": "cpu", "device_kind": "host cpu", "power_limit": None}


class _Clock:
    """Pass timer: CUDA events on the card, the host clock on the CPU.
    ``seconds(fn)`` runs ``fn`` and returns the time it took to
    finish."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def seconds(self, fn) -> float:
        if not self.cuda:
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3


def _model(dev):
    from tpu_dist_nn_torch.models.fcnn import init_fcnn

    return init_fcnn(torch.Generator().manual_seed(SEED), MNIST, ACTS, device=dev)


def throughput_bench(dev: torch.device, n_samples: int) -> dict:
    """Samples/s of every path over ``n_samples`` uint8 rows."""
    from tpu_dist_nn_torch.core.activations import apply_activation_by_id
    from tpu_dist_nn_torch.kernels import (
        fcnn_fused_forward,
        fcnn_quantized_forward,
        quantize_fcnn,
    )
    from tpu_dist_nn_torch.models.fcnn import spec_from_params
    from tpu_dist_nn_torch.testing.oracle import oracle_forward_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    params = _model(dev)
    q = quantize_fcnn(params)
    x = np.random.default_rng(SEED).integers(0, 256, (n_samples, MNIST[0])).astype(np.uint8)
    starts = range(0, n_samples, BATCH)
    clock = _Clock(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def host_fed_pass():
        xd = torch.from_numpy(x).to(dev)
        for i in starts:
            out = fcnn_fused_forward(params, xd[i:i + BATCH], input_scale=SCALE)
        sync()
        return out

    host_fed_pass()  # warm
    walls = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        host_fed_pass()
        walls.append(time.perf_counter() - t0)

    xd = torch.from_numpy(x).to(dev)
    sync()

    def f32_pass():
        for i in starts:
            fcnn_fused_forward(params, xd[i:i + BATCH], input_scale=SCALE)

    def int8_pass():
        for i in starts:
            fcnn_quantized_forward(q, xd[i:i + BATCH].to(torch.float32).mul_(SCALE))

    def library_pass():
        for i in starts:
            h = xd[i:i + BATCH].to(torch.float32).mul_(SCALE)
            for p in params:
                h = apply_activation_by_id(torch.addmm(p["b"], h, p["w"]), p["act"])

    rates = {}
    for key, fn in (("resident", f32_pass), ("int8_resident", int8_pass),
                    ("library_resident", library_pass)):
        fn()  # warm
        rates[key] = n_samples / min(clock.seconds(fn) for _ in range(REPS))

    n_check = min(2048, n_samples)
    got = fcnn_fused_forward(params, xd[:n_check], input_scale=SCALE).cpu().numpy()
    want = oracle_forward_batch(spec_from_params(params, ACTS), x[:n_check] * SCALE)
    return {
        "host_fed": n_samples / min(walls),
        **rates,
        "int8_vs_f32": round(rates["int8_resident"] / rates["resident"], 3),
        "kernel_vs_library": round(rates["resident"] / rates["library_resident"], 3),
        "agreement": {
            "rows": n_check,
            "argmax_agreement": float((got.argmax(-1) == want.argmax(-1)).mean()),
            "max_abs": float(np.abs(got - want).max()),
        },
    }


def pipeline_latency_bench(dev: torch.device) -> dict:
    """``Engine.step_latency`` of the model on ``[1, 1, 1]``, default
    placement, batch 256: bench.py's pipeline keys."""
    from tpu_dist_nn_torch.api.engine import Engine
    from tpu_dist_nn_torch.models.fcnn import spec_from_params

    engine = Engine.up(spec_from_params(_model("cpu"), ACTS), [1, 1, 1], device=dev)
    lat = engine.step_latency(batch_size=256, iters=20)
    return {
        "pipeline_step_p50_s": round(lat["p50_s"], 6),
        "pipeline_step_p99_s": round(lat["p99_s"], 6),
        "p50_per_stage_pipeline_step_latency_s": round(lat["p50_per_stage_s"], 6),
        "pipeline_num_stages": lat["num_stages"],
        "pipeline_step_batch": 256,
    }


def serving_bench(dev: torch.device, *, batch_rpcs: int = REPS,
                  clients: int = 10, rpcs_per_client: int = 50) -> dict:
    """The full loopback path (client encode, gRPC, decode, batcher,
    engine, encode, decode) on the MNIST FCNN."""
    from tpu_dist_nn_torch.api.engine import Engine
    from tpu_dist_nn_torch.models.fcnn import spec_from_params
    from tpu_dist_nn_torch.obs.trace import TRACER
    from tpu_dist_nn_torch.serving.server import GrpcClient, serve_engine

    engine = Engine.up(spec_from_params(_model(dev), ACTS), device=dev)
    rng = np.random.default_rng(SEED)
    out: dict = {}

    def time_batch(client, xb, label):
        client.process(xb)  # warm
        TRACER.reset()
        times = []
        for _ in range(batch_rpcs):
            t0 = time.perf_counter()
            client.process(xb)
            times.append(time.perf_counter() - t0)
        out[f"{label}_rpc_samples_per_sec"] = len(xb) / min(times)
        out[f"{label}_rpc_ms"] = min(times) * 1e3
        # Where a request's time goes: the median of each span (client
        # call, server handler, and its stages) over these calls.
        spans = {}
        for sp in TRACER.snapshot():
            spans.setdefault(sp.name, []).append(sp.dur * 1e3)
        out[f"{label}_span_ms"] = {k: float(np.median(v)) for k, v in spans.items()}

    def run_concurrent(port):
        lats: list[float] = []
        errors: list[str] = []
        lock = threading.Lock()
        xs = rng.uniform(0.0, 1.0, (clients, MNIST[0]))

        def worker(i):
            mine: list[float] = []
            c = GrpcClient(f"127.0.0.1:{port}")
            try:
                for _ in range(rpcs_per_client):
                    t0 = time.perf_counter()
                    c.process(xs[i:i + 1])
                    mine.append(time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 — counted, and fails the run below
                with lock:
                    errors.append(f"{type(e).__name__}: {e}"[:200])
            finally:
                c.close()
                with lock:
                    lats.extend(mine)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(clients)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        if errors:
            raise RuntimeError(f"{len(errors)} of {clients} clients failed: {errors[:3]}")
        arr = np.asarray(lats)
        return {"rps": len(lats) / wall, "p50_ms": float(np.percentile(arr, 50)) * 1e3,
                "p99_ms": float(np.percentile(arr, 99)) * 1e3, "rpcs": len(lats)}

    server, port = serve_engine(engine, 0, host="127.0.0.1", coalesce=True, warm_rows=32)
    client = GrpcClient(f"127.0.0.1:{port}")
    try:
        time_batch(client, rng.uniform(0.0, 1.0, (512, MNIST[0])), "batch512")
        time_batch(client, rng.uniform(0.0, 1.0, (4096, MNIST[0])), "batch4096")
        b = server.batcher
        req0, bat0 = b.requests_total, b.batches_total
        co = run_concurrent(port)
        co["requests"] = b.requests_total - req0
        co["batches"] = b.batches_total - bat0
        out["coalesced"] = co
    finally:
        client.close()
        server.stop(0)
    server2, port2 = serve_engine(engine, 0, host="127.0.0.1", coalesce=False)
    try:
        out["locked"] = run_concurrent(port2)
    finally:
        server2.stop(0)
    out["coalescing_speedup"] = out["coalesced"]["rps"] / out["locked"]["rps"]
    out["concurrent_clients"] = clients
    out["rpcs_per_client"] = rpcs_per_client
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m tpu_dist_nn_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--serving", action="store_true",
                    help="the loopback gRPC Process numbers (needs grpcio)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default); 'cpu' runs the plain versions (tests)")
    ap.add_argument("--samples", type=int, default=60000,
                    help="rows of the headline workload (tests run fewer)")
    args = ap.parse_args(argv)
    from tpu_dist_nn_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.serving:
        from tpu_dist_nn_torch.serving.server import _import_grpc

        _import_grpc()
        sv = serving_bench(dev)
        line = {"metric": "serving wire-path throughput (gRPC loopback, MNIST FCNN "
                          "784-128-64-10, 512-row Process requests)",
                "value": sv["batch512_rpc_samples_per_sec"], "unit": "samples/sec",
                "vs_baseline": sv["batch512_rpc_samples_per_sec"] / BASELINE_SAMPLES_PER_SEC,
                **_labels(dev), **sv}
    else:
        tp = throughput_bench(dev, args.samples)
        line = {"metric": f"samples/sec (MNIST FCNN 784-128-64-10 batched inference, "
                          f"{args.samples} uint8 samples, batch {BATCH}, host-fed)",
                "value": tp["host_fed"], "unit": "samples/sec",
                "vs_baseline": tp["host_fed"] / BASELINE_SAMPLES_PER_SEC,
                **_labels(dev), "samples": args.samples, "batch": BATCH,
                "device_resident_samples_per_sec": tp["resident"],
                "int8_resident_samples_per_sec": tp["int8_resident"],
                "library_resident_samples_per_sec": tp["library_resident"],
                "int8_vs_f32": tp["int8_vs_f32"],
                "kernel_vs_library": tp["kernel_vs_library"],
                "agreement": tp["agreement"], **pipeline_latency_bench(dev)}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # noqa: BLE001 — one JSON error line, not a traceback
        print(json.dumps({"metric": "samples/sec", "value": 0, "unit": "samples/sec",
                          "vs_baseline": 0, "error": f"{type(e).__name__}: {e}"[:500]}))
        sys.exit(1)
