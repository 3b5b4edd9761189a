#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_dist_nn_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs one NVIDIA GPU (Hopper: the kernels are built for ``sm_90a``),
``nvcc`` and ``nvidia-smi``, and imports nothing of JAX or of the JAX
package. Phases, each fatal on failure (exit 1, no result line):

1. Build every CUDA kernel from ``tpu_dist_nn_torch/kernels/csrc``
   (one ``nvcc`` per source, in parallel) and print the build time and
   ptxas' register and shared-memory report.
2. Hold each kernel against its plain PyTorch version on the card, at
   the main path's shapes and a few more, with the stated tolerances
   (TF32 off for every float32 comparison). The f32 dense kernels also
   at the conv network's 2048-64-10 tail (split-K across a cluster, at
   1024, 1023 and 37 rows, uint8 input, a ragged K of 2000), with a
   softmax normalised in the epilogue and in a second pass, and each
   called twice on one input: bit-equal. The int8 tensor-core chain at
   8192, 8191 and 37 rows, 1024-1024-1024-10, a 60000-wide input and
   (cut in two) a 60000-wide interior, bit-equal on a repeat; the conv
   implicit GEMM at batch 1023, an odd 31x29 image with overlapping 3x3
   stride-2 windows, stride 2 VALID, softmax over the channels, and the
   two shapes a band planner refused ((1, 64, 64, 256) x 3x3x256x256 and
   (1, 3, 32, 1024) x 3x3x1024x1).
3. Drive each main path with every kernel's launch count set to 0
   just before it and read just after:

   * the dense path: a seeded MNIST-width FCNN (784-128-64-10) written
     in the reference JSON schema, ``Engine.up(path, [1, 1, 1])`` and
     ``run_inference`` over 60,000 seeded rows at batch 8192, once in
     float32 and once with ``quantize="int8"``; the CLI's ``infer`` on
     a 256-row examples file; and the CLI's ``doctor`` kernel probe.
     The float32 outputs must match the float64 oracle and the int8
     outputs the plain int8 chain; uint8 rows through the f32 engine
     must be bit-equal to the same rows cast to float32.
   * the layer pipeline path (``pipeline_phase``): ``Engine.up(path,
     [1, 1, 1], devices=[card] * 3)`` (three stage slots, one CUDA
     stream each) at 4 microbatches, ``run_inference`` over the 60,000
     rows at batch 8192 in f32 and int8, in turns with the single
     program: the chain (int8 chain) launching stages x microbatches
     times a batch, f32 within 1e-5 of the float64 oracle, int8
     bit-equal to the single-program int8 engine; each stage's launch
     at 2,048 rows timed beside the whole chain at 8,192; 20 runs of one
     batch in flight together under allocator churn, bit-equal;
     ``step_latency`` at batch 256; the 34-layer model on ``[9, 9, 8,
     8]`` at ``virtual_stages=2`` (f32 within 1e-5 of its single
     program and the oracle, int8 bit-equal); the digits record's recipe
     trained through ``[1, 1, 1]`` with ``schedule="1f1b"`` (held-out
     >= 0.97, the exported model at the same accuracy on one program);
     gpipe and 1f1b first-step losses and gradients (the CPU tests'
     tolerances) and one 60,000-row epoch of each beside one program.
   * the train path (native FCNN training), with ``TDN_INT8_AUTO=0``
     for every int8 check but the gate's: the digits record's command
     (``cli train --data digits --layers 64,128,64,10 --epochs 40
     --lr-schedule cosine --warmup-steps 50 --out``) in a subprocess,
     held-out accuracy and F1 >= 0.97 (record 0.9805 / 0.9805), and the
     CLI's ``infer`` of the exported model on the 359 held-out digits at
     exactly the trainer's accuracy; 784-128-64-10 over 60,000 seeded
     ``synthetic_mnist`` rows at batch 64 for 3 epochs through
     ``Engine.up`` + ``Engine.train`` with eval on 10,000 more each
     epoch: the mean loss falls every epoch, no kernel launches in the
     steps and one chain launch per eval batch, ms/step and samples/s
     printed; 1 epoch plus a checkpoint resume to 3 equals the straight
     3 (atol 1e-7, rtol 1e-6); 2 digits epochs on the card and on the
     CPU from one init (losses within rtol 1e-4); a trained int8 engine
     bit-equal to the plain int8 chain on its re-quantized weights; and
     the int8 warm-up gate on (``warm_rows=8192``): its ratio and
     decision, and launches that follow the decision.
   * the Process path (the reference's ``LayerService.Process`` RPC):
     the 60,000 rows encoded as float64 ``Matrix`` requests of 1, 7,
     64, 512 and 4,096 rows in turn, sent from 10 threads through the
     handler body (``make_process_handler``) and the coalescing
     ``Batcher`` (depth 2) in front of ``Engine.up(path)``: replies
     within 1e-5 of the float64 oracle and bit-equal to
     ``Engine.infer`` on each request's rows alone, one chain launch per
     batch and fewer batches than requests; again at depth 1 (bit-equal
     to depth 2) with one wrong-width request refused INVALID_ARGUMENT
     among them; the int8 engine (bit-equal to its rows alone, the
     plain int8 chain within its tolerance); 1,024 CIFAR rows through
     the conv engine (CONV_TOL of the plain versions). Where grpcio is
     installed, the same over loopback gRPC (``serve_engine``,
     ``GrpcClient``), the CLI's ``up --grpc-port 0`` in a subprocess
     with ``infer --target`` (its accuracy line equal to the local
     ``infer``'s), and ``python3 -m tpu_dist_nn_torch.bench
     --serving``; without grpcio it prints ``grpc: not installed;
     socket phase not run``. Then each stage's median time from the
     trace spans (decode, queue_wait, stage, launch, fetch, encode),
     the wall time of a request by size, the chain kernel's device time
     for the same batches, and the headline bench line
     (``python3 -m tpu_dist_nn_torch.bench``).
   * the conv path: the CIFAR-10 conv+MLP network (``init_conv_mlp``'s
     defaults, 32x32x3 -> conv16+pool -> conv32+pool -> 64 -> 10),
     ``Engine.up(path, [2, 2, 2])`` and ``run_inference`` over 10,000
     seeded rows at batch 1024 (two conv launches and one chain launch
     per batch), held against the float64 oracle on 128 rows; and the
     CLI's ``infer`` on a 256-row examples file.

   * the LM training path: the 86,039,040-parameter byte-level
     Transformer (d 768, 12 heads, 12 layers, d_ff 3072, T 1024,
     batch 16, bf16 over float32 masters, remat; Adam at 3e-4, cosine
     after 5 warm-up steps) trained for 30 steps on the vendored
     corpus through ``train_lm``, then ``evaluate_lm`` on 8 held-out
     batches. bf16 attention routes to the sm90 tensor-core kernels:
     ``flash_fwd_sm90`` must launch exactly steps x 12 x 2 (remat) + 12
     per eval batch times, ``flash_bwd_sm90`` steps x 12, the f32
     flash kernels never; every loss finite and the last below the
     first. Before it, the same width at depth 2 (batch 4) trains 3
     steps with the flash kernels and with the materialised
     ``dot_product_attention``: in float32 (the f32 route, its own
     path for the launch counts) first loss within rtol 1e-5, all three
     within 1e-4, first-step gradients within 5e-4; in bf16 (the sm90
     route) first loss within rtol 1e-3, all three within 1e-2.
     After it, the CLI's ``lm`` verb runs a few steps.

   * the float32 LM path, ``tdn lm``'s default recipe
     (``artifacts/real_text_r04/RECORD.json``): d 128, 4 heads, 4
     layers, T 128, batch 16, 400 steps, Adam at 1e-3 cosine after 20
     warm-up steps, seed 0, float32, on the vendored
     ``licenses_corpus.txt`` read by path, through ``train_lm`` and
     ``evaluate_lm`` on the whole held-out split. Attention takes the
     3xTF32 kernels only (``flash_fwd_f32`` steps x 4 + 4 per eval
     batch launches, ``flash_bwd_f32`` steps x 4, sm90 never); every
     loss finite, the last below the first, held-out loss within 0.10
     nats of the record's 2.5303 (the port's weights come from a
     ``torch.Generator``, its batches are the JAX package's).

   * dense runs past one chain launch, each engine's counts zeroed
     before its run: a 34-layer 16-wide FCNN in float32 (float64
     oracle, 1e-5) and int8 (the plain chain), 784-4000-10 and
     64-8192-10 in float32 (oracle), 60000-16-10 and 64-60000-10 in
     int8 (plain chain); each prints its cut and its chain launches a
     batch.

   Every kernel of a path must have launched in that path's run.
4. Time each kernel, its plain version and the nearest PyTorch library
   call with CUDA events at the main paths' shapes (the chain also at
   the conv tail's; the f32 dense kernels as a CUDA graph of 50 calls,
   since their device time is below a Python call's), beside the least
   time the card could take (its bound); the conv engine's samples/s
   and batch latency (the int8 chain and each conv stage by a host
   loop of 50 calls, or by a CUDA graph of 50 calls where the loop
   takes over 10% longer, both printed); the sm90 flash pair in bf16
   and the f32 pair in float32 beside SDPA in the same dtype, at the
   85M shape and (f32) at the recipe's (B 16, H 4, T 128, Dh 32), with
   the FP32 FFMA and the 3xTF32 bounds printed for the f32 pair; flash
   attention and the materialised attention at the TPU kernel sweep's
   shape (B 4, H 8, T 4096).

The second-to-last line is one JSON object with a record per kernel;
the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MNIST = [784, 128, 64, 10]
ACTS = ["relu", "relu", "softmax"]
BATCH = 8192
ROWS = 60000
CIFAR_BATCH = 1024
CIFAR_ROWS = 10000  # the size of CIFAR-10's test split
CONV_TOL = (1e-5, 2e-5)  # atol, rtol: tests/test_conv_kernel.py's
DENSE_PATH_KERNELS = ("fused_dense", "fcnn_fused_forward", "fcnn_quantized_forward")
CONV_PATH_KERNELS = ("fused_conv2d", "fcnn_fused_forward")
# The LM main path: the 85M recipe of artifacts/tpu_scale_r04/RECORD.json
# ("run_85m"), cut to 30 steps with 5 warm-up steps.
LM = dict(d_model=768, heads=12, layers=12, seq_len=1024, batch=16, steps=30, warmup=5,
          lr=3e-4, eval_batches=8, params=86_039_040)
# The float32 LM main path: tdn lm's default recipe of
# artifacts/real_text_r04/RECORD.json, in full, and the record's held-out
# results; the held-out loss must land within `band` nats of the record's.
RECIPE = dict(d_model=128, heads=4, layers=4, seq_len=128, batch=16, steps=400, warmup=20,
              lr=1e-3, seed=0, corpus="tpu_dist_nn/data/corpus/licenses_corpus.txt",
              loss=2.5303, perplexity=12.5567, bits_per_byte=3.6504, band=0.10)
FLASH_TOL = (2e-5, 2e-5)  # atol, rtol: tests/test_flash_attention.py's forward
FLASH_GRAD_TOL = (2e-4, 2e-4)  # and gradients
# A bf16 output is its float32 value rounded to nearest even: at most
# 2**-8 of it away. bf16 kernels are held against the plain version run
# in float32 on the same bf16 inputs with that much more rtol. The sm90
# kernels also round P (forward, dV) and dS (dK, dQ) to bf16 for the
# tensor cores: each rounded term moves by at most 2**-8 of its size, so
# their tolerance adds, element by element, 2**-8 of the same product
# over absolute values (kernels.flash_attention.bf16_rounding_bounds).
BF16_RTOL = 2.0**-8
# bf16 training parity, sm90 flash vs dot_product_attention (relative
# loss difference): the two round at different places (the reference
# rounds its scores and each product's output, the kernels P and O), so
# per-token logits differ by about one bf16 rounding (2**-8 = 3.9e-3);
# the loss, a mean over 4,096 tokens, moves by well under one rounding
# at the first step, and Adam's sign-like first updates can carry the
# difference to a few roundings by the third.
BF16_PARITY_RTOL = (1e-3, 1e-2)  # first step, all three

# Published dense peaks (NVIDIA data sheets): device memory bytes/s,
# FP32 FLOP/s on CUDA cores, INT8 tensor-core OP/s, BF16 and TF32
# tensor-core FLOP/s. Matched on the name torch reports; the SXM part is
# the default.
PEAKS = {
    "PCIe": (2.0e12, 51e12, 1513e12, 756e12, 378e12),
    "NVL": (3.9e12, 60e12, 1671e12, 835e12, 417.5e12),
    "SXM": (3.35e12, 67e12, 1979e12, 989e12, 495e12),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def peaks_for(name: str) -> tuple[str, tuple[float, float, float, float, float]]:
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, PEAKS[key]
    return "SXM", PEAKS["SXM"]


def bound_ms(nbytes: float, ops: float, ops_rate: float, mem_rate: float):
    t_mem, t_ops = nbytes / mem_rate, ops / ops_rate
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def causal_pairs(T: int) -> int:
    """(query, key) pairs a causal head attends: T(T+1)/2."""
    return T * (T + 1) // 2


def in_image_taps(size: int, k: int) -> int:
    """Taps of a stride-1 SAME conv, along one dimension, that land
    inside the image, summed over the output positions: the padding
    taps multiply zeros, so the bound does not count them."""
    pad = (k - 1) // 2
    return sum(min(o - pad + k, size) - max(o - pad, 0) for o in range(size))


PROCESS_SIZES = (1, 7, 64, 512, 4096)  # rows of the Process requests, in turn
PROCESS_THREADS = 10
# The digits record (artifacts/real_digits_r03/RECORD.json): its command,
# run on the card, and its held-out results; the bar is BASELINE's 0.97.
DIGITS_TRAIN = ["--data", "digits", "--layers", "64,128,64,10", "--epochs", "40",
                "--lr-schedule", "cosine", "--warmup-steps", "50"]
DIGITS_RECORD = dict(accuracy=0.9805013927576601, f1_score=0.9805454271308642, bar=0.97)
# Full-width training: the reference's 784-128-64-10 recipe (batch 64,
# Adam 1e-3) on 60,000 seeded synthetic_mnist rows, 10,000 held out.
TRAIN_ROWS, TRAIN_EVAL_ROWS, TRAIN_BATCH, TRAIN_EPOCHS = 60000, 10000, 64, 3
RESUME_TOL = (1e-7, 1e-6)  # atol, rtol: tests/test_checkpoint.py:93's
CARD_CPU_LOSS_RTOL = 1e-4  # per-epoch losses, card vs CPU, TF32 off
PROCESS_STAGES = ("decode", "queue_wait", "stage", "launch", "fetch", "encode")


def process_requests(n_rows: int, sizes=PROCESS_SIZES) -> list[tuple[int, int]]:
    """(start, stop) row ranges cutting ``n_rows`` into requests of the
    sizes in turn."""
    out, a, i = [], 0, 0
    while a < n_rows:
        b = min(n_rows, a + sizes[i % len(sizes)])
        out.append((a, b))
        a, i = b, i + 1
    return out


def drive_handler(handler, payloads, threads=PROCESS_THREADS):
    """Send every payload through the Process handler body from
    ``threads`` threads, each taking the next request in turn. Returns
    the replies (bytes, or the RpcAbort raised) and each request's wall
    seconds, in payload order."""
    import threading

    from tpu_dist_nn_torch.serving.server import RpcAbort

    replies = [None] * len(payloads)
    walls = [0.0] * len(payloads)
    nxt = iter(range(len(payloads)))
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = next(nxt, None)
            if i is None:
                return
            t0 = time.perf_counter()
            try:
                replies[i] = handler(payloads[i])[0]
            except RpcAbort as e:
                replies[i] = e
            walls[i] = time.perf_counter() - t0

    pool = [threading.Thread(target=worker) for _ in range(threads)]
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    return replies, walls


def stage_medians(spans) -> dict[str, tuple[float, int]]:
    """Median milliseconds and count of each Process stage's spans."""
    import numpy as np

    by = {}
    for sp in spans:
        by.setdefault(sp.name, []).append(sp.dur * 1e3)
    return {name: (float(np.median(by[name])), len(by[name]))
            for name in ("rpc.Process", *PROCESS_STAGES) if name in by}


def fetched_batches(spans) -> list[int]:
    """Bucket rows of each launched batch: every member request of a
    batch records one ``fetch`` span with the batch's start time."""
    seen = {}
    for sp in spans:
        if sp.name == "fetch":
            seen[sp.t0] = sp.attrs["batch_rows"]
    return list(seen.values())


def socket_phase(grpc, eng, model_path, data, reqs, tmp) -> None:
    """The Process path over loopback gRPC: serve_engine and GrpcClient
    on the first requests, the CLI's ``up --grpc-port`` with ``infer
    --target`` against the local ``infer``, and the ``--serving`` bench."""
    import signal
    import threading

    import numpy as np

    from tpu_dist_nn_torch.cli import main as cli_main
    from tpu_dist_nn_torch.core.schema import save_examples
    from tpu_dist_nn_torch.serving.server import GrpcClient, serve_engine

    print(f"grpc: {grpc.__version__}")
    server, port = serve_engine(eng, 0, host="127.0.0.1")
    sub = reqs[:10]
    outs = [None] * len(sub)

    def worker(k):
        client = GrpcClient(f"127.0.0.1:{port}")
        try:
            for i in range(k, len(sub), 5):
                a, b = sub[i]
                outs[i] = client.process(data[a:b])
        finally:
            client.close()

    pool = [threading.Thread(target=worker, args=(k,)) for k in range(5)]
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    client = GrpcClient(f"127.0.0.1:{port}", retry=None)
    try:
        client.process(np.zeros((5, MNIST[0] - 1)))
        code, message = None, None
    except grpc.RpcError as e:
        code, message = e.code(), e.details()
    finally:
        client.close()
    batches = server.batcher.batches_total
    server.stop(0)
    diff = sum(int((o != eng.infer(data[a:b]).astype(np.float64)).sum())
               for (a, b), o in zip(sub, outs))
    want_msg = f"expected input of shape (N, {MNIST[0]}), got (5, {MNIST[0] - 1})"
    ok = diff == 0 and code == grpc.StatusCode.INVALID_ARGUMENT and message == want_msg
    print(f"check Process over loopback gRPC: {len(sub)} requests from 5 clients in {batches} "
          f"batches, not-bit-equal to Engine.infer alone {diff}; wrong width {code} "
          f"{message!r} | {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("Process over the socket disagrees with the engine or its status")

    # The CLI: up --grpc-port in a subprocess, infer --target against it.
    examples = tmp / "examples_256.json"
    labels = eng.infer(data[:256]).argmax(-1)
    save_examples(data[:256], labels, examples)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    cli = [sys.executable, "-m", "tpu_dist_nn_torch.cli"]
    up = subprocess.Popen(cli + ["up", "--config", str(model_path), "--grpc-port", "0",
                                 "--serve-seconds", "300", "--drain-grace-seconds", "2"],
                          cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True)
    try:
        lines = []
        for line in up.stdout:
            lines.append(line.strip())
            if '"grpc_port"' in line:
                break
        if not lines or '"grpc_port"' not in lines[-1]:
            fail(f"cli up printed no grpc_port: {lines} {up.stderr.read()[-2000:]}")
        target = f"127.0.0.1:{json.loads(lines[-1])['grpc_port']}"
        remote = subprocess.run(cli + ["infer", "--target", target, "--inputs", str(examples),
                                       "--batch-size", "64"],
                                cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    finally:
        up.send_signal(signal.SIGTERM)
        up_rc = up.wait(timeout=120)
        up_err = up.stderr.read()
    local = io.StringIO()
    with contextlib.redirect_stdout(local):
        local_rc = cli_main(["infer", "--config", str(model_path), "--inputs", str(examples),
                             "--batch-size", "64"])
    for label, rc, text in (("cli up", up_rc, "\n".join(lines)),
                            ("cli infer --target", remote.returncode, remote.stdout),
                            ("cli infer (this process)", local_rc, local.getvalue())):
        print(f"{label} (rc {rc}):")
        for line in text.strip().splitlines():
            print(f"  {line}")

    def accuracy(out):
        return [ln for ln in out.splitlines() if ln.startswith("Correct predictions")]

    ok = (up_rc == 0 and remote.returncode == 0 and local_rc == 0
          and accuracy(remote.stdout) and accuracy(remote.stdout) == accuracy(local.getvalue())
          and '"ready": true' in lines[0])
    print(f"check cli infer --target accuracy line equals the local infer's | "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"cli up / infer --target: {remote.stderr[-1500:]}\ncli up's stderr: "
             f"{up_err[-3000:]}")

    bench = subprocess.run([sys.executable, "-m", "tpu_dist_nn_torch.bench", "--serving"],
                           cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    print(f"bench --serving (rc {bench.returncode}): {bench.stdout.strip()}")
    if bench.returncode != 0:
        fail(f"bench --serving exited {bench.returncode}: {bench.stderr[-2000:]}")


def process_phase(dev, model, conv_model, data, rng, params, q, out_dir, smi_line, compare,
                  failures) -> None:
    """The reference's Process RPC in front of the port's engines on the
    card: in process through the handler body and the batcher (no
    grpcio), then over the socket where grpcio is installed."""
    import numpy as np
    import torch

    from tpu_dist_nn_torch.api.engine import Engine
    from tpu_dist_nn_torch.core.schema import save_model
    from tpu_dist_nn_torch.kernels import (
        KERNEL_WRAPPERS,
        fcnn_fused_forward,
        forward_quantized,
        reset_launch_counts,
    )
    from tpu_dist_nn_torch.obs.trace import TRACER
    from tpu_dist_nn_torch.serving.server import Batcher, RpcAbort, make_process_handler
    from tpu_dist_nn_torch.serving.wire import decode_matrix, encode_matrix
    from tpu_dist_nn_torch.testing.oracle import oracle_forward_batch
    from tpu_dist_nn_torch.utils.profiling import cuda_graph_time_ms

    print(f"Process path on {smi_line} (nvidia-smi name, power.limit)")
    t_phase = time.monotonic()
    spans = {}

    def serve(engine, spans_key, reqs, rows, depth=2, extra=None):
        """Requests of ``rows`` through a fresh batcher of ``depth``
        in front of ``engine``, counts zeroed just before and read just
        after; returns the decoded replies, walls, launches and the
        batcher."""
        payloads = [encode_matrix(rows[a:b]) for a, b in reqs]
        at = len(payloads) // 2
        if extra is not None:
            payloads.insert(at, extra)
        batcher = Batcher(engine, pipeline_depth=depth)
        handler = make_process_handler(engine, batcher)
        TRACER.reset()
        reset_launch_counts()
        replies, walls = drive_handler(handler, payloads)
        launches = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
        batcher.close()
        spans[spans_key] = TRACER.snapshot()
        bad = None
        if extra is not None:
            bad = replies.pop(at)
            walls.pop(at)
        aborted = [r for r in replies if isinstance(r, RpcAbort)]
        if aborted:
            fail(f"Process {spans_key}: {len(aborted)} requests aborted, first "
                 f"{aborted[0].code}: {aborted[0].message}")
        outs = [decode_matrix(r) for r in replies]
        return outs, walls, launches, batcher, bad

    def launch_check(label, launches, kernels, batcher, n_req):
        want = {k: n * batcher.batches_total for k, n in kernels.items()}
        got = {k: launches[k] for k in kernels}
        ok = got == want and 0 < batcher.batches_total < n_req
        print(f"check Process {label}: {n_req} requests in {batcher.batches_total} batches; "
              f"launches {json.dumps(got)}, expected {json.dumps(want)} | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"Process {label}: launches do not match the batches, or nothing coalesced")

    def alone_check(label, engine, reqs, rows, outs):
        """Each request's reply against Engine.infer on its rows alone."""
        diff = sum(int((o != engine.infer(rows[a:b]).astype(np.float64)).sum())
                   for (a, b), o in zip(reqs, outs))
        print(f"check Process {label} vs Engine.infer on each request's rows alone: "
              f"not-bit-equal {diff} | {'ok' if diff == 0 else 'FAIL'}")
        if diff:
            fail(f"Process {label}: a coalesced reply differs from its request alone")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=out_dir) as tmp:
        model_path = Path(tmp) / "mnist_fcnn.json"
        save_model(model, model_path)
        conv_path = Path(tmp) / "cifar_conv_mlp.json"
        save_model(conv_model, conv_path)

        # 1. In process: the handler body and the batcher, no socket.
        reqs = process_requests(len(data))
        eng = Engine.up(model_path, device=dev)
        t0 = time.perf_counter()
        outs, walls, launches, b32, _ = serve(eng, "f32", reqs, data)
        f32_wall = time.perf_counter() - t0
        print(f"Process f32 in process: {len(reqs)} requests ({len(data)} rows, sizes "
              f"{PROCESS_SIZES} in turn) from {PROCESS_THREADS} threads, depth 2: "
              f"{f32_wall:.4f} s wall, {len(data) / f32_wall:.1f} rows/s")
        launch_check("f32 depth 2", launches, {"fcnn_fused_forward": 1}, b32, len(reqs))
        got = np.concatenate(outs)
        o_err = float(np.abs(got - oracle_forward_batch(model, data)).max())
        print(f"check Process f32 replies vs float64 oracle ({len(data)} rows): max_abs "
              f"{o_err:.3e} | tol atol 1e-05 | {'ok' if o_err <= 1e-5 else 'FAIL'}")
        if o_err > 1e-5:
            fail("Process f32 replies disagree with the float64 oracle")
        alone_check("f32", eng, reqs, data, outs)

        # Serial (depth 1), with one wrong-width request among the others.
        bad_payload = encode_matrix(np.zeros((5, MNIST[0] - 1), np.float32))
        outs1, _, launches1, b1, bad = serve(eng, "f32 depth 1", reqs, data, depth=1,
                                             extra=bad_payload)
        launch_check("f32 depth 1", launches1, {"fcnn_fused_forward": 1}, b1, len(reqs))
        same = all(np.array_equal(a, b) for a, b in zip(outs, outs1))
        print(f"check Process depth 1 replies bit-equal to depth 2: {'ok' if same else 'FAIL'}")
        want_msg = f"expected input of shape (N, {MNIST[0]}), got (5, {MNIST[0] - 1})"
        ok = isinstance(bad, RpcAbort) and bad.code == "INVALID_ARGUMENT" and bad.message == want_msg
        print(f"check Process wrong width among {len(reqs)} served requests: "
              f"{getattr(bad, 'code', bad)} {getattr(bad, 'message', '')!r} | "
              f"{'ok' if ok else 'FAIL'}")
        if not (same and ok):
            fail("Process depth 1 differs from depth 2, or the wrong width was not refused alone")

        # int8: bit-equal to the int8 kernel on each request alone and
        # to the plain int8 chain on each request's rows (atol 0, rtol 0).
        engq = Engine.up(model_path, quantize="int8", device=dev)
        outsq, _, launchesq, bq, _ = serve(engq, "int8", reqs, data)
        launch_check("int8", launchesq, {"fcnn_quantized_forward": 1}, bq, len(reqs))
        alone_check("int8", engq, reqs, data, outsq)
        data_dev = torch.from_numpy(data).to(dev)
        plain = torch.cat([forward_quantized(q, data_dev[a:b]) for a, b in reqs]).cpu()
        compare("Process int8 replies vs plain forward_quantized on each request's rows",
                torch.from_numpy(np.concatenate(outsq)).float(), plain, 0.0, 0.0)
        del data_dev

        # The conv engine behind the handler: 1024 CIFAR rows.
        data_c = rng.uniform(0.0, 1.0, (CIFAR_BATCH, conv_model.input_dim)).astype(np.float32)
        reqs_c = process_requests(len(data_c), PROCESS_SIZES[:4])
        engc = Engine.up(conv_path, device=dev)
        outsc, _, launchesc, bc, _ = serve(engc, "conv", reqs_c, data_c)
        launch_check("conv", launchesc, {"fused_conv2d": 2, "fcnn_fused_forward": 1}, bc,
                     len(reqs_c))
        plain_c = Engine.up(conv_path, device="cpu").infer(data_c)
        compare("Process conv replies vs the plain versions (CPU engine)",
                torch.from_numpy(np.concatenate(outsc)).float(), torch.from_numpy(plain_c),
                *CONV_TOL)
        if failures:
            fail(f"Process checks failed: {failures}")

        # 2. Over the socket, where grpcio is installed.
        try:
            import grpc
        except ImportError:
            grpc = None
            print("grpc: not installed; socket phase not run")
        if grpc is not None:
            socket_phase(grpc, eng, model_path, data, reqs, Path(tmp))

    # 3. Numbers.
    for key, label in (("f32", "f32, depth 2"), ("f32 depth 1", "f32, depth 1"),
                       ("int8", "int8, depth 2"), ("conv", "conv, depth 2")):
        med = stage_medians(spans[key])
        print(f"Process stage medians ({label}): " + ", ".join(
            f"{name} {ms:.4f} ms (n={n})" for name, (ms, n) in med.items()))
    by_size = {}
    for (a, b), w in zip(reqs, walls):
        by_size.setdefault(b - a, []).append(w * 1e3)
    print("Process f32 request wall time by size (depth 2, 10 threads): " + ", ".join(
        f"{n} rows median {np.median(v):.3f} ms (n={len(v)})" for n, v in sorted(by_size.items())))
    buckets = fetched_batches(spans["f32"])
    xb = torch.from_numpy(np.resize(data, (max(buckets), data.shape[1]))).to(dev)
    kernel_ms = {n: cuda_graph_time_ms(lambda n=n: fcnn_fused_forward(params, xb[:n]), iters=20)
                 for n in sorted(set(buckets))}
    total = sum(kernel_ms[n] for n in buckets)
    print(f"Process f32 kernel device time for the same {len(buckets)} batches (buckets "
          f"{json.dumps(dict(sorted((n, buckets.count(n)) for n in set(buckets))))}): "
          f"{total:.4f} ms (CUDA graph a bucket: "
          f"{', '.join(f'{n} rows {ms:.4f} ms' for n, ms in kernel_ms.items())}) of "
          f"{f32_wall * 1e3:.1f} ms wall")
    del xb
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    bench = subprocess.run([sys.executable, "-m", "tpu_dist_nn_torch.bench"], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=600)
    print(f"bench (rc {bench.returncode}): {bench.stdout.strip()}")
    if bench.returncode != 0:
        fail(f"bench exited {bench.returncode}: {bench.stderr[-2000:]}")
    line = json.loads(bench.stdout.strip().splitlines()[-1])
    if line["backend"] != "cuda" or line["agreement"]["max_abs"] > 1e-5:
        fail(f"bench line: backend {line['backend']}, agreement {line['agreement']}")
    print(f"Process phase took {time.monotonic() - t_phase:.1f} s")


def train_phase(dev, model, data, out_dir, smi_line, compare, failures) -> None:
    """Native FCNN training on the card: the digits record's command
    through the CLI, full-width training through Engine.train with a
    checkpoint resume, card-vs-CPU losses, a trained int8 engine, and
    the int8 warm-up gate."""
    import numpy as np
    import torch

    from tpu_dist_nn_torch.api.engine import Engine
    from tpu_dist_nn_torch.checkpoint import CheckpointManager
    from tpu_dist_nn_torch.core.schema import load_model
    from tpu_dist_nn_torch.data.datasets import Dataset, real_digits, synthetic_mnist
    from tpu_dist_nn_torch.kernels import (
        KERNEL_WRAPPERS,
        fcnn_fused_forward,
        fcnn_quantized_forward,
        forward_quantized,
        quantize_fcnn,
        reset_launch_counts,
    )
    from tpu_dist_nn_torch.models.fcnn import init_fcnn, spec_from_params
    from tpu_dist_nn_torch.train.trainer import TrainConfig, train_fcnn

    print(f"train path on {smi_line} (nvidia-smi name, power.limit)")
    t_phase = time.monotonic()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}

    def counts():
        return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=out_dir) as tmp:
        tmp = Path(tmp)
        # (a) The digits record's command on the card, then the CLI's
        # infer of the exported model on the held-out digits.
        exported = tmp / "digits_model.json"
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_dist_nn_torch.cli", "train", *DIGITS_TRAIN,
             "--out", str(exported)],
            cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
        wall = time.monotonic() - t0
        if proc.returncode != 0:
            fail(f"cli train exited {proc.returncode}: {proc.stderr[-2000:]}")
        epochs = [ln.split(" - INFO - ")[-1] for ln in proc.stderr.splitlines() if "epoch " in ln]
        print(f"cli train {' '.join(DIGITS_TRAIN)}: {wall:.1f} s wall (process start, "
              f"kernel build and 40 epochs); first and last epochs: {epochs[0]} | {epochs[-1]}")
        got = load_model(exported).metadata["inference_metrics"]
        ok = (got["accuracy"] >= DIGITS_RECORD["bar"] and got["f1_score"] >= DIGITS_RECORD["bar"])
        print(f"check digits recipe on the card, held-out: accuracy {got['accuracy']:.4f} F1 "
              f"{got['f1_score']:.4f} (record {DIGITS_RECORD['accuracy']:.4f} / "
              f"{DIGITS_RECORD['f1_score']:.4f}; bar {DIGITS_RECORD['bar']}) | "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the digits recipe missed 0.97 held-out accuracy or F1 on the card")
        held = tmp / "digits_heldout.json"
        real_digits("test").to_examples_json(held)
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_dist_nn_torch.cli", "infer", "--config",
             str(exported), "--inputs", str(held)],
            cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("Metrics: ")]
        if proc.returncode != 0 or not lines:
            fail(f"cli infer of the trained model exited {proc.returncode}: {proc.stderr[-2000:]}")
        served = json.loads(lines[0][len("Metrics: "):])
        ok = served["accuracy"] == got["accuracy"]
        print(f"check cli infer of the exported model on the 359 held-out digits: accuracy "
              f"{served['accuracy']!r} vs the trainer's eval {got['accuracy']!r} | "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the served trained model's accuracy differs from the trainer's eval")

        # (b) Full width: Engine.up + Engine.train, eval each epoch.
        full = synthetic_mnist(TRAIN_ROWS + TRAIN_EVAL_ROWS, seed=0)
        train = Dataset(full.x[:TRAIN_ROWS], full.y[:TRAIN_ROWS], 10)
        held_out = Dataset(full.x[TRAIN_ROWS:], full.y[TRAIN_ROWS:], 10)
        spec = spec_from_params(init_fcnn(torch.Generator().manual_seed(0), MNIST, ACTS,
                                          device="cpu"), ACTS)
        cfg = TrainConfig(epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH, seed=0)
        eng = Engine.up(spec, device=dev)
        reset_launch_counts()
        t0 = time.monotonic()
        hist = eng.train(train, cfg, eval_data=held_out)
        wall = time.monotonic() - t0
        launches = counts()
        steps = TRAIN_ROWS // TRAIN_BATCH
        for h in hist:
            print(f"train 784-128-64-10 epoch {h['epoch']}: loss {h['loss']:.6f}, "
                  f"{h['seconds']:.3f} s ({steps} steps of {TRAIN_BATCH} rows: "
                  f"{h['seconds'] / steps:.6f} s/step, "
                  f"{steps * TRAIN_BATCH / h['seconds']:.1f} samples/s), held-out accuracy "
                  f"{h['eval']['accuracy']:.4f}")
        print(f"train 784-128-64-10: {wall:.3f} s wall for {TRAIN_EPOCHS} epochs with eval; "
              f"launches {json.dumps(launches)}")
        losses = [h["loss"] for h in hist]
        if len(hist) != TRAIN_EPOCHS or not all(math.isfinite(x) for x in losses) or \
                not all(b < a for a, b in zip(losses, losses[1:])):
            fail(f"full-width training: the mean loss did not fall every epoch: {losses}")
        eval_batches = TRAIN_EPOCHS * math.ceil(TRAIN_EVAL_ROWS / 1024)
        want = {k: (eval_batches if k == "fcnn_fused_forward" else 0) for k in launches}
        ok = launches == want
        print(f"check training launches: none in the {TRAIN_EPOCHS * steps} steps, one chain "
              f"launch per eval batch ({eval_batches}) | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("training launched a kernel inside a step, or eval missed the chain kernel")

        # 1 epoch, then a resume to 3: the straight run's weights.
        ckpt = CheckpointManager(tmp / "resume", keep=3)
        Engine.up(spec, device=dev).train(train, TrainConfig(epochs=1, batch_size=TRAIN_BATCH,
                                                             seed=0), checkpoints=ckpt)
        resumed = Engine.up(spec, device=dev)
        hist_r = resumed.train(train, cfg, checkpoints=ckpt)
        if len(hist_r) != TRAIN_EPOCHS - 1 or ckpt.latest_step() != TRAIN_EPOCHS:
            fail(f"resume re-ran {len(hist_r)} epochs to step {ckpt.latest_step()}")
        for i, (a, b) in enumerate(zip(resumed._params, eng._params)):
            for key in ("w", "b"):
                compare(f"resume 1 -> {TRAIN_EPOCHS} epochs vs straight, layer {i} {key}",
                        a[key], b[key], *RESUME_TOL)

        # (c) Two digits epochs on the card and on the CPU from one init.
        digits = real_digits("train")
        p0 = init_fcnn(torch.Generator().manual_seed(0), [64, 128, 64, 10], device="cpu")
        cfg_d = TrainConfig(epochs=2, batch_size=64, seed=0)
        _, h_card = train_fcnn([{**p, "w": p["w"].to(dev), "b": p["b"].to(dev)} for p in p0],
                               digits, cfg_d)
        _, h_cpu = train_fcnn(p0, digits, cfg_d)
        rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(h_card, h_cpu))
        ok = rel <= CARD_CPU_LOSS_RTOL
        print(f"check digits losses card vs CPU (2 epochs): {[h['loss'] for h in h_card]} vs "
              f"{[h['loss'] for h in h_cpu]}, max rel {rel:.3e} | tol rtol "
              f"{CARD_CPU_LOSS_RTOL:g} | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("training on the card and on the CPU disagree")

        # (d) A trained int8 engine serves the re-quantized trained weights.
        test = real_digits("test")
        spec_d = spec_from_params(p0, ACTS)
        engq = Engine.up(spec_d, quantize="int8", device=dev)
        stale = engq._q
        engq.train(digits, cfg_d)
        reset_launch_counts()
        got_q = torch.from_numpy(engq.infer(test.x))
        int8_launches = fcnn_quantized_forward.launches
        x_test = torch.from_numpy(test.x).to(dev)
        compare("trained int8 engine vs plain forward_quantized of the re-quantized weights",
                got_q, forward_quantized(quantize_fcnn(engq._params), x_test).cpu(), 0.0, 0.0)
        moved = int((got_q != forward_quantized(stale, x_test).cpu()).sum())
        ok = int8_launches == 1 and moved > 0
        print(f"check trained int8 engine: int8 launches {int8_launches}, outputs that moved "
              f"from the untrained int8 weights {moved} | {'ok' if ok else 'FAIL'}")
        if failures or not ok:
            fail(f"train checks failed: {failures or 'the trained int8 engine'}")

        # (e) The int8 warm-up gate, on: its verdict, then launches
        # that follow it (two batches of 8,192 rows).
        os.environ["TDN_INT8_AUTO"] = "1"
        try:
            engg = Engine.up(model, quantize="int8", warm_rows=BATCH, device=dev)
        finally:
            os.environ["TDN_INT8_AUTO"] = "0"
        kept = not engg.int8_auto_disabled
        reset_launch_counts()
        engg.run_inference(data[:2 * BATCH], batch_size=BATCH)
        launches = counts()
        want = {"fcnn_quantized_forward": 2 if kept else 0,
                "fcnn_fused_forward": 0 if kept else 2}
        ok = all(launches[k] == n for k, n in want.items())
        print(f"check int8 warm-up gate at {BATCH} rows: ratio f32/int8 "
              f"{engg.int8_speedup_ratio:.4f}, int8 {'kept' if kept else 'disabled'}; launches "
              f"over 2 batches {json.dumps({k: launches[k] for k in want})}, expected "
              f"{json.dumps(want)} | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the launches do not follow the int8 warm-up gate's decision")
    print(f"train phase took {time.monotonic() - t_phase:.1f} s")


PIPE_DEVICES = 3  # [1, 1, 1]: three stage slots (streams) on one card
PIPE_MICROBATCHES = 4
PIPE_CHURN_RUNS = 20
GRAD_TOL = (1e-6, 1e-4)  # atol, rtol: tests/test_pipeline_1f1b.py's gradients
LOSS_RTOL = 1e-5  # and its losses


def pipeline_phase(dev, model, data, resq, he_model, out_dir, smi_line, failures) -> None:
    """The layer-distribution pipeline on one card: ``[1, 1, 1]`` on
    three stage slots (one stream each) of ``dev``, f32 and int8, the
    interleaved placement of the 34-layer model, ``step_latency``,
    allocator churn, and training through the GPipe and 1F1B schedules
    (the digits record's recipe through ``[1, 1, 1]`` with 1F1B, and one
    full-width epoch of each)."""
    import numpy as np
    import torch

    from tpu_dist_nn_torch.api.engine import Engine
    from tpu_dist_nn_torch.core.schema import load_model, partition_model, save_model
    from tpu_dist_nn_torch.data.datasets import Dataset, real_digits, synthetic_mnist
    from tpu_dist_nn_torch.kernels import (
        KERNEL_WRAPPERS,
        fcnn_fused_forward,
        fcnn_quantized_forward,
        reset_launch_counts,
    )
    from tpu_dist_nn_torch.kernels.fused_dense import activation_ids, chain_plan, int8_plan
    from tpu_dist_nn_torch.models.fcnn import init_fcnn, spec_from_params
    from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh
    from tpu_dist_nn_torch.parallel.pipeline import build_pipeline_params
    from tpu_dist_nn_torch.testing.oracle import oracle_forward_batch
    from tpu_dist_nn_torch.train.metrics import classification_metrics
    from tpu_dist_nn_torch.train.pipeline_trainer import (
        pipeline_loss_and_grad,
        prepare_pipeline_batch,
        train_pipelined,
    )
    from tpu_dist_nn_torch.train.trainer import TrainConfig
    from tpu_dist_nn_torch.utils.profiling import cuda_graph_time_ms

    print(f"pipeline path on {smi_line} (nvidia-smi name, power.limit)")
    t_phase = time.monotonic()
    slots = [dev] * PIPE_DEVICES
    M = PIPE_MICROBATCHES

    def counts():
        return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=out_dir) as tmp:
        tmp = Path(tmp)
        model_path = tmp / "mnist_fcnn.json"
        save_model(model, model_path)
        one = Engine.up(model_path)
        onq = Engine.up(model_path, quantize="int8")
        eng = Engine.up(model_path, [1, 1, 1], devices=slots, num_microbatches=M)
        engq = Engine.up(model_path, [1, 1, 1], devices=slots, num_microbatches=M,
                         quantize="int8")
        place = eng.placement()
        print(f"pipelined placement: {json.dumps(place)}")
        if not place["pipelined"] or place["num_stages"] != 3:
            fail("Engine.up(model, [1, 1, 1], devices=3 slots) did not place a 3-stage pipeline")

        # (a) 60,000 rows at batch 8,192, f32 and int8, beside the single
        # program in turns (one, pipeline, pipeline, one).
        n_batches = math.ceil(ROWS / BATCH)
        runs = {}
        for label, e in (("one f32", one), ("pipeline f32", eng), ("pipeline f32 ", eng),
                         ("one f32 ", one), ("one int8", onq), ("pipeline int8", engq),
                         ("pipeline int8 ", engq), ("one int8 ", onq)):
            reset_launch_counts()
            res = e.run_inference(data, batch_size=BATCH)
            runs.setdefault(label.strip(), []).append((res, counts()))
        for label, got in runs.items():
            for res, c in got:
                lat = res.latency_summary()
                print(f"{label}: {ROWS / res.seconds:.1f} samples/s ({res.seconds:.4f} s for "
                      f"{ROWS} rows at batch {BATCH}), batch p50 {lat['p50_s'] * 1e3:.3f} ms; "
                      f"launches {json.dumps({k: n for k, n in c.items() if n})}")
        want_launches = {"pipeline f32": ("fcnn_fused_forward", 3 * M * n_batches),
                         "pipeline int8": ("fcnn_quantized_forward", 3 * M * n_batches)}
        for label, (kname, n) in want_launches.items():
            got = [c[kname] for _, c in runs[label]]
            ok = got == [n, n]
            print(f"check {label} launches: {kname} {got} per run, expected stages x "
                  f"microbatches x batches = 3 x {M} x {n_batches} = {n} | "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"the pipelined {label} run did not launch {kname} once a stage a "
                     "microbatch")
        res32 = runs["pipeline f32"][0][0]
        o_err = float(np.abs(res32.outputs - oracle_forward_batch(model, data)).max())
        print(f"check pipeline f32 vs float64 oracle ({ROWS} rows): max_abs {o_err:.3e} | "
              f"tol atol 1e-05 | {'ok' if o_err <= 1e-5 else 'FAIL'}")
        if o_err > 1e-5:
            fail("the pipelined f32 outputs disagree with the float64 oracle")
        for label, ref in (("pipeline int8", resq.outputs),
                           ("pipeline int8 (second run)", runs["pipeline int8"][1][0].outputs)):
            got = runs["pipeline int8"][0][0].outputs
            diff = int((got != ref).sum())
            print(f"check {label} vs the single-program int8 engine: not-bit-equal {diff} | "
                  f"{'ok' if diff == 0 else 'FAIL'}")
            if diff:
                fail("the int8 pipeline is not bit-equal to the single-program int8 engine")

        # The chain at the pipeline's row split: each stage's launch on
        # 2,048 rows (8,192 in 4 microbatches) beside the whole chain on
        # 8,192; device time (a CUDA graph of 50 calls), TF32 off.
        xd = torch.from_numpy(data[:BATCH]).to(dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for label, stages, whole, fn in (
                ("f32", eng._placed.chunks[0], one._params, fcnn_fused_forward),
                ("int8", engq._q.chunks[0], onq._q, fcnn_quantized_forward)):
            h, per_stage = xd[:BATCH // M], []
            for layers in stages:
                per_stage.append(cuda_graph_time_ms(lambda h=h, layers=layers: fn(layers, h)))
                h = fn(layers, h)
            ms_whole = cuda_graph_time_ms(lambda: fn(whole, xd))
            dims0 = [MNIST[0], MNIST[1]]
            plan = (chain_plan(dims0, activation_ids(ACTS[:1]), BATCH // M, sms,
                               torch.cuda.current_device()) if label == "f32"
                    else int8_plan(dims0, BATCH // M, sms))
            print(f"time {label} stage launches at {BATCH // M} rows: "
                  f"{', '.join(f'{ms:.4f}' for ms in per_stage)} ms (stages 1-3), x {M} "
                  f"microbatches = {M * sum(per_stage):.4f} ms a batch, vs the whole chain at "
                  f"{BATCH} rows {ms_whole:.4f} ms; stage 1's plan at {BATCH // M} rows: {plan}")

        # (b) One batch 20 times under allocator churn, every run in
        # flight before the first fetch: bit-equal run to run.
        xb = data[:BATCH]
        ref = eng.infer(xb)
        pending = []
        reset_launch_counts()
        junk_rng = np.random.default_rng(1)
        for _ in range(PIPE_CHURN_RUNS):
            pending.append(eng.infer_async(xb))
            for row in eng.mesh.slots:
                with torch.cuda.stream(row[0].stream):
                    n = int(junk_rng.integers(1 << 16, 1 << 20))
                    torch.empty(n, device=dev).fill_(float("nan"))
            torch.empty(int(junk_rng.integers(1 << 16, 1 << 20)), device=dev).fill_(float("nan"))
        outs = [eng.fetch(p) for p in pending]
        churn_launches = counts()["fcnn_fused_forward"]
        diff = sum(int((o != ref).sum()) for o in outs)
        ok = diff == 0 and churn_launches == 3 * M * PIPE_CHURN_RUNS
        print(f"check {PIPE_CHURN_RUNS} runs of one {BATCH}-row batch in flight together under "
              f"allocator churn (NaN-filled blocks on every stage stream): not-bit-equal {diff}, "
              f"chain launches {churn_launches} | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("pipelined runs under allocator churn are not bit-equal run to run")

        # (c) step_latency, pipelined and single program.
        for label, e in (("pipeline [1, 1, 1]", eng), ("one program", one)):
            lat = e.step_latency(batch_size=256)
            print(f"step_latency {label} at batch 256: p50 {lat['p50_s'] * 1e3:.4f} ms, p99 "
                  f"{lat['p99_s'] * 1e3:.4f} ms, num_stages {lat['num_stages']}, "
                  f"p50_per_stage {lat['p50_per_stage_s'] * 1e3:.4f} ms")

        # (d) The interleaved placement of the 34-layer model: [9, 9, 8, 8]
        # at virtual_stages 2 on two slots, f32 and int8.
        dims34 = [16] * 35
        model34 = he_model(dims34, ["relu"] * 33 + ["softmax"], seed=len(dims34) + dims34[1])
        x34 = np.random.default_rng(34).uniform(0.0, 1.0, (2048, 16)).astype(np.float32)
        for quant in (None, "int8"):
            single = Engine.up(model34, quantize=quant).infer(x34)
            e34 = Engine.up(model34, [9, 9, 8, 8], virtual_stages=2, devices=[dev] * 2,
                            num_microbatches=M, quantize=quant)
            reset_launch_counts()
            got = e34.infer(x34)
            c = counts()
            kname = "fcnn_quantized_forward" if quant else "fcnn_fused_forward"
            label = f"interleaved 34-layer [9, 9, 8, 8] v=2 {quant or 'f32'}"
            if quant:
                diff = int((got != single).sum())
                ok = diff == 0
                detail = f"not-bit-equal to the single-program int8 engine {diff}"
            else:
                e_one = float(np.abs(got - single).max())
                e_orc = float(np.abs(got - oracle_forward_batch(model34, x34)).max())
                ok = e_one <= 1e-5 and e_orc <= 1e-5
                detail = (f"max_abs vs the single-program engine {e_one:.3e}, vs the float64 "
                          f"oracle {e_orc:.3e} (tol atol 1e-05)")
            ok = ok and c[kname] == 4 * M
            print(f"check {label}: placement {e34.placement()['slots']}, {detail}, {kname} "
                  f"launches {c[kname]} (4 chunks x {M} microbatches) | {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"the {label} engine disagrees with its single-program engine")

        # (e) The digits record's recipe through [1, 1, 1] with 1F1B.
        digits, test = real_digits("train"), real_digits("test")
        sizes, acts = [64, 128, 64, 10], ["relu", "relu", "softmax"]
        spec = spec_from_params(init_fcnn(torch.Generator().manual_seed(0), sizes, acts,
                                          device="cpu"), acts)
        eng_d = Engine.up(spec, [1, 1, 1], devices=slots, num_microbatches=M)
        cfg_d = TrainConfig(epochs=40, batch_size=64, lr_schedule="cosine", warmup_steps=50,
                            seed=0)
        t0 = time.monotonic()
        hist = eng_d.train(digits, cfg_d, eval_data=test, schedule="1f1b")
        wall = time.monotonic() - t0
        steps = len(digits) // 64
        acc = hist[-1]["eval"]["accuracy"]
        exported = tmp / "digits_1f1b.json"
        eng_d.export(exported, metrics=hist[-1]["eval"])
        served = Engine.up(load_model(exported), [3]).infer(test.x)
        served_acc = classification_metrics(served, test.y, 10)["accuracy"]
        ok = acc >= DIGITS_RECORD["bar"] and served_acc == acc
        print(f"check digits recipe through [1, 1, 1] with schedule 1f1b: {wall:.2f} s for 40 "
              f"epochs ({wall / (40 * steps) * 1e3:.3f} ms/step with eval), losses "
              f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.6f}, held-out accuracy {acc:.4f} "
              f"F1 {hist[-1]['eval']['f1_score']:.4f} (bar {DIGITS_RECORD['bar']}); the "
              f"exported model on one program {served_acc!r} | {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the digits recipe through the 1F1B pipeline missed 0.97 held-out, or the "
                 "exported model serves at another accuracy")

        # (f) One full-width epoch: gpipe and 1f1b beside one program.
        full = synthetic_mnist(TRAIN_ROWS, seed=0)
        train = Dataset(full.x, full.y, 10)
        spec = spec_from_params(init_fcnn(torch.Generator().manual_seed(0), MNIST, ACTS,
                                          device="cpu"), ACTS)
        pp = build_pipeline_params(partition_model(spec, [1, 1, 1]))
        mesh = build_mesh(MeshSpec(stage=3), slots)
        batch = prepare_pipeline_batch(pp.meta, full.x[:TRAIN_BATCH], full.y[:TRAIN_BATCH], M, 1)
        first = {s: pipeline_loss_and_grad(mesh, pp, *batch, schedule=s, num_microbatches=M)
                 for s in ("gpipe", "1f1b")}
        (lg, gg), (lf, gf) = first["gpipe"], first["1f1b"]
        g_err = max(float(np.abs(a - b).max()) for a, b in ((gg.w, gf.w), (gg.b, gf.b)))
        ok = (abs(lg - lf) <= LOSS_RTOL * abs(lg)
              and all(np.allclose(a, b, atol=GRAD_TOL[0], rtol=GRAD_TOL[1])
                      for a, b in ((gg.w, gf.w), (gg.b, gf.b))))
        print(f"check first-step loss and grads, gpipe vs 1f1b (784-128-64-10, batch "
              f"{TRAIN_BATCH}, {M} microbatches): loss {lg!r} vs {lf!r}, grads max_abs "
              f"{g_err:.3e} | tol loss rtol {LOSS_RTOL:g}, grads atol {GRAD_TOL[0]:g} rtol "
              f"{GRAD_TOL[1]:g} | {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("gpipe vs 1f1b first step")
        steps = TRAIN_ROWS // TRAIN_BATCH
        cfg = TrainConfig(epochs=1, batch_size=TRAIN_BATCH, seed=0)
        one_t = Engine.up(spec)
        reset_launch_counts()
        for label in ("gpipe", "1f1b", "one program"):
            if label == "one program":
                h = one_t.train(train, cfg)
            else:
                _, h = train_pipelined(pp, mesh, train, cfg, num_microbatches=M, schedule=label)
            sec = h[0]["seconds"]
            print(f"train 784-128-64-10 one epoch, {label}: loss {h[0]['loss']:.6f}, {sec:.3f} s "
                  f"({steps} steps of {TRAIN_BATCH}: {sec / steps * 1e3:.4f} ms/step, "
                  f"{steps * TRAIN_BATCH / sec:.1f} samples/s)")
            if not math.isfinite(h[0]["loss"]):
                failures.append(f"{label} epoch loss")
        if any(counts().values()):
            failures.append(f"training launched a kernel: {counts()}")
    if failures:
        fail(f"pipeline checks failed: {failures}")
    print(f"pipeline phase took {time.monotonic() - t_phase:.1f} s")


def main() -> None:
    if not (ROOT / "tpu_dist_nn_torch" / "kernels" / "csrc").is_dir():
        fail("tpu_dist_nn_torch/ is not beside chip_smoke.py: run it from a "
             "checkout of the repository")
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from tpu_dist_nn_torch.api.engine import Engine
    from tpu_dist_nn_torch.cli import main as cli_main
    from tpu_dist_nn_torch.core.activations import apply_activation
    from tpu_dist_nn_torch.core.schema import LayerSpec, ModelSpec, save_examples, save_model
    from tpu_dist_nn_torch.kernels import (
        KERNEL_WRAPPERS,
        _build,
        fcnn_fused_forward,
        fcnn_fused_forward_plain,
        fcnn_quantized_forward,
        flash_bwd,
        flash_bwd_f32,
        flash_bwd_plain,
        flash_bwd_sm90,
        flash_fwd,
        flash_fwd_f32,
        flash_fwd_plain,
        flash_fwd_sm90,
        forward_quantized,
        fused_conv2d,
        fused_conv2d_plain,
        fused_dense,
        fused_dense_plain,
        quantize_fcnn,
        reset_launch_counts,
    )
    from tpu_dist_nn_torch.data.text import encode, lm_batches, lm_sequences, load_corpus
    from tpu_dist_nn_torch.kernels.flash_attention import bf16_rounding_bounds, flash_attention
    from tpu_dist_nn_torch.kernels.conv2d import conv_plan
    from tpu_dist_nn_torch.kernels.fused_dense import (
        _buffer_widths,
        _chain_smem,
        activation_ids,
        chain_plan,
        chain_segments,
        dense_plan,
        int8_plan,
        max_clusters,
    )
    from tpu_dist_nn_torch.models.fcnn import params_from_spec
    from tpu_dist_nn_torch.models.transformer import (
        TransformerConfig,
        dot_product_attention,
        init_transformer,
        lm_loss,
        num_params,
        param_leaves,
        tree_map,
    )
    from tpu_dist_nn_torch.train.lm_trainer import LMTrainConfig, evaluate_lm, train_lm
    from tpu_dist_nn_torch.models.network import (
        build_network,
        dense_forward,
        init_conv_mlp,
        network_forward,
    )
    from tpu_dist_nn_torch.testing.oracle import oracle_forward_batch
    from tpu_dist_nn_torch.utils.profiling import LatencyStats, cuda_graph_time_ms, cuda_time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The int8 warm-up gate may reroute a quantized engine to the f32
    # chain where its host-bound timing says int8 is slower; every int8
    # check below holds the int8 kernel itself, so the gate only
    # measures and warns (the CLI subprocesses inherit this). The train
    # phase turns it on for its own gate check.
    os.environ["TDN_INT8_AUTO"] = "0"
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {name} x{torch.cuda.device_count()}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e}")
    print("card (nvidia-smi name, power.limit):")
    print(smi[0])
    part, (mem_rate, f32_rate, i8_rate, bf16_rate, tf32_rate) = peaks_for(name)
    print(f"peaks used for bounds (H100 {part} data sheet): {mem_rate / 1e12:g} TB/s, "
          f"{f32_rate / 1e12:g} TFLOP/s FP32, {i8_rate / 1e12:g} TOP/s INT8, "
          f"{bf16_rate / 1e12:g} TFLOP/s BF16, {tf32_rate / 1e12:g} TFLOP/s TF32")

    # ---------------------------------------------------------- 1. build
    t0 = time.monotonic()
    _build.launcher("fused_dense")
    print(f"kernel build: {_build.build_seconds:.1f} s compile, "
          f"{time.monotonic() - t0:.1f} s with load")
    for lib in _build.LIBRARIES:
        log = _build.library_path(lib).with_suffix(".log")
        for line in log.read_text().splitlines() if log.is_file() else []:
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas {lib}: {line.split('ptxas info    :')[-1].strip()}")

    # ------------------------------------- 2. kernels vs plain versions
    rng = np.random.default_rng(0)
    failures: list[str] = []

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def compare(label, got, want, atol, rtol):
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        max_abs = float(diff.max()) if diff.numel() else 0.0
        max_rel = (float((diff / want.float().abs().clamp_min(max(atol, 1e-30))).max())
                   if diff.numel() else 0.0)
        ok = (got.shape == want.shape and bool(torch.isfinite(got).all())
              and bool(torch.allclose(got, want, atol=atol, rtol=rtol)))
        exact = int((got != want).sum())
        print(f"check {label}: shape {tuple(got.shape)} max_abs {max_abs:.3e} "
              f"max_rel {max_rel:.3e} not-bit-equal {exact} | tol atol {atol:g} "
              f"rtol {rtol:g} | {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
        return max_abs

    def he_model(sizes, acts, seed):
        r = np.random.default_rng(seed)
        layers = []
        for i, act in enumerate(acts):
            fi, fo = sizes[i], sizes[i + 1]
            layers.append(LayerSpec(
                weights=r.normal(0.0, math.sqrt(2.0 / fi), (fi, fo)),
                biases=r.normal(0.0, 0.05, (fo,)),
                activation=act,
                type_tag="output" if i == len(acts) - 1 else "hidden",
            ))
        return ModelSpec(layers=layers)

    model = he_model(MNIST, ACTS, seed=1)
    params = params_from_spec(model, device=dev)
    x = on_card(rng.uniform(0.0, 1.0, (BATCH, MNIST[0])).astype(np.float32))
    w1, b1 = params[0]["w"], params[0]["b"]
    err = {}

    # fused_dense: the flagship's first layer under every activation, the
    # softmax head (N = 10), and a ragged M. f32 FFMA vs cuBLAS f32.
    for act in ["linear", "relu", "sigmoid", "tanh", "gelu", "softmax"]:
        e = compare(f"fused_dense 8192x784->128 {act}", fused_dense(x, w1, b1, activation=act),
                    fused_dense_plain(x, w1, b1, act), 1e-5, 1e-5)
        if act == "relu":
            err["fused_dense"] = e
    h2 = on_card(rng.uniform(0.0, 1.0, (BATCH, 64)).astype(np.float32))
    compare("fused_dense 8192x64->10 softmax",
            fused_dense(h2, params[2]["w"], params[2]["b"], activation="softmax"),
            fused_dense_plain(h2, params[2]["w"], params[2]["b"], "softmax"), 1e-5, 1e-5)
    compare("fused_dense 8191x784->128 relu (ragged M)",
            fused_dense(x[:8191], w1, b1, activation="relu"),
            fused_dense_plain(x[:8191], w1, b1, "relu"), 1e-5, 1e-5)

    # fcnn_fused_forward: tolerance of tests/test_kernels.py's chain checks.
    err["fcnn_fused_chain"] = compare(
        "fcnn_fused_forward 784-128-64-10 f32 x8192",
        fcnn_fused_forward(params, x), fcnn_fused_forward_plain(params, x), 2e-5, 1e-4)
    compare("fcnn_fused_forward 784-128-64-10 f32 x8191 (ragged)",
            fcnn_fused_forward(params, x[:8191]), fcnn_fused_forward_plain(params, x[:8191]),
            2e-5, 1e-4)
    xu8 = on_card(rng.integers(0, 256, (BATCH, MNIST[0])).astype(np.uint8))
    compare("fcnn_fused_forward 784-128-64-10 uint8 x8192 input_scale=1/255",
            fcnn_fused_forward(params, xu8, input_scale=1.0 / 255.0),
            fcnn_fused_forward_plain(params, xu8, input_scale=1.0 / 255.0), 2e-5, 1e-4)

    # The f32 tile's schedules: the planners' choices at the main shapes;
    # split-K across a cluster (the conv network's 2048-64-10 dense tail
    # at batch 1024, its ragged 1023, 37 rows, a ragged K of 2000, uint8
    # input); softmax normalised in the epilogue (N fits one tile) and in
    # a second pass over stored rows (N = 300); every kernel twice on the
    # same input, bit for bit (split-K adds the ranks' partials in rank
    # order, no atomics).
    def repeat_check(label, fn):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        ok = bool(torch.equal(a, b))
        print(f"check {label}: two calls bit-equal | {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{label} repeat")

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    conv_model = init_conv_mlp(torch.Generator().manual_seed(0))
    bias_rng = np.random.default_rng(3)
    for layer in conv_model.layers:
        if layer.kind != "maxpool2d":
            layer.biases = bias_rng.normal(0.0, 0.05, layer.biases.shape)
    plan_c, params_c = build_network(conv_model, device=dev)
    tail_at = [i for i, lp in enumerate(plan_c) if lp.kind == "dense"]
    tail = [{"w": params_c[i]["w"], "b": params_c[i]["b"],
             "act": activation_ids([plan_c[i].activation])[0]} for i in tail_at]
    tail_dims = [int(tail[0]["w"].shape[0])] + [int(p["w"].shape[1]) for p in tail]
    tail_acts = [plan_c[i].activation for i in tail_at]
    tail_tag = "-".join(map(str, tail_dims)) + " " + ",".join(tail_acts)
    print(f"plan fused_dense 8192x784->128 on {sms} SMs: (tm, tn) {dense_plan(BATCH, 128, sms)}")
    ld0_, ld1_ = _buffer_widths(tail_dims, activation_ids(tail_acts))
    for tm_, split_ in ((64, 8), (72, 8), (64, 4), (64, 2)):
        n_clusters = max_clusters(torch.cuda.current_device(), tm_, split_,
                                  _chain_smem(tm_, ld0_, ld1_), sms)
        print(f"clusters of {split_} CTAs of {tm_} rows ({tail_tag}) the card runs at once: "
              f"{n_clusters}")
    for label, dims_, acts_, rows in (("784-128-64-10", MNIST, ACTS, BATCH),
                                      (tail_tag, tail_dims, tail_acts, CIFAR_BATCH),
                                      (tail_tag, tail_dims, tail_acts, 37)):
        print(f"plan fcnn_fused_forward {label} x{rows} on {sms} SMs: "
              f"{chain_plan(dims_, activation_ids(acts_), rows, sms, torch.cuda.current_device())}")
    rng_tail = np.random.default_rng(5)
    x_tail = on_card(rng_tail.uniform(0.0, 1.0, (CIFAR_BATCH, tail_dims[0])).astype(np.float32))
    for rows in (CIFAR_BATCH, CIFAR_BATCH - 1, 37):
        e = compare(f"fcnn_fused_forward conv tail {tail_tag} f32 x{rows} (split-K)",
                    fcnn_fused_forward(tail, x_tail[:rows]),
                    fcnn_fused_forward_plain(tail, x_tail[:rows]), 2e-5, 1e-4)
        if rows == CIFAR_BATCH:
            err["fcnn_fused_chain_conv_tail"] = e
    xu8_tail = (x_tail * 255).to(torch.uint8)
    compare(f"fcnn_fused_forward conv tail {tail_tag} uint8 x{CIFAR_BATCH} input_scale=1/255 "
            "(split-K)", fcnn_fused_forward(tail, xu8_tail, input_scale=1.0 / 255.0),
            fcnn_fused_forward_plain(tail, xu8_tail, input_scale=1.0 / 255.0), 2e-5, 1e-4)
    ragged_k = params_from_spec(he_model([2000, 64, 10], ["relu", "softmax"], seed=4), device=dev)
    x_2000 = x_tail[:, :2000].contiguous()
    for rows in (CIFAR_BATCH, 37):
        compare(f"fcnn_fused_forward 2000-64-10 f32 x{rows} (split-K, ragged K)",
                fcnn_fused_forward(ragged_k, x_2000[:rows]),
                fcnn_fused_forward_plain(ragged_k, x_2000[:rows]), 2e-5, 1e-4)
    wide_head = params_from_spec(he_model([784, 128, 300], ["relu", "softmax"], seed=5),
                                 device=dev)
    compare("fcnn_fused_forward 784-128-300 softmax x8191 (softmax past one pass)",
            fcnn_fused_forward(wide_head, x[:8191]), fcnn_fused_forward_plain(wide_head, x[:8191]),
            2e-5, 1e-4)
    h128 = x[:, :128].contiguous()
    w300, b300 = wide_head[1]["w"], wide_head[1]["b"]
    compare("fused_dense 8192x128->300 softmax (second pass)",
            fused_dense(h128, w300, b300, activation="softmax"),
            fused_dense_plain(h128, w300, b300, "softmax"), 1e-5, 1e-5)
    repeat_check("fused_dense 8192x784->128 relu",
                 lambda: fused_dense(x, w1, b1, activation="relu"))
    repeat_check("fcnn_fused_forward 784-128-64-10 x8192", lambda: fcnn_fused_forward(params, x))
    repeat_check(f"fcnn_fused_forward conv tail {tail_tag} x{CIFAR_BATCH} (split-K)",
                 lambda: fcnn_fused_forward(tail, x_tail))
    repeat_check(f"fcnn_fused_forward conv tail {tail_tag} x37 (split-K)",
                 lambda: fcnn_fused_forward(tail, x_tail[:37]))

    # int8 chain: the kernel repeats the plain chain's arithmetic, so relu
    # interiors with a softmax head agree to a few ulps of the softmax
    # (rtol 1e-6, atol 1e-7). A gelu/tanh interior may differ from
    # torch's by an ulp, which can move the next layer's code by one:
    # atol 1e-2 there.
    q = quantize_fcnn(params)
    wide = he_model([1024, 1024, 1024, 10], ACTS, seed=2)
    q_wide = quantize_fcnn(params_from_spec(wide, device=dev))
    x_wide = on_card(rng.uniform(0.0, 1.0, (BATCH, 1024)).astype(np.float32))
    for dims_, rows in ((MNIST, BATCH), (MNIST, 37), ([1024, 1024, 1024, 10], BATCH)):
        print(f"plan fcnn_quantized_forward {'-'.join(map(str, dims_))} x{rows} on {sms} SMs: "
              f"{int8_plan(dims_, rows, sms)}")
    for rows in (BATCH, BATCH - 1, 37):
        e = compare(f"fcnn_quantized_forward 784-128-64-10 x{rows}",
                    fcnn_quantized_forward(q, x[:rows]), forward_quantized(q, x[:rows]),
                    1e-7, 1e-6)
        if rows == BATCH:
            err["int8_chain"] = e
        compare(f"fcnn_quantized_forward 1024-1024-1024-10 x{rows}",
                fcnn_quantized_forward(q_wide, x_wide[:rows]),
                forward_quantized(q_wide, x_wide[:rows]), 1e-7, 1e-6)
    # relu and linear interiors and a linear head: bit for bit.
    q_lin = quantize_fcnn(params_from_spec(he_model(MNIST, ["relu", "linear", "linear"], seed=6),
                                           device=dev))
    for rows in (BATCH, BATCH - 1, 37):
        got_, want_ = fcnn_quantized_forward(q_lin, x[:rows]), forward_quantized(q_lin, x[:rows])
        compare(f"fcnn_quantized_forward 784-128-64-10 relu,linear,linear x{rows} (bit-equal)",
                got_, want_, 0.0, 0.0)
    q_gelu = quantize_fcnn(params_from_spec(
        he_model(MNIST, ["gelu", "tanh", "softmax"], seed=3), device=dev))
    compare("fcnn_quantized_forward 784-128-64-10 gelu,tanh,softmax x8192",
            fcnn_quantized_forward(q_gelu, x), forward_quantized(q_gelu, x), 1e-2, 0.0)
    repeat_check("fcnn_quantized_forward 784-128-64-10 x8192", lambda: fcnn_quantized_forward(q, x))
    repeat_check("fcnn_quantized_forward 784-128-64-10 x37",
                 lambda: fcnn_quantized_forward(q, x[:37]))
    # A 60000-wide input (its codes made 1024 columns at a time) and a
    # 60000-wide interior (cut in two launches by chain_segments).
    for dims_ in ([60000, 16, 10], [64, 60000, 10]):
        q_60k = quantize_fcnn(params_from_spec(he_model(dims_, ["relu", "softmax"], seed=7),
                                               device=dev))
        x_60k = on_card(rng.uniform(0.0, 1.0, (256, dims_[0])).astype(np.float32))
        cut = chain_segments(dims_, activation_ids(["relu", "softmax"]), "int8")
        compare(f"fcnn_quantized_forward {'-'.join(map(str, dims_))} x256 ({len(cut)} launch"
                f"{'es' if len(cut) > 1 else ''})", dense_forward(q_60k, x_60k, quantized=True),
                forward_quantized(q_60k, x_60k), 1e-7, 1e-6)
        del q_60k, x_60k

    # fused_conv2d: the CIFAR conv+MLP network's two conv+pool stages at
    # batch 1024 and a ragged 1023, every activation, and the variants
    # the network does not use (VALID, stride 2, overlapping pool, an
    # even kernel). Direct f32 FFMA vs the plain tap-sum (cuBLAS f32).
    c1, c2 = conv_model.layers[0], conv_model.layers[2]
    cw1, cb1, cw2, cb2 = (on_card(a.astype(np.float32)) for a in (
        c1.weights, c1.biases, c2.weights, c2.biases))
    img1 = on_card(rng.uniform(0.0, 1.0, (CIFAR_BATCH, 32, 32, 3)).astype(np.float32))
    img2 = on_card(rng.uniform(0.0, 1.0, (CIFAR_BATCH, 16, 16, 16)).astype(np.float32))
    pool2 = dict(padding="same", pool_window=(2, 2))

    def conv_check(label, imgs, w, b, **kw):
        return compare(f"fused_conv2d {label}", fused_conv2d(imgs, w, b, **kw),
                       fused_conv2d_plain(imgs, w, b, **kw), *CONV_TOL)

    conv_errs = []
    for rows in (CIFAR_BATCH, CIFAR_BATCH - 1):
        conv_errs.append(conv_check(f"conv1+pool 32x32x3->16 relu x{rows}", img1[:rows],
                                    cw1, cb1, activation="relu", **pool2))
        conv_errs.append(conv_check(f"conv2+pool 16x16x16->32 relu x{rows}", img2[:rows],
                                    cw2, cb2, activation="relu", **pool2))
    for act in ["linear", "sigmoid", "tanh", "gelu", "softmax"]:
        conv_check(f"conv2+pool 16x16x16->32 {act} x{CIFAR_BATCH}", img2, cw2, cb2,
                   activation=act, **pool2)
    conv_check(f"conv1+pool 32x32x3->16 softmax over 16 channels x{CIFAR_BATCH}", img1, cw1,
               cb1, activation="softmax", **pool2)
    conv_check(f"conv2 16x16x16->32 VALID relu, no pool x{CIFAR_BATCH}", img2, cw2, cb2,
               padding="valid", activation="relu")
    conv_check(f"conv1 32x32x3->16 stride 2 SAME relu x{CIFAR_BATCH}", img1, cw1, cb1,
               stride=(2, 2), padding="same", activation="relu")
    conv_check(f"conv1 32x32x3->16 SAME relu + 3x3/2 pool x{CIFAR_BATCH}", img1, cw1, cb1,
               padding="same", activation="relu", pool_window=(3, 3), pool_stride=(2, 2))
    w4 = on_card(rng.normal(0.0, math.sqrt(2.0 / 256), (4, 4, 16, 32)).astype(np.float32))
    conv_check(f"conv 4x4 16x16x16->32 SAME tanh x{CIFAR_BATCH}", img2, w4, cb2,
               padding="same", activation="tanh")
    err["fused_conv2d"] = max(conv_errs)
    for label, shape_, w_shape_, kw_ in (
            ("conv1+pool", (CIFAR_BATCH, 32, 32, 3), (3, 3, 3, 16), pool2),
            ("conv2+pool", (CIFAR_BATCH, 16, 16, 16), (3, 3, 16, 32), pool2)):
        print(f"plan fused_conv2d {label} x{shape_[0]}: {conv_plan(shape_, w_shape_, **kw_)}")
    # Ragged and odd shapes of the implicit GEMM's tiles: an odd 31x29
    # image with overlapping 3x3 stride-2 windows, stride 2 VALID, and the
    # two layers a band planner refused (K streams 16 and 64 input
    # channels a slice), He-scaled weights on uniform pixels.
    img_odd = on_card(rng.uniform(0.0, 1.0, (CIFAR_BATCH - 1, 31, 29, 3)).astype(np.float32))
    conv_check(f"conv1 31x29x3->16 SAME relu + 3x3/2 pool x{CIFAR_BATCH - 1}", img_odd, cw1, cb1,
               padding="same", activation="relu", pool_window=(3, 3), pool_stride=(2, 2))
    conv_check(f"conv2 16x16x16->32 stride 2 VALID relu x{CIFAR_BATCH - 1}",
               img2[:CIFAR_BATCH - 1], cw2, cb2, stride=(2, 2), padding="valid",
               activation="relu")
    for shape_, w_shape_ in (((1, 64, 64, 256), (3, 3, 256, 256)),
                             ((1, 3, 32, 1024), (3, 3, 1024, 1))):
        fan_in = w_shape_[0] * w_shape_[1] * w_shape_[2]
        img_f4 = on_card(rng.uniform(0.0, 1.0, shape_).astype(np.float32))
        w_f4 = on_card(rng.normal(0.0, math.sqrt(2.0 / fan_in), w_shape_).astype(np.float32))
        b_f4 = on_card(rng.normal(0.0, 0.05, w_shape_[3]).astype(np.float32))
        plan_f4 = conv_plan(shape_, w_shape_, padding="same")
        conv_check(f"conv {shape_} x {w_shape_} SAME relu ({plan_f4.slices} K slices of "
                   f"{plan_f4.ck} channels, grid {plan_f4.grid})", img_f4, w_f4, b_f4,
                   padding="same", activation="relu")
    repeat_check(f"fused_conv2d conv2+pool x{CIFAR_BATCH}",
                 lambda: fused_conv2d(img2, cw2, cb2, activation="relu", **pool2))

    # Flash attention, both routes, against the plain versions, q, k and
    # v read as the three strided views of one fused projection as the
    # transformer passes them, lse and delta from the plain forward:
    # "f32" calls tdn_flash_fwd_f32 and tdn_flash_bwd_f32 by name
    # (float32; dq is summed with atomics, so it is compared within the
    # tolerance, never bit for bit); "sm90" goes through the routed
    # flash_fwd / flash_bwd with bf16, which must reach
    # tdn_flash_fwd_sm90 and tdn_flash_bwd_sm90. bf16 kernels against the
    # plain version in float32 on the same bf16 inputs (BF16_RTOL more
    # rtol, and bf16_rounding_bounds); lse is float32 always.
    def flash_inputs(B, T, H, Dh, dtype, seed):
        r = np.random.default_rng(seed)
        qkv = on_card(r.standard_normal((B, T, 3 * H, Dh)).astype(np.float32)).to(dtype)
        do = on_card(r.standard_normal((B, T, H, Dh)).astype(np.float32)).to(dtype)
        return (*qkv.split(H, dim=2), do)

    def compare_bound(label, got, want, bound, atol, rtol):
        torch.cuda.synchronize()
        diff = (got.float() - want).abs()
        excess = float((diff - (atol + rtol * want.abs() + bound)).max())
        ok = got.shape == want.shape and bool(torch.isfinite(got).all()) and excess <= 0.0
        print(f"check {label}: shape {tuple(got.shape)} max_abs {float(diff.max()):.3e} "
              f"largest share of bound {float((diff / (atol + rtol * want.abs() + bound)).max()):.3f}"
              f" | tol atol {atol:g} rtol {rtol:g} + bf16 rounding bound | "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
        return float(diff.max())

    def flash_check(label, B, T, H, Dh, causal, dtype, route, seed=0):
        q, k, v, do = flash_inputs(B, T, H, Dh, dtype, seed)
        extra = BF16_RTOL if dtype == torch.bfloat16 else 0.0
        (fa, fr), (ga, gr) = FLASH_TOL, FLASH_GRAD_TOL
        qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
        scale = 1.0 / math.sqrt(Dh)
        tag = f"{label} {route} B{B} T{T} H{H} Dh{Dh} " \
              f"{'causal' if causal else 'bidirectional'} {str(dtype).split('.')[-1]}"
        o_ref, lse_ref = flash_fwd_plain(qf, kf, vf, scale=scale, causal=causal)
        delta = (dof * o_ref).sum(-1).transpose(1, 2).contiguous()
        before = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
        if route == "f32":
            o, lse = flash_fwd_f32(q, k, v, causal=causal)
            e_fwd = compare(f"flash_fwd_f32 o {tag}", o, o_ref, fa, fr)
            compare(f"flash_fwd_f32 lse {tag}", lse, lse_ref, fa, fr)
            grads = flash_bwd_f32(q, k, v, do, lse_ref, delta, causal=causal)
            refs = flash_bwd_plain(qf, kf, vf, dof, lse_ref, delta, scale=scale, causal=causal)
            e_bwd = max(compare(f"flash_bwd_f32 {name} {tag}", g, ref, ga, gr)
                        for name, g, ref in zip(("dq", "dk", "dv"), grads, refs))
            del grads, refs
            want = {"flash_fwd_f32": 1, "flash_bwd_f32": 1}
            errs = (e_fwd, e_bwd)
        else:
            b_o, b_dq, b_dk, b_dv = bf16_rounding_bounds(qf, kf, vf, dof, lse_ref, delta,
                                                         scale=scale, causal=causal)
            o, lse = flash_fwd(q, k, v, causal=causal)
            e_fwd = compare_bound(f"flash_fwd_sm90 o {tag}", o, o_ref, b_o, fa, fr + extra)
            compare(f"flash_fwd_sm90 lse {tag}", lse, lse_ref, fa, fr)
            grads = flash_bwd(q, k, v, do, lse_ref, delta, causal=causal)
            refs = flash_bwd_plain(qf, kf, vf, dof, lse_ref, delta, scale=scale, causal=causal)
            rounded = flash_bwd_plain(qf, kf, vf, dof, lse_ref, delta, scale=scale,
                                      causal=causal, round_bf16=True)
            e_bwd = 0.0
            for name, g, ref, rref, bound in zip(("dq", "dk", "dv"), grads, refs, rounded,
                                                 (b_dq, b_dk, b_dv)):
                e_bwd = max(e_bwd, compare_bound(f"flash_bwd_sm90 {name} {tag}", g, ref.float(),
                                                 bound, ga, gr + extra))
                print(f"  vs the plain backward with P and dS rounded to bf16: max_abs "
                      f"{float((g.float() - rref.float()).abs().max()):.3e}")
                del ref, rref, bound
            want = {"flash_fwd_sm90": 1, "flash_bwd_sm90": 1}
            errs = (e_fwd, e_bwd)
        ran = {fn.__name__: fn.launches - before[fn.__name__] for fn in KERNEL_WRAPPERS}
        if {k: n for k, n in ran.items() if n} != want:
            print(f"check {tag} route: launches {ran}, expected {want} | FAIL")
            failures.append(f"route {tag}")
        del o_ref
        torch.cuda.empty_cache()
        return errs

    B_LM, H_LM, T_LM, DH_LM = LM["batch"], LM["heads"], LM["seq_len"], LM["d_model"] // LM["heads"]
    err["flash_fwd_f32"], err["flash_bwd_f32"] = flash_check(
        "main shape", B_LM, T_LM, H_LM, DH_LM, True, torch.float32, "f32")
    err["flash_fwd_sm90"], err["flash_bwd_sm90"] = flash_check(
        "main shape", B_LM, T_LM, H_LM, DH_LM, True, torch.bfloat16, "sm90")
    for i, (T, Dh, causal) in enumerate([(1000, 64, False), (40, 64, True), (1000, 32, True),
                                         (40, 32, False), (1000, 128, True), (40, 128, False),
                                         (129, 64, True)]):
        flash_check("ragged", 2, T, 4, Dh, causal, torch.float32, "f32", seed=1 + i)
        flash_check("ragged", 2, T, 4, Dh, causal, torch.bfloat16, "sm90", seed=1 + i)
    DH_RC = RECIPE["d_model"] // RECIPE["heads"]
    flash_check("recipe shape", RECIPE["batch"], RECIPE["seq_len"], RECIPE["heads"], DH_RC,
                True, torch.float32, "f32")
    if failures:
        fail(f"kernel checks failed: {failures}")

    # ------------------------------------------------------ 3. main path
    data = rng.uniform(0.0, 1.0, (ROWS, MNIST[0])).astype(np.float32)
    out_dir = ROOT / ".chip_smoke"  # scratch inside the checkout (.gitignore lists it)
    out_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=out_dir) as tmp:
        model_path = Path(tmp) / "mnist_fcnn.json"
        save_model(model, model_path)

        reset_launch_counts()
        eng = Engine.up(model_path, [1, 1, 1])
        res32 = eng.run_inference(data, batch_size=BATCH)
        engq = Engine.up(model_path, [1, 1, 1], quantize="int8")
        before = fcnn_quantized_forward.launches
        resq = engq.run_inference(data, batch_size=BATCH)
        int8_batch_launches = fcnn_quantized_forward.launches - before

        labels = res32.outputs[:256].argmax(-1)
        examples = Path(tmp) / "examples_256.json"
        save_examples(data[:256], labels, examples)
        cli = subprocess.run(
            [sys.executable, "-m", "tpu_dist_nn_torch.cli", "infer", "--config",
             str(model_path), "--inputs", str(examples), "--batch-size", "64",
             "--quantize", "int8"],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT)},
        )
        doctor_rc = cli_main(["doctor"])
        launches = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}

    print(f"main path launches: {json.dumps(launches)}")
    print(f"cli infer --quantize int8 (rc {cli.returncode}):")
    for line in cli.stdout.strip().splitlines():
        print(f"  {line}")
    if cli.returncode != 0:
        fail(f"cli infer exited {cli.returncode}: {cli.stderr[-2000:]}")
    if "Correct predictions" not in cli.stdout:
        fail("cli infer printed no accuracy line")
    if doctor_rc != 0:
        fail(f"cli doctor exited {doctor_rc}")
    missing = [k for k in DENSE_PATH_KERNELS if launches[k] < 1]
    if missing:
        fail(f"kernels never launched on the dense main path: {missing}")
    n_batches = math.ceil(ROWS / BATCH)
    print(f"int8 run_inference: kernel launches {int8_batch_launches} for {n_batches} batches")
    if int8_batch_launches != n_batches:
        fail("the int8 engine run did not go through the int8 kernel once per batch")

    for label, res in (("f32", res32), ("int8", resq)):
        if res.outputs.shape != (ROWS, MNIST[-1]) or not np.isfinite(res.outputs).all():
            fail(f"{label} engine outputs: shape {res.outputs.shape} or non-finite values")
    want = oracle_forward_batch(model, data[:2048])
    o_err = float(np.abs(res32.outputs[:2048] - want).max())
    print(f"check engine f32 vs float64 oracle (2048 rows): max_abs {o_err:.3e} | tol atol 1e-05"
          f" | {'ok' if o_err <= 1e-5 else 'FAIL'}")
    if o_err > 1e-5:
        fail("f32 engine outputs disagree with the float64 oracle")
    compare("engine int8 vs plain forward_quantized (60000 rows)",
            torch.from_numpy(resq.outputs), forward_quantized(q, on_card(data)).cpu(),
            1e-7, 1e-6)
    if failures:
        fail(f"main-path checks failed: {failures}")
    agree = float((resq.outputs.argmax(-1) == res32.outputs.argmax(-1)).mean())
    print(f"int8 vs f32 argmax agreement: {agree:.4f}")

    # uint8 rows through the dense f32 engine reach the chain kernel as
    # they are (scale 1): bit-equal to the same rows cast to float32.
    rows_u8 = rng.integers(0, 256, (BATCH, MNIST[0])).astype(np.uint8)
    for n_u8 in (BATCH, 37):
        reset_launch_counts()
        got_u8 = eng.infer(rows_u8[:n_u8])
        u8_launches = fcnn_fused_forward.launches
        want_u8 = eng.infer(rows_u8[:n_u8].astype(np.float32))
        ok = u8_launches == 1 and np.array_equal(got_u8, want_u8)
        print(f"check engine f32 uint8 rows x{n_u8} vs the rows cast to float32: not-bit-equal "
              f"{int((got_u8 != want_u8).sum())}, chain launches {u8_launches} | "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("uint8 rows through the dense engine differ from the float32 rows")

    # ------------------------------------------ the layer pipeline path
    pipeline_phase(dev, model, data, resq, he_model, out_dir, smi[0], failures)

    # ------------------------------------------------- the train path
    train_phase(dev, model, data, out_dir, smi[0], compare, failures)

    # ------------------------------------------------ the Process path
    process_phase(dev, model, conv_model, data, rng, params, q, out_dir, smi[0], compare,
                  failures)

    # Dense runs past one chain launch: deeper than 32 layers or wider
    # than a chain's shared memory holds. chain_segments cuts each; every
    # engine's counts are zeroed before its run (4 batches) and read after.
    for label, dims_, quant, n_seg in (("34-layer 16-wide f32", [16] * 35, None, 2),
                                       ("34-layer 16-wide int8", [16] * 35, "int8", 2),
                                       ("784-4000-10 f32", [784, 4000, 10], None, 2),
                                       ("64-8192-10 f32", [64, 8192, 10], None, 2),
                                       ("60000-16-10 int8", [60000, 16, 10], "int8", 1),
                                       ("64-60000-10 int8", [64, 60000, 10], "int8", 2)):
        acts_ = ["relu"] * (len(dims_) - 2) + ["softmax"]
        model_ = he_model(dims_, acts_, seed=len(dims_) + dims_[1])
        rows_ = 256 if dims_[0] > 10000 else 2048
        data_ = rng.uniform(0.0, 1.0, (rows_, dims_[0])).astype(np.float32)
        eng_ = Engine.up(model_, quantize=quant)
        reset_launch_counts()
        res_ = eng_.run_inference(data_, batch_size=rows_ // 4)
        counts_ = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
        cut = chain_segments(dims_, activation_ids(acts_), quant or "float32")
        chain_key = "fcnn_quantized_forward" if quant else "fcnn_fused_forward"
        print(f"engine past one chain, {label}: cut {[tuple(sg) for sg in cut]}; launches over 4 "
              f"batches {json.dumps({k: n for k, n in counts_.items() if n})}: "
              f"{counts_[chain_key] / 4:g} chain launches a batch")
        if (len(cut) != n_seg or counts_[chain_key] != 4 * sum(not sg.dense for sg in cut)
                or counts_["fused_dense"] != 4 * sum(sg.dense for sg in cut)):
            fail(f"the {label} engine did not launch one kernel per segment per batch")
        if quant:
            q_ = quantize_fcnn(params_from_spec(model_, device=dev))
            compare(f"engine {label} vs plain forward_quantized ({rows_} rows)",
                    torch.from_numpy(res_.outputs), forward_quantized(q_, on_card(data_)).cpu(),
                    1e-7, 1e-6)
        else:
            o_err = float(np.abs(res_.outputs - oracle_forward_batch(model_, data_)).max())
            print(f"check engine {label} vs float64 oracle ({rows_} rows): max_abs {o_err:.3e} | "
                  f"tol atol 1e-05 | {'ok' if o_err <= 1e-5 else 'FAIL'}")
            if o_err > 1e-5:
                failures.append(f"engine {label}")
        del eng_, res_, data_
    if failures:
        fail(f"engines past one chain failed: {failures}")

    # The conv path: the CIFAR-10 conv+MLP network, each conv with its
    # pool in one fused_conv2d launch and the dense tail in one chain
    # launch per batch.
    data_c = rng.uniform(0.0, 1.0, (CIFAR_ROWS, conv_model.input_dim)).astype(np.float32)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=out_dir) as tmp:
        conv_path = Path(tmp) / "cifar_conv_mlp.json"
        save_model(conv_model, conv_path)

        reset_launch_counts()
        engc = Engine.up(conv_path, [2, 2, 2])
        before = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
        resc = engc.run_inference(data_c, batch_size=CIFAR_BATCH)
        run_launches = {fn.__name__: fn.launches - before[fn.__name__]
                        for fn in KERNEL_WRAPPERS}
        examples_c = Path(tmp) / "cifar_examples_256.json"
        save_examples(data_c[:256], resc.outputs[:256].argmax(-1), examples_c)
        cli_c = subprocess.run(
            [sys.executable, "-m", "tpu_dist_nn_torch.cli", "infer", "--config",
             str(conv_path), "--inputs", str(examples_c), "--batch-size", "64"],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT)},
        )
        conv_launches = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}

    c_batches = math.ceil(CIFAR_ROWS / CIFAR_BATCH)
    print(f"conv main path launches: {json.dumps(conv_launches)}")
    print(f"conv run_inference over {CIFAR_ROWS} rows at batch {CIFAR_BATCH} ({c_batches} "
          f"batches): launches {json.dumps(run_launches)}")
    print(f"cli infer conv model (rc {cli_c.returncode}):")
    for line in cli_c.stdout.strip().splitlines():
        print(f"  {line}")
    if cli_c.returncode != 0:
        fail(f"cli infer on the conv model exited {cli_c.returncode}: {cli_c.stderr[-2000:]}")
    if "Correct predictions" not in cli_c.stdout:
        fail("cli infer on the conv model printed no accuracy line")
    missing = [k for k in CONV_PATH_KERNELS if conv_launches[k] < 1]
    if missing:
        fail(f"kernels never launched on the conv main path: {missing}")
    if (run_launches["fused_conv2d"] != 2 * c_batches
            or run_launches["fcnn_fused_forward"] != c_batches):
        fail("the conv engine run did not launch fused_conv2d twice and the chain kernel "
             "once per batch")
    if resc.outputs.shape != (CIFAR_ROWS, 10) or not np.isfinite(resc.outputs).all():
        fail(f"conv engine outputs: shape {resc.outputs.shape} or non-finite values")
    # 128 rows spread over every batch of the run, the ragged last one
    # and the run's last row included.
    picked = np.linspace(0, CIFAR_ROWS - 1, 128).round().astype(int)
    want = oracle_forward_batch(conv_model, data_c[picked])
    c_err = float(np.abs(resc.outputs[picked] - want).max())
    print(f"check conv engine vs float64 oracle (128 rows across all {c_batches} batches): "
          f"max_abs {c_err:.3e} | tol atol 1e-05 | {'ok' if c_err <= 1e-5 else 'FAIL'}")
    if c_err > 1e-5:
        fail("conv engine outputs disagree with the float64 oracle")

    # The LM training path. The corpus is read, tokenised and split as
    # the CLI does it (95/5), before the counts are zeroed.
    text, source = load_corpus()
    rows = lm_sequences(encode(text), LM["seq_len"])
    split = max(1, int(len(rows) * 0.95))
    train_rows, eval_rows = rows[:split], rows[split:]
    print(f"corpus {source}: {len(text)} bytes, {len(train_rows)} train and {len(eval_rows)} "
          f"held-out rows of {LM['seq_len'] + 1} tokens")

    def lm_config(layers, dtype, remat):
        return TransformerConfig(vocab_size=256, d_model=LM["d_model"], n_heads=LM["heads"],
                                 n_layers=layers, d_ff=4 * LM["d_model"],
                                 max_seq_len=LM["seq_len"], compute_dtype=dtype, remat=remat)

    # Training parity at full width, depth 2, float32, batch 4: the flash
    # kernels against the materialised dot_product_attention, both passed
    # explicitly, from the same weights and batches.
    cfg2 = lm_config(2, "float32", False)
    params2 = init_transformer(torch.Generator().manual_seed(1), cfg2, device=dev)
    stream = lm_batches(train_rows, 4, seed=1, epochs=None)
    batches2 = [next(stream) for _ in range(3)]
    tokens2 = torch.from_numpy(batches2[0]).to(dev)
    grads = {}
    for label, attn in (("flash", flash_attention), ("dot_product", dot_product_attention)):
        p = tree_map(lambda a: a.clone().requires_grad_(True), params2)
        loss = lm_loss(p, tokens2, cfg2, attn)
        grads[label] = (float(loss.detach()), torch.autograd.grad(loss, param_leaves(p)))
    print(f"parity first-step loss: flash {grads['flash'][0]!r} dot_product "
          f"{grads['dot_product'][0]!r}")
    g_err = max(float((a - b).abs().max())
                for a, b in zip(grads["flash"][1], grads["dot_product"][1]))
    g_ok = all(torch.allclose(a, b, atol=5e-4, rtol=5e-4)
               for a, b in zip(grads["flash"][1], grads["dot_product"][1]))
    print(f"check parity first-step gradients ({len(grads['flash'][1])} leaves): max_abs "
          f"{g_err:.3e} | tol atol 5e-4 rtol 5e-4 | {'ok' if g_ok else 'FAIL'}")
    del grads
    train_cfg2 = LMTrainConfig(learning_rate=LM["lr"], steps=3, batch_size=4,
                               seq_len=LM["seq_len"], log_every=1)

    def parity_steps(cfg_p, params_p):
        """3 steps with the flash kernels (their launches counted alone:
        the route's own path) and 3 with dot_product_attention."""
        reset_launch_counts()
        hist_flash = train_lm(params_p, cfg_p, batches2, train_cfg2, attn_fn=flash_attention)[1]
        counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
        hist_ref = train_lm(params_p, cfg_p, batches2, train_cfg2,
                            attn_fn=dot_product_attention)[1]
        return (np.array([h["loss"] for h in hist_flash]),
                np.array([h["loss"] for h in hist_ref]), counts)

    l_flash, l_ref, f32_launches = parity_steps(cfg2, params2)
    rel = np.abs(l_flash - l_ref) / np.abs(l_ref)
    p_ok = len(l_flash) == 3 and rel[0] <= 1e-5 and rel.max() <= 1e-4
    print(f"check parity 3 float32 steps (768/12 heads, depth 2, T 1024, batch 4): flash "
          f"{l_flash.tolist()} vs dot_product {l_ref.tolist()}, rel {rel.tolist()} | tol "
          f"first 1e-5, all 1e-4 | {'ok' if p_ok else 'FAIL'}")
    # The float32 LM twin: 2 layers x 3 steps, no remat, on the f32 kernels.
    want_f32 = {"flash_fwd_f32": 6, "flash_bwd_f32": 6}
    print(f"float32 LM twin launches: {json.dumps(f32_launches)}; expected {json.dumps(want_f32)}"
          " and no sm90 launch")
    f32_route_ok = (all(f32_launches[k] == n for k, n in want_f32.items())
                    and f32_launches["flash_fwd_sm90"] == f32_launches["flash_bwd_sm90"] == 0)
    if not (g_ok and p_ok and f32_route_ok):
        fail("float32 training with the flash kernels disagrees with dot_product_attention "
             "or did not take the f32 kernels")
    del params2

    # The same in bf16 (the LM path's dtype), on the sm90 kernels.
    cfg2b = lm_config(2, "bfloat16", False)
    params2b = init_transformer(torch.Generator().manual_seed(1), cfg2b, device=dev)
    l_flash, l_ref, bf16_launches = parity_steps(cfg2b, params2b)
    rel = np.abs(l_flash - l_ref) / np.abs(l_ref)
    first_tol, all_tol = BF16_PARITY_RTOL
    pb_ok = (len(l_flash) == 3 and np.isfinite(l_flash).all() and rel[0] <= first_tol
             and rel.max() <= all_tol and bf16_launches["flash_fwd_sm90"] == 6
             and bf16_launches["flash_bwd_sm90"] == 6
             and bf16_launches["flash_fwd_f32"] == bf16_launches["flash_bwd_f32"] == 0)
    print(f"check parity 3 bf16 steps (768/12 heads, depth 2, T 1024, batch 4): sm90 flash "
          f"{l_flash.tolist()} vs dot_product {l_ref.tolist()}, rel {rel.tolist()} | tol "
          f"first {first_tol:g}, all {all_tol:g}; launches {json.dumps(bf16_launches)} | "
          f"{'ok' if pb_ok else 'FAIL'}")
    if not pb_ok:
        fail("bf16 training with the sm90 flash kernels disagrees with dot_product_attention")
    del params2b
    torch.cuda.empty_cache()

    # The main path: the 85M recipe through train_lm and evaluate_lm.
    cfg = lm_config(LM["layers"], "bfloat16", True)
    lm_params = init_transformer(torch.Generator().manual_seed(0), cfg, device=dev)
    n_params = num_params(lm_params)
    train_cfg = LMTrainConfig(learning_rate=LM["lr"], steps=LM["steps"],
                              batch_size=LM["batch"], seq_len=LM["seq_len"], log_every=1,
                              warmup_steps=LM["warmup"], lr_schedule="cosine")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    lm_params, history = train_lm(lm_params, cfg,
                                  lm_batches(train_rows, LM["batch"], seed=0, epochs=None),
                                  train_cfg)
    lm_eval = evaluate_lm(lm_params, cfg, eval_rows, batch_size=LM["batch"],
                          max_batches=LM["eval_batches"])
    lm_launches = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    print(f"LM parameters: {n_params:,} (record: {LM['params']:,})")
    for h in history:
        print(f"  LM step {h['step']}: loss {h['loss']!r} at {h['seconds']:.4f} s")
    losses = [h["loss"] for h in history]
    lm_steady = (history[-1]["seconds"] - history[4]["seconds"]) / (len(history) - 5)
    tokens_per_step = LM["batch"] * LM["seq_len"]
    print(f"LM steady (steps 6-{len(history)}): {lm_steady:.4f} s/step, "
          f"{tokens_per_step / lm_steady:.1f} tokens/s; steps 1-5 (warm-up) took "
          f"{history[4]['seconds']:.3f} s")
    print(f"LM held-out ({lm_eval['eval_rows_used']} rows): loss "
          f"{lm_eval['loss_nats_per_token']!r} nats/token, perplexity "
          f"{lm_eval['perplexity']!r}, {float(lm_eval['bits_per_byte'])!r} bits/byte")
    print(f"LM peak CUDA memory: {peak_gb:.3f} GB")
    want_launches = {
        "flash_fwd_sm90": LM["steps"] * LM["layers"] * 2 + LM["layers"] * LM["eval_batches"],
        "flash_bwd_sm90": LM["steps"] * LM["layers"],
        "flash_fwd_f32": 0, "flash_bwd_f32": 0,
    }
    print(f"LM main path launches: {json.dumps(lm_launches)}; expected {json.dumps(want_launches)}")
    if n_params != LM["params"]:
        fail(f"the LM has {n_params} parameters, not {LM['params']}")
    if len(losses) != LM["steps"] or not all(math.isfinite(x) for x in losses):
        fail(f"LM losses: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"the LM's last loss {losses[-1]} is not below its first {losses[0]}")
    if not math.isfinite(lm_eval["loss_nats_per_token"]):
        fail(f"LM held-out loss {lm_eval['loss_nats_per_token']}")
    if any(lm_launches[k] != v for k, v in want_launches.items()):
        fail("the LM main path did not launch the flash kernels the expected number of times")
    del lm_params
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=out_dir) as tmp:
        metrics = Path(tmp) / "lm_metrics.jsonl"
        cli_lm = subprocess.run(
            [sys.executable, "-m", "tpu_dist_nn_torch.cli", "lm", "--d-model", "768",
             "--heads", "12", "--layers", "2", "--seq-len", "1024", "--steps", "4",
             "--batch-size", "4", "--bf16", "--remat", "--lr", "3e-4", "--lr-schedule",
             "cosine", "--warmup-steps", "1", "--eval-batches", "2", "--log-every", "1",
             "--metrics-out", str(metrics)],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT)},
        )
        n_metrics = len(metrics.read_text().splitlines()) if metrics.is_file() else 0
    print(f"cli lm (rc {cli_lm.returncode}): {cli_lm.stdout.strip()}")
    if cli_lm.returncode != 0:
        fail(f"cli lm exited {cli_lm.returncode}: {cli_lm.stderr[-2000:]}")
    report = json.loads(cli_lm.stdout.strip().splitlines()[-1])
    keys = {"train_seconds", "final_train_loss", "eval_split", "loss_nats_per_token",
            "perplexity", "bits_per_byte", "eval_rows_used"}
    if set(report) != keys or report["eval_split"] != "held-out" or n_metrics != 6:
        fail(f"cli lm report keys {sorted(report)} or {n_metrics} metrics lines (want 6)")

    # The float32 LM main path: tdn lm's default recipe, as cmd_lm runs it
    # (corpus split 95/5, weights from the seed, batches from the seed,
    # the whole held-out split in full batches), each step stamped after
    # its loss sync (log_every 1; cmd_lm's default logs every 50th, which
    # changes no number).
    text_rc, source_rc = load_corpus(ROOT / RECIPE["corpus"])
    rows_rc = lm_sequences(encode(text_rc), RECIPE["seq_len"])
    split_rc = max(1, int(len(rows_rc) * 0.95))
    train_rc, eval_rc = rows_rc[:split_rc], rows_rc[split_rc:]
    cfg_rc = TransformerConfig(vocab_size=256, d_model=RECIPE["d_model"],
                               n_heads=RECIPE["heads"], n_layers=RECIPE["layers"],
                               d_ff=4 * RECIPE["d_model"], max_seq_len=RECIPE["seq_len"])
    params_rc = init_transformer(torch.Generator().manual_seed(RECIPE["seed"]), cfg_rc,
                                 device=dev)
    train_cfg_rc = LMTrainConfig(learning_rate=RECIPE["lr"], steps=RECIPE["steps"],
                                 batch_size=RECIPE["batch"], seq_len=RECIPE["seq_len"],
                                 warmup_steps=RECIPE["warmup"], lr_schedule="cosine",
                                 log_every=1)
    print(f"recipe corpus {source_rc}: {len(text_rc)} bytes, {len(train_rc)} train and "
          f"{len(eval_rc)} held-out rows of {RECIPE['seq_len'] + 1} tokens; "
          f"{num_params(params_rc):,} parameters, float32")
    torch.cuda.synchronize()
    reset_launch_counts()
    params_rc, hist_rc = train_lm(
        params_rc, cfg_rc, lm_batches(train_rc, RECIPE["batch"], seed=RECIPE["seed"], epochs=None),
        train_cfg_rc)
    eval_rc_m = evaluate_lm(params_rc, cfg_rc, eval_rc, batch_size=RECIPE["batch"])
    rc_launches = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    losses_rc = [h["loss"] for h in hist_rc]
    for h in hist_rc:
        if h["step"] in (1, 2, 3) or h["step"] % 50 == 0:
            print(f"  recipe step {h['step']}: loss {h['loss']!r} at {h['seconds']:.4f} s")
    warm = RECIPE["warmup"]
    rc_steady = (hist_rc[-1]["seconds"] - hist_rc[warm - 1]["seconds"]) / (len(hist_rc) - warm)
    print(f"recipe steady (steps {warm + 1}-{len(hist_rc)}): {rc_steady:.6f} s/step, "
          f"{RECIPE['batch'] * RECIPE['seq_len'] / rc_steady:.1f} tokens/s; steps 1-{warm} took "
          f"{hist_rc[warm - 1]['seconds']:.3f} s")
    rc_loss = eval_rc_m["loss_nats_per_token"]
    print(f"recipe held-out ({eval_rc_m['eval_rows_used']} rows): loss {rc_loss!r} nats/token, "
          f"perplexity {eval_rc_m['perplexity']!r}, {float(eval_rc_m['bits_per_byte'])!r} "
          f"bits/byte; record {RECIPE['loss']} / {RECIPE['perplexity']} / "
          f"{RECIPE['bits_per_byte']} (TPU twin perplexity 12.5648)")
    rc_batches = eval_rc_m["eval_rows_used"] // RECIPE["batch"]
    want_rc = {"flash_fwd_f32": RECIPE["steps"] * RECIPE["layers"] + rc_batches * RECIPE["layers"],
               "flash_bwd_f32": RECIPE["steps"] * RECIPE["layers"],
               "flash_fwd_sm90": 0, "flash_bwd_sm90": 0}
    print(f"recipe path launches: {json.dumps(rc_launches)}; expected {json.dumps(want_rc)}")
    if len(losses_rc) != RECIPE["steps"] or not all(math.isfinite(x) for x in losses_rc):
        fail(f"recipe losses not finite or not {RECIPE['steps']} of them")
    if not losses_rc[-1] < losses_rc[0]:
        fail(f"the recipe's last loss {losses_rc[-1]} is not below its first {losses_rc[0]}")
    if not (math.isfinite(rc_loss) and abs(rc_loss - RECIPE["loss"]) <= RECIPE["band"]):
        fail(f"recipe held-out loss {rc_loss} is not within {RECIPE['band']} nats of "
             f"{RECIPE['loss']}")
    if any(rc_launches[k] != n for k, n in want_rc.items()):
        fail("the float32 recipe did not go through the f32 flash kernels only")
    del params_rc

    # ----------------------------------------------- 4. card's numbers
    # The main-path run above is each engine's first pass over the data
    # (it also fills PyTorch's pinned-memory cache); three more passes
    # give the steady state.
    for label, e, first, rows_in, bs in (("f32", eng, res32, data, BATCH),
                                         ("int8", engq, resq, data, BATCH),
                                         ("conv", engc, resc, data_c, CIFAR_BATCH)):
        n = len(rows_in)
        runs = [first] + [e.run_inference(rows_in, batch_size=bs) for _ in range(3)]
        for i, res in enumerate(runs):
            lat = res.latency_summary()
            print(f"engine {label} pass {i}: {n / res.seconds:.1f} samples/s over {n} "
                  f"rows at batch {bs}; batch latency p50 {lat['p50_s'] * 1e3:.3f} ms "
                  f"p90 {lat['p90_s'] * 1e3:.3f} ms max {lat['max_s'] * 1e3:.3f} ms "
                  f"(n={lat['count']})")
        steady = LatencyStats("steady", [t for r in runs[1:] for t in r.batch_seconds])
        print(f"engine {label}: setup {e.setup_seconds:.3f} s; steady (passes 1-3) median "
              f"{float(np.median([n / r.seconds for r in runs[1:]])):.1f} samples/s, batch "
              f"p50 {steady.percentile(50) * 1e3:.3f} ms p90 {steady.percentile(90) * 1e3:.3f} "
              f"ms (n={len(steady)})")

    # One batch's stages, each timed alone: the host cast into pinned
    # memory (host clock), the copy to the card, the forward on the card
    # (dense: one chain launch; conv: conv1+pool, conv2+pool and the
    # 2048-64-10 chain), the copy back.
    for label, host_rows, forward in (
            ("dense f32", data[:BATCH], lambda h: fcnn_fused_forward(params, h)),
            ("conv", data_c[:CIFAR_BATCH], lambda h: network_forward(plan_c, params_c, h))):
        staged = torch.empty(host_rows.shape, dtype=torch.float32, pin_memory=True)
        t0 = time.perf_counter()
        for _ in range(10):
            staged.copy_(torch.from_numpy(host_rows))
        cast_ms = (time.perf_counter() - t0) / 10 * 1e3
        h2d_ms = cuda_time_ms(lambda: staged.to(dev, non_blocking=True), iters=20)
        batch = staged.to(dev)
        fwd_ms = cuda_time_ms(lambda: forward(batch), iters=20)
        fwd_dev_ms = cuda_graph_time_ms(lambda: forward(batch), iters=20)
        out_dev = forward(batch)
        back = torch.empty(out_dev.shape, dtype=torch.float32, pin_memory=True)
        d2h_ms = cuda_time_ms(lambda: back.copy_(out_dev, non_blocking=True), iters=20)
        print(f"engine {label} batch stages @ {len(host_rows)} rows: host cast to pinned "
              f"{cast_ms:.3f} ms, host-to-device {h2d_ms:.3f} ms "
              f"({host_rows.nbytes / h2d_ms / 1e6:.1f} GB/s), forward {fwd_ms:.4f} ms "
              f"(device time, CUDA graph: {fwd_dev_ms:.4f} ms), "
              f"device-to-host {d2h_ms:.4f} ms")
    tail_in = network_forward(plan_c[:4], params_c[:4], batch)
    tail_ms = cuda_time_ms(lambda: network_forward(plan_c[4:], params_c[4:], tail_in), iters=20)
    tail_dev_ms = cuda_graph_time_ms(lambda: network_forward(plan_c[4:], params_c[4:], tail_in),
                                     iters=20)
    print(f"engine conv batch stages @ {CIFAR_BATCH} rows: of the forward, the 2048-64-10 "
          f"dense chain {tail_ms:.4f} ms (device time, CUDA graph: {tail_dev_ms:.4f} ms)")

    # Four distinct inputs (4 x 25.7 MB > the 50 MB L2), cycled, so each
    # launch reads x from device memory as a freshly copied batch would.
    xs = [x] + [on_card(rng.uniform(0.0, 1.0, (BATCH, MNIST[0])).astype(np.float32))
                for _ in range(3)]

    def cycled(fn, inputs=xs):
        state = {"i": 0}

        def call():
            state["i"] = (state["i"] + 1) % len(inputs)
            return fn(inputs[state["i"]])
        return call

    def loop_or_graph(fn):
        """The device time of a call: a host loop of 50 calls, or, where
        that loop takes over 10% longer than 50 calls captured in one CUDA
        graph (the host then sets its pace), the graph's. Returns the
        timer chosen and both times."""
        loop, graph = cuda_time_ms(fn), cuda_graph_time_ms(fn)
        if loop > 1.1 * graph:
            return cuda_graph_time_ms, loop, graph
        return cuda_time_ms, loop, graph

    def addmm_chain(h):
        for p, act in zip(params, ACTS):
            h = apply_activation(torch.addmm(p["b"], h, p["w"]), act)
        return h

    def int_mm_chain(h):
        # torch._int_mm needs N % 8 == 0: the 10-wide head runs as 16
        # columns (zero weights) and is sliced back.
        for p, wq, act in int_mm_layers:
            absmax = torch.clamp_min(h.abs().amax(dim=-1, keepdim=True), 1e-8)
            s = absmax / torch.full_like(absmax, 127.0)
            hq = torch.clamp(torch.round(h / s), -127, 127).to(torch.int8)
            z = torch._int_mm(hq, wq)[:, : p["wq"].shape[1]]
            h = apply_activation(z.to(torch.float32) * (s * p["scale"][None, :]) + p["b"], act)
        return h

    int_mm_layers = []
    for p, act in zip(q, ACTS):
        n = p["wq"].shape[1]
        wq = torch.zeros((p["wq"].shape[0], -(-n // 8) * 8), dtype=torch.int8, device=dev)
        wq[:, :n] = p["wq"]
        int_mm_layers.append((p, wq, act))
    try:
        int_mm_chain(x)
        int_mm_ok = True
    except RuntimeError as e:
        print(f"torch._int_mm unavailable here ({e}); int8 library_ms is null")
        int_mm_ok = False

    M, (d0, d1, d2, d3) = BATCH, MNIST
    flops_chain = 2.0 * M * (d0 * d1 + d1 * d2 + d2 * d3)
    w_f32 = 4 * sum(a * b + b for a, b in zip(MNIST[:-1], MNIST[1:]))
    w_i8 = sum(a * b + 8 * b for a, b in zip(MNIST[:-1], MNIST[1:]))
    specs = [
        ("fused_dense", "tpu_dist_nn_torch/kernels/csrc/fused_dense.cu",
         "tpu_dist_nn/kernels/fused_dense.py:75",
         lambda h: fused_dense(h, w1, b1, activation="relu"),
         lambda h: fused_dense_plain(h, w1, b1, "relu"),
         lambda h: torch.relu(torch.addmm(b1, h, w1)),
         4.0 * (M * d0 + d0 * d1 + d1 + M * d1), 2.0 * M * d0 * d1, f32_rate),
        ("fcnn_fused_chain", "tpu_dist_nn_torch/kernels/csrc/fcnn_chain.cu",
         "tpu_dist_nn/kernels/fused_dense.py:118",
         lambda h: fcnn_fused_forward(params, h),
         lambda h: fcnn_fused_forward_plain(params, h),
         addmm_chain, 4.0 * M * d0 + w_f32 + 4.0 * M * d3, flops_chain, f32_rate),
        ("int8_chain", "tpu_dist_nn_torch/kernels/csrc/int8_chain.cu",
         "tpu_dist_nn/kernels/quantized.py:96",
         lambda h: fcnn_quantized_forward(q, h),
         lambda h: forward_quantized(q, h),
         int_mm_chain if int_mm_ok else None,
         4.0 * M * d0 + w_i8 + 4.0 * M * d3, flops_chain, i8_rate),
    ]
    # The f32 dense kernels take less device time than a Python call and
    # its launch take on the host, so a host loop of calls would time the
    # host: they, their plain versions and their library calls are timed
    # as 50 calls captured in one CUDA graph (device time), with the host
    # loop's time printed beside. The int8 chain takes the timer
    # loop_or_graph picks for its kernel, for all three.
    records = []
    for kname, source, replaces, kern, plain, library, nbytes, ops, rate in specs:
        timer = cuda_graph_time_ms
        if kname == "int8_chain":
            timer, loop_ms, graph_ms = loop_or_graph(cycled(kern))
            print(f"time {kname} @ batch {M}: host loop {loop_ms:.4f} ms, CUDA graph "
                  f"{graph_ms:.4f} ms a call -> timed by "
                  f"{'the graph' if timer is cuda_graph_time_ms else 'the host loop'}")
        ms = timer(cycled(kern))
        plain_ms = timer(cycled(plain))
        library_ms = timer(cycled(library)) if library is not None else None
        if timer is cuda_graph_time_ms:
            print(f"time {kname} @ batch {M}, host loop of calls: kernel "
                  f"{cuda_time_ms(cycled(kern)):.4f} ms, library "
                  f"{'n/a' if library is None else f'{cuda_time_ms(cycled(library)):.4f} ms'}")
        b_ms, b_by = bound_ms(nbytes, ops, rate, mem_rate)
        records.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[{"fused_dense": "fused_dense",
                                  "fcnn_fused_chain": "fcnn_fused_forward",
                                  "int8_chain": "fcnn_quantized_forward"}[kname]],
            "max_abs_err": err[kname], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        })
        print(f"time {kname} @ batch {M}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}, bound {b_ms:.4f} ms "
              f"({b_by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G ops) -> "
              f"{b_ms / ms * 100:.1f}% of bound"
              f"{'' if library_ms is None else f', {ms / library_ms:.2f}x the library'}")

    # The chain at the conv network's dense tail (2048-64-10, batch 1024,
    # split-K), on 7 rotating inputs (7 x 8.4 MB > the 50 MB L2); the
    # library yardstick is the addmm chain at that shape.
    tail_ins = [x_tail] + [on_card(rng_tail.uniform(0.0, 1.0, tuple(x_tail.shape))
                                   .astype(np.float32)) for _ in range(6)]

    def addmm_tail(h):
        for p, act in zip(tail, tail_acts):
            h = apply_activation(torch.addmm(p["b"], h, p["w"]), act)
        return h

    Mt = CIFAR_BATCH
    ms = cuda_graph_time_ms(cycled(lambda h: fcnn_fused_forward(tail, h), tail_ins))
    plain_ms = cuda_graph_time_ms(cycled(lambda h: fcnn_fused_forward_plain(tail, h), tail_ins))
    library_ms = cuda_graph_time_ms(cycled(addmm_tail, tail_ins))
    print(f"time fcnn_fused_chain_conv_tail @ batch {Mt}, host loop of calls: kernel "
          f"{cuda_time_ms(cycled(lambda h: fcnn_fused_forward(tail, h), tail_ins)):.4f} ms, "
          f"library {cuda_time_ms(cycled(addmm_tail, tail_ins)):.4f} ms")
    nbytes = 4.0 * (Mt * tail_dims[0] + sum(p["w"].numel() + p["b"].numel() for p in tail)
                    + Mt * tail_dims[-1])
    ops = 2.0 * Mt * sum(a * b for a, b in zip(tail_dims[:-1], tail_dims[1:]))
    b_ms, b_by = bound_ms(nbytes, ops, f32_rate, mem_rate)
    records.append({
        "name": "fcnn_fused_chain_conv_tail", "route": "cuda",
        "source": "tpu_dist_nn_torch/kernels/csrc/fcnn_chain.cu",
        "replaces": "tpu_dist_nn/kernels/fused_dense.py:118",
        "launches": conv_launches["fcnn_fused_forward"],
        "max_abs_err": err["fcnn_fused_chain_conv_tail"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
    })
    print(f"time fcnn_fused_chain_conv_tail {tail_tag} @ batch {Mt}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {library_ms:.4f} ms (addmm chain), bound {b_ms:.4f} ms "
          f"({b_by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G ops) -> "
          f"{b_ms / ms * 100:.1f}% of bound, {ms / library_ms:.2f}x the library")

    # fused_conv2d at the conv path's two stages, batch 1024, on rotating
    # inputs (5 x 12.6 MB and 4 x 16.8 MB, more than the 50 MB L2). One
    # record sums both stages: the conv kernel's share of a batch. The
    # library yardstick is cuDNN's conv on channels-last tensors (TF32
    # off), then bias, relu and max_pool2d; the port never calls it.
    conv_sum = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    conv_by = []
    for label, img, wt, bias, n_in in (("conv1+pool 32x32x3->16", img1, cw1, cb1, 5),
                                       ("conv2+pool 16x16x16->32", img2, cw2, cb2, 4)):
        ins = [img] + [on_card(rng.uniform(0.0, 1.0, tuple(img.shape)).astype(np.float32))
                       for _ in range(n_in - 1)]

        w_lib = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

        def library(h, w_lib=w_lib, bias=bias):
            z = F.conv2d(h.permute(0, 3, 1, 2), w_lib, bias, padding="same")
            return F.max_pool2d(torch.relu(z), 2)

        def kern(h, wt=wt, bias=bias):
            return fused_conv2d(h, wt, bias, activation="relu", **pool2)

        def plain(h, wt=wt, bias=bias):
            return fused_conv2d_plain(h, wt, bias, activation="relu", **pool2)

        lib_err = float((library(img).permute(0, 2, 3, 1) - plain(img)).abs().max())
        timer, loop_ms, graph_ms = loop_or_graph(cycled(kern, ins))
        print(f"time fused_conv2d {label} @ batch {img.shape[0]}: host loop {loop_ms:.4f} ms, "
              f"CUDA graph {graph_ms:.4f} ms a call -> timed by "
              f"{'the graph' if timer is cuda_graph_time_ms else 'the host loop'}")
        ms = timer(cycled(kern, ins))
        plain_ms = timer(cycled(plain, ins))
        library_ms = timer(cycled(library, ins))
        B, H, W, cin = img.shape
        kh, kw, _, cout = wt.shape
        ops = 2.0 * B * cout * cin * in_image_taps(H, kh) * in_image_taps(W, kw)
        nbytes = 4.0 * (img.numel() + wt.numel() + bias.numel() + B * (H // 2) * (W // 2) * cout)
        b_ms, b_by = bound_ms(nbytes, ops, f32_rate, mem_rate)
        for key, value in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                           ("bound_ms", b_ms)):
            conv_sum[key] += value
        conv_by.append((b_ms, b_by))
        print(f"time fused_conv2d {label} @ batch {B}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms (cuDNN conv2d + relu + "
              f"max_pool2d; max_abs vs plain {lib_err:.2e}), bound {b_ms:.4f} ms ({b_by}: "
              f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G ops) -> {b_ms / ms * 100:.1f}% of bound")
    records.append({
        "name": "fused_conv2d", "route": "cuda",
        "source": "tpu_dist_nn_torch/kernels/csrc/conv2d.cu",
        "replaces": "tpu_dist_nn/kernels/conv2d.py:98",
        "launches": conv_launches["fused_conv2d"], "max_abs_err": err["fused_conv2d"],
        **conv_sum, "bound_by": max(conv_by)[1],
    })
    print(f"time fused_conv2d, both stages of one batch of {CIFAR_BATCH}: kernel "
          f"{conv_sum['ms']:.4f} ms, plain {conv_sum['plain_ms']:.4f} ms, library "
          f"{conv_sum['library_ms']:.4f} ms, bound {conv_sum['bound_ms']:.4f} ms")

    # Flash attention on rotating input sets: at the 85M shape larger than
    # the 50 MB L2 (bf16: 3 sets of a 75.5 MB fused qkv and a 25.2 MB dO;
    # float32: 2 sets of twice that); at the float32 recipe's shape (B 16,
    # H 4, T 128, Dh 32: 1 MB a tensor) 4 sets, which stay in L2 as they
    # do in the recipe's step. Each route's kernels are timed in their own
    # dtype: bf16 for the sm90 pair (the 85M path), float32 for the f32
    # pair (tdn lm's default path), whose bound is printed twice: 3xTF32
    # (three TF32 products over the TF32 peak, the kernels line's) and
    # FP32 FFMA. lse and delta come from the routed forward. The sm90
    # backward's time is its wrapper's: zeroing the float32 dq workspace,
    # the kernel, the cast of dq to bf16 (timed alone too); the f32
    # backward's includes zeroing its float32 dq. The library yardstick is
    # F.scaled_dot_product_attention(is_causal=True) on the same
    # (transposed) views in the same dtype (TF32 off): its forward, and
    # one backward call that computes dq, dk and dv together, timed 7
    # times (its time moved 0.338-0.501 ms between calls before): the
    # median is the yardstick, the spread is printed. At the recipe's
    # shape a call's host time exceeds its device time, so the kernels
    # are also timed as a CUDA graph of 50 calls.
    src_f32 = "tpu_dist_nn_torch/kernels/csrc/flash_attention_f32.cu"
    src_sm90 = "tpu_dist_nn_torch/kernels/csrc/flash_attention_sm90.cu"
    fwd_at, dq_at, dkv_at = ("tpu_dist_nn/kernels/flash_attention.py:52",
                             "tpu_dist_nn/kernels/flash_attention.py:126",
                             "tpu_dist_nn/kernels/flash_attention.py:157")
    shape_lm = (B_LM, T_LM, H_LM, DH_LM)
    shape_rc = (RECIPE["batch"], RECIPE["seq_len"], RECIPE["heads"], DH_RC)

    def shape_tag(shape):
        B, T, H, Dh = shape
        return f"B{B} H{H} T{T} Dh{Dh} causal"

    def flash_sets(shape, dtype, n, seed0):
        sets = []
        for i in range(n):
            fq, fk, fv, fdo = flash_inputs(*shape, dtype, seed=seed0 + i)
            fo, flse = flash_fwd(fq, fk, fv, causal=True)
            fdelta = (fdo.float() * fo.float()).sum(-1).transpose(1, 2).contiguous()
            lib_in = [t.transpose(1, 2).detach().requires_grad_(True) for t in (fq, fk, fv)]
            lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True)
            sets.append(dict(q=fq, k=fk, v=fv, do=fdo, lse=flse, delta=fdelta, o=fo,
                             lib_in=lib_in, lib_out=lib_out, lib_do=fdo.transpose(1, 2),
                             scale=1.0 / math.sqrt(shape[3])))
        return sets

    def rotating(sets, fn):
        state = {"i": 0}

        def call():
            state["i"] = (state["i"] + 1) % len(sets)
            return fn(sets[state["i"]])
        return call

    def sdpa_times(sets, shape, label):
        fwd_ms = cuda_time_ms(rotating(sets, lambda st: F.scaled_dot_product_attention(
            *st["lib_in"], is_causal=True)))
        runs = sorted(cuda_time_ms(rotating(sets, lambda st: torch.autograd.grad(
            st["lib_out"], st["lib_in"], st["lib_do"], retain_graph=True)), iters=20)
            for _ in range(7))
        bwd_ms = float(np.median(runs))
        print(f"time SDPA @ {shape_tag(shape)} {label}: forward {fwd_ms:.4f} ms; backward (dq, "
              f"dk, dv in one call), 7 timings of 20 calls: median {bwd_ms:.4f} ms, min "
              f"{runs[0]:.4f}, max {runs[-1]:.4f} ({json.dumps([round(t, 4) for t in runs])})")
        return fwd_ms, bwd_ms

    def bwd_args(st):
        return st["q"], st["k"], st["v"], st["do"], st["lse"], st["delta"]

    # name -> (source, replaces, kernel, plain, (B, T, H, Dh) tensors moved,
    # float32 (B, H, T) rows moved, FLOP per causal pair and head dim);
    # bytes count each input read once and each output written once. The
    # backward is one function for both TPU backward kernels: q, k, v, dO,
    # lse and delta in, dq, dk and dv out; 5 products (S, dP, dV, dK, dQ).
    flash_kernels = {
        "flash_fwd_f32": (src_f32, fwd_at,
                          lambda st: flash_fwd_f32(st["q"], st["k"], st["v"], causal=True),
                          "fwd", 4, 1, 4.0),
        "flash_bwd_f32": (src_f32, f"{dq_at} and {dkv_at}",
                          lambda st: flash_bwd_f32(*bwd_args(st), causal=True), "bwd", 7, 2,
                          10.0),
        "flash_fwd_sm90": (src_sm90, fwd_at,
                           lambda st: flash_fwd_sm90(st["q"], st["k"], st["v"], causal=True),
                           "fwd", 4, 1, 4.0),
        "flash_bwd_sm90": (src_sm90, f"{dq_at} and {dkv_at}",
                           lambda st: flash_bwd_sm90(*bwd_args(st), causal=True), "bwd", 7, 2,
                           10.0),
    }
    plains = {
        "fwd": lambda st: flash_fwd_plain(st["q"], st["k"], st["v"], scale=st["scale"],
                                          causal=True),
        "bwd": lambda st: flash_bwd_plain(*bwd_args(st), scale=st["scale"], causal=True),
    }

    def time_flash(kname, sets, shape, dtype, sdpa, launches=None, err_key=None, graph=False):
        source, replaces, kern, plain_key, n_act, n_rows, flop = flash_kernels[kname]
        B, T, H, Dh = shape
        elem = 2 if dtype == torch.bfloat16 else 4
        nbytes = n_act * elem * B * T * H * Dh + n_rows * 4.0 * B * H * T
        ops = flop * B * H * causal_pairs(T) * Dh
        ms = cuda_time_ms(rotating(sets, kern))
        plain_ms = cuda_time_ms(rotating(sets, plains[plain_key]), iters=10, warmup=2)
        library_ms = sdpa[0] if plain_key == "fwd" else sdpa[1]
        if dtype == torch.bfloat16:
            b_ms, b_by = bound_ms(nbytes, ops, bf16_rate, mem_rate)
            bound_what = "at the bf16 peak"
        else:
            b_ms, b_by = bound_ms(nbytes, 3.0 * ops, tf32_rate, mem_rate)
            ffma_ms, ffma_by = bound_ms(nbytes, ops, f32_rate, mem_rate)
            bound_what = (f"3xTF32: 3 x the FLOP at the TF32 peak; FP32 FFMA bound "
                          f"{ffma_ms:.4f} ms ({ffma_by})")
        if launches is not None:
            records.append({
                "name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[kname], "max_abs_err": err[err_key], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_ms,
            })
        lib_what = ("SDPA forward" if plain_key == "fwd"
                    else "one SDPA backward call, which computes dq, dk and dv together")
        graph_what = (f", CUDA graph of 50 calls {cuda_graph_time_ms(rotating(sets, kern)):.4f} ms"
                      if graph else "")
        print(f"time {kname} @ {shape_tag(shape)} {str(dtype).split('.')[-1]}: kernel {ms:.4f} "
              f"ms{graph_what}, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms "
              f"({lib_what}), bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB, "
              f"{ops / 1e9:.3f} GFLOP; {bound_what}) -> {b_ms / ms * 100:.2f}% of bound, "
              f"{ops / ms / 1e9:.1f} TFLOP/s, {ms / library_ms:.2f}x the library")
        return ms

    sets = flash_sets(shape_lm, torch.bfloat16, 3, 10)
    lib_err = float((sets[0]["lib_out"].detach().transpose(1, 2).float()
                     - sets[0]["o"].float()).abs().max())
    sdpa_bf16 = sdpa_times(sets, shape_lm, "bfloat16")
    sm90_bwd_ms = 0.0
    for k in ("flash_fwd_sm90", "flash_bwd_sm90"):
        sm90_bwd_ms = time_flash(k, sets, shape_lm, torch.bfloat16, sdpa_bf16, lm_launches, k)
    workspace_ms = cuda_time_ms(lambda: torch.zeros(
        (B_LM, T_LM, H_LM, DH_LM), dtype=torch.float32, device=dev).to(torch.bfloat16))
    print(f"time flash_bwd_sm90's workspace alone (zero a float32 (B, T, H, Dh) and cast it "
          f"to bf16): {workspace_ms:.4f} ms of its {sm90_bwd_ms:.4f} ms")
    print(f"SDPA forward vs flash_fwd_sm90 at the LM shape: max_abs {lib_err:.3e}")
    del sets
    torch.cuda.empty_cache()
    # The f32 pair on its own route, float32, at the 85M shape (the
    # kernels line; launches from the float32 recipe's main path) and at
    # the recipe's shape.
    sets = flash_sets(shape_lm, torch.float32, 2, 30)
    sdpa_f32 = sdpa_times(sets, shape_lm, "float32")
    f32_ms = {k: time_flash(k, sets, shape_lm, torch.float32, sdpa_f32, rc_launches, k)
              for k in ("flash_fwd_f32", "flash_bwd_f32")}
    zero_ms = cuda_time_ms(lambda: torch.zeros((B_LM, T_LM, H_LM, DH_LM), dtype=torch.float32,
                                               device=dev))
    print(f"time flash_bwd_f32's dq zeroing alone: {zero_ms:.4f} ms of its "
          f"{f32_ms['flash_bwd_f32']:.4f} ms")
    for k, (lib_ms, name_) in (("flash_fwd_f32", (sdpa_f32[0], "forward")),
                               ("flash_bwd_f32", (sdpa_f32[1], "backward"))):
        print(f"check {k} below SDPA float32 {name_} at the 85M shape, this run: "
              f"{f32_ms[k]:.4f} vs {lib_ms:.4f} ms | goal, not a gate | "
              f"{'met' if f32_ms[k] < lib_ms else 'missed'}")
    del sets
    torch.cuda.empty_cache()
    sets = flash_sets(shape_rc, torch.float32, 4, 40)
    sdpa_rc = sdpa_times(sets, shape_rc, "float32")
    for k in ("flash_fwd_f32", "flash_bwd_f32"):
        time_flash(k, sets, shape_rc, torch.float32, sdpa_rc, graph=True)
    del sets
    torch.cuda.empty_cache()

    # The TPU kernel sweep's shape (artifacts/tpu_r04/kernel_sweep.json):
    # B 4, H 8, Dh 64, T 4096, causal, bf16; flash attention against the
    # materialised dot_product_attention, forward and forward + backward.
    def sweep_set(seed):
        q, k, v, do = flash_inputs(4, 4096, 8, 64, torch.bfloat16, seed)
        return [t.contiguous().requires_grad_(True) for t in (q, k, v)] + [do]

    sweep = [sweep_set(20 + i) for i in range(2)]  # 2 x 67 MB > the 50 MB L2
    for label, attn in (("flash_attention", flash_attention),
                        ("dot_product_attention", dot_product_attention)):
        def fwd(st, attn=attn):
            with torch.no_grad():
                return attn(*st[:3], causal=True)

        def fwd_bwd(st, attn=attn):
            return torch.autograd.grad(attn(*st[:3], causal=True), st[:3], st[3])

        state = {"i": 0}

        def cyc(fn):
            def call():
                state["i"] = (state["i"] + 1) % len(sweep)
                return fn(sweep[state["i"]])
            return call

        f_ms = cuda_time_ms(cyc(fwd), iters=10, warmup=2)
        fb_ms = cuda_time_ms(cyc(fwd_bwd), iters=10, warmup=2)
        print(f"time {label} @ B4 H8 T4096 Dh64 causal bf16 (the TPU sweep's shape): forward "
              f"{f_ms:.4f} ms, forward + backward {fb_ms:.4f} ms")
    del sweep
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
