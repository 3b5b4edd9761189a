"""Command line for the PyTorch/CUDA port: ``python -m tpu_dist_nn_torch.cli``.

Verbs ported from ``tdn`` (:mod:`tpu_dist_nn.cli`), with the same
printed lines:

* ``up`` — bring an engine up and print ``{"ready": true, ...}``; with
  ``--grpc-port`` serve the reference's ``Process`` RPC on it (printing
  ``{"grpc_port": P}``) until ``--serve-seconds`` pass, SIGINT, or
  SIGTERM (a graceful drain); with ``--serve`` stay up without a socket.
* ``infer`` — local-engine inference of a dense or conv model JSON over
  an examples file: whole set, ``--batch-size`` chunks, or one
  ``input_index``; ``--quantize int8`` (dense models);
  ``--distribution``, ``--data-parallel``, ``--microbatches`` and
  ``--virtual-stages`` (the Engine's placement: the layer pipeline over
  the visible cards, one program on one card). With
  ``--target host:port`` (or ``--port``) it is a pure gRPC client of a
  running ``up --grpc-port`` server (the reference client's role; no
  ``--config``).
* ``oracle`` — the float64 numpy baseline (scripts/manual_nn.py:88-99).
* ``doctor`` — a readiness report: the forward against the oracle, and
  a ``fused_dense`` kernel probe against its plain version.
* ``train`` — native FCNN training (``tdn train``): a fresh model
  (``--layers``, dataset-aware default) or ``--config``, on synthetic,
  fashion, the vendored digits, IDX or examples-JSON data, with the
  optimizer controls, per-epoch checkpoints and resume, per-epoch report
  lines, ``--metrics-out`` and ``--out`` (the trained model JSON). The
  step is plain autograd; each epoch's eval runs the chain kernel on the
  card. Left for later slices: ``--metrics-port`` and the multi-host
  flags; ``--checkpoint-format orbax`` is refused.
* ``lm`` — train and evaluate the byte-level Transformer LM on one
  device (the flash-attention kernels on the card), with ``tdn lm``'s
  corpus tiers, 95/5 split, per-step log lines and final JSON report.
  Its generation, serving, checkpoint and parallel flags wait for their
  slices.

Every engine-side verb runs on the card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

import numpy as np

from tpu_dist_nn_torch.utils.errors import FrameworkError

log = logging.getLogger("tpu_dist_nn_torch.cli")


def _parse_distribution(text):
    if text is None:
        return None
    return [int(t) for t in text.replace(",", " ").split()]


def _engine_from_args(args):
    from tpu_dist_nn_torch.api.engine import Engine

    return Engine.up(
        args.config,
        _parse_distribution(args.distribution),
        data_parallel=args.data_parallel,
        num_microbatches=args.microbatches,
        virtual_stages=args.virtual_stages,
        device=args.device,
        quantize=args.quantize,
    )


def _parse_class_watermarks(text):
    """``--class-watermarks 'critical=1.0,best_effort=0.5'`` -> the
    validated full per-class fraction table (None = defaults)."""
    if not text:
        return None
    from tpu_dist_nn_torch.serving.sched_core import validate_class_watermarks

    table = {}
    for part in text.replace(",", " ").split():
        cls, sep, frac = part.partition("=")
        if not sep:
            raise ValueError(
                f"--class-watermarks entries are class=fraction, got {part!r}"
            )
        try:
            table[cls.strip()] = float(frac)
        except ValueError:
            raise ValueError(
                f"--class-watermarks fraction for {cls.strip()!r} must be a "
                f"number, got {frac!r}"
            ) from None
    return validate_class_watermarks(table)


def _serve_loop(engine, max_seconds: float | None = None, teardown=None,
                stop_event=None) -> None:
    """Supervisor loop: stay up until SIGINT (or ``max_seconds``, or
    ``stop_event``), then tear down — the reference orchestrator's main
    loop (run_grpc_fcnn.py:326-344). ``teardown`` replaces the default
    ``engine.down()``: the gRPC path drains the server BEFORE downing
    the engine."""
    t0 = time.monotonic()
    try:
        while max_seconds is None or time.monotonic() - t0 < max_seconds:
            if stop_event is not None and stop_event.wait(0.2):
                break
            if stop_event is None:
                time.sleep(0.2)
    except KeyboardInterrupt:
        log.info("interrupt received; tearing down")
    finally:
        if teardown is not None:
            teardown()
        else:
            engine.down()
        log.info("engine down; relaunch with `up` (stateless restart)")


def cmd_up(args) -> int:
    """Validate, place and warm an engine (the orchestrator's role);
    optionally serve it."""
    from tpu_dist_nn_torch.serving.resilience import GracefulDrain

    watermarks = _parse_class_watermarks(args.class_watermarks)
    engine = _engine_from_args(args)
    print(json.dumps({"ready": True, "setup_seconds": engine.setup_seconds,
                      "placement": engine.placement()}))
    if args.inputs:
        from tpu_dist_nn_torch.core.schema import load_examples

        x, _ = load_examples(args.inputs)
        result = engine.run_inference(x[:1])
        print(json.dumps({"smoke_inference": result.outputs[0].tolist()}))
    if args.probe_latency:
        print(json.dumps({"step_latency": engine.step_latency()}))
    if args.grpc_port is not None:
        from tpu_dist_nn_torch.serving.server import serve_engine

        drain = GracefulDrain(grace_seconds=args.drain_grace_seconds)
        server, bound = serve_engine(
            engine, args.grpc_port, warm_rows=args.serve_warm_rows,
            max_pending_rows=args.max_pending_rows,
            class_watermarks=watermarks,
        )
        # SIGTERM -> drain: stop accepting, finish in-flight RPCs within
        # --drain-grace-seconds, then leave the loop.
        drain.add_server(server)
        drain.install_signal_handler()
        print(json.dumps({"grpc_port": bound}), flush=True)

        def teardown():
            drain.begin()
            drain.wait(args.drain_grace_seconds + 10.0)
            engine.down()

        _serve_loop(engine, max_seconds=args.serve_seconds,
                    teardown=teardown, stop_event=drain.drained)
        return 0
    if args.serve:
        _serve_loop(engine, max_seconds=args.serve_seconds)
    return 0


def _infer_over_grpc(args) -> int:
    """Client-only inference against a running ``up --grpc-port``
    server — the reference client's role (run_grpc_inference.py): no
    model file, batches over one persistent channel, accuracy and time
    reported as the local verb reports them."""
    import math

    from tpu_dist_nn_torch.core.schema import load_examples
    from tpu_dist_nn_torch.serving.server import GrpcClient
    from tpu_dist_nn_torch.train.metrics import classification_metrics

    x, y = load_examples(args.inputs)
    kwargs = {}
    if args.retry_max_attempts is not None:
        from tpu_dist_nn_torch.serving.resilience import RetryPolicy

        kwargs["retry"] = RetryPolicy(max_attempts=args.retry_max_attempts)
    if args.session_key:
        kwargs["session_key"] = args.session_key
    if args.slo_class:
        kwargs["slo_class"] = args.slo_class
    client = GrpcClient(args.target, timeout=args.timeout or 30.0, **kwargs)
    try:
        if args.input_index is not None:
            t0 = time.monotonic()
            out = client.process(np.asarray(x[args.input_index])[None, :])[0]
            seconds = time.monotonic() - t0
            print(f"Output: {out.tolist()}")
            print(f"Inference time: {seconds:.4f} seconds")
            if y[args.input_index] >= 0:
                print(f"Label: {y[args.input_index]}  predicted: {int(out.argmax())}")
            return 0
        bs = args.batch_size or len(x)
        outs = []
        t0 = time.monotonic()
        for i in range(math.ceil(len(x) / bs)):
            tb = time.monotonic()
            outs.append(client.process(x[i * bs:(i + 1) * bs]))
            log.info("batch %d took %.4f seconds", i, time.monotonic() - tb)
        seconds = time.monotonic() - t0
        out = np.vstack(outs)
        n = len(x)
        if (y >= 0).all():
            preds = out.argmax(-1)
            metrics = classification_metrics(preds, y, out.shape[1])
            correct = int((preds == y).sum())
            print(f"Correct predictions: {correct}/{n} "
                  f"(accuracy {metrics['accuracy']:.4f})")
            print(f"Metrics: {json.dumps(metrics)}")
        print(f"Total inference time: {seconds:.4f} seconds "
              f"({n / seconds:.1f} samples/sec)")
        return 0
    finally:
        client.close()


def cmd_infer(args) -> int:
    from tpu_dist_nn_torch.core.schema import load_examples

    if not args.target and args.port is not None and not args.config:
        # A bare --port with no local model: the server on localhost,
        # the reference client's addressing (run_grpc_inference.py:27).
        args.target = f"127.0.0.1:{args.port}"
    if args.target:
        ignored = [name for name, bad in (
            ("--config", args.config is not None),
            ("--quantize", args.quantize is not None),
            ("--distribution", args.distribution is not None),
            ("--data-parallel", args.data_parallel != 1),
            ("--device", args.device is not None),
        ) if bad]
        if ignored:
            raise ValueError(
                f"{', '.join(ignored)} configure a LOCAL engine and have no "
                "effect in --target client mode; start the server with them "
                "instead (up --grpc-port ...)"
            )
        return _infer_over_grpc(args)
    if not args.config:
        raise ValueError("infer requires --config (or --target for "
                         "client-only mode against a running server)")
    engine = _engine_from_args(args)
    x, y = load_examples(args.inputs)
    if args.input_index is not None:
        # Single-example path (run_grpc_inference.py:174-178).
        out, seconds = engine.infer_single(x[args.input_index])
        print(f"Output: {out.tolist()}")
        print(f"Inference time: {seconds:.4f} seconds")
        if y[args.input_index] >= 0:
            print(f"Label: {y[args.input_index]}  predicted: {int(out.argmax())}")
        return 0
    labels = y if (y >= 0).all() else None
    result = engine.run_inference(x, labels=labels, batch_size=args.batch_size)
    for i, bs in enumerate(result.batch_seconds):
        log.info("batch %d took %.4f seconds", i, bs)
    if len(result.batch_seconds) > 1:
        log.info("batch latency: %s", json.dumps(result.latency_summary()))
    n = len(x)
    if result.metrics:
        correct = int(round(result.metrics["accuracy"] * n))
        # The client's closing report (run_grpc_inference.py:206-216).
        print(f"Correct predictions: {correct}/{n} "
              f"(accuracy {result.metrics['accuracy']:.4f})")
        print(f"Metrics: {json.dumps(result.metrics)}")
    print(f"Total inference time: {result.seconds:.4f} seconds "
          f"({n / result.seconds:.1f} samples/sec)")
    return 0


def cmd_oracle(args) -> int:
    """Single-process float64 baseline (scripts/manual_nn.py:88-99)."""
    from tpu_dist_nn_torch.core.schema import load_examples, load_model
    from tpu_dist_nn_torch.testing.oracle import oracle_forward

    model = load_model(args.config)
    x, _ = load_examples(args.inputs)
    total = 0.0
    for example in x:
        t0 = time.monotonic()
        oracle_forward(model, example)
        dt = time.monotonic() - t0
        total += dt
        print(f"Inference time: {dt:.4f} seconds")
    print(f"Total inference time: {total:.4f} seconds")
    print(f"Average inference time: {total / len(x):.4f} seconds")
    return 0


def cmd_doctor(args) -> int:
    """Readiness report as one JSON line; exit 1 if a check failed.

    The kernel probe runs ``fused_dense`` at the flagship model's first
    layer (8192 x 784 -> 128, relu) and holds it against its plain
    version (float32, TF32 off: atol/rtol 1e-5)."""
    import torch

    from tpu_dist_nn_torch.kernels.fused_dense import fused_dense, fused_dense_plain
    from tpu_dist_nn_torch.models.fcnn import forward, init_fcnn, spec_from_params
    from tpu_dist_nn_torch.testing.oracle import oracle_forward_batch
    from tpu_dist_nn_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"device": str(dev), "torch": torch.__version__,
              "cuda": torch.version.cuda}
    if dev.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(dev)

    gen = torch.Generator().manual_seed(0)
    params = init_fcnn(gen, [16, 8, 4], device=dev)
    model = spec_from_params(params, ["relu", "softmax"])
    x = np.random.default_rng(0).uniform(0, 1, (4, 16)).astype(np.float32)
    got = forward(params, torch.from_numpy(x).to(dev)).cpu().numpy()
    err = float(np.max(np.abs(got - oracle_forward_batch(model, x))))
    report["oracle_max_abs_err"] = err
    report["oracle_parity"] = err < 1e-5

    rng = np.random.default_rng(1)
    xk = torch.from_numpy(rng.uniform(0, 1, (8192, 784)).astype(np.float32)).to(dev)
    wk = torch.from_numpy((rng.normal(size=(784, 128)) * 0.05).astype(np.float32)).to(dev)
    bk = torch.from_numpy((rng.normal(size=(128,)) * 0.1).astype(np.float32)).to(dev)
    try:
        got = fused_dense(xk, wk, bk, activation="relu")
        want = fused_dense_plain(xk, wk, bk, "relu")
        kerr = float((got - want).abs().max())
        report["fused_dense_max_abs_err"] = kerr
        report["fused_dense"] = "ok" if torch.allclose(got, want, atol=1e-5, rtol=1e-5) \
            else "mismatch"
    except FrameworkError as e:  # a failed build or launch is the finding
        report["fused_dense"] = f"failed: {e}"
    print(json.dumps(report))
    return 0 if report["oracle_parity"] and report["fused_dense"] == "ok" else 1


def _write_metrics_jsonl(path, records) -> None:
    """One JSON object per line, after a ``{"run": "begin"}`` marker,
    appended (``tdn``'s metrics channel)."""
    with open(path, "a") as f:
        f.write(json.dumps({"run": "begin"}) + "\n")
        for r in records:
            f.write(json.dumps(r) + "\n")
    log.info("wrote %d metric records to %s", len(records), path)


def _validate_metrics_out(path) -> None:
    """Fail an unwritable ``--metrics-out`` before training, not after."""
    if not path:
        return
    try:
        with open(path, "a"):
            pass
    except OSError as e:
        raise ValueError(f"--metrics-out path is not writable: {e}") from e


def _train_data(args, model):
    """-> (train, eval) Datasets for ``--data``."""
    from tpu_dist_nn_torch.data import datasets

    if args.data.startswith("idx:"):
        return (datasets.load_mnist_idx(args.data[4:], "train"),
                datasets.load_mnist_idx(args.data[4:], "test"))
    if args.data == "digits":
        return datasets.real_digits("train"), datasets.real_digits("test")
    if args.data.startswith("json:"):
        from tpu_dist_nn_torch.core.schema import load_examples

        x, y = load_examples(args.data[5:])
        if (y < 0).any():
            # load_examples marks missing labels with -1: training on the
            # sentinel would push everything to the last class.
            raise ValueError(f"{args.data[5:]}: examples without labels cannot be trained on")
        full = datasets.Dataset(x, y, int(y.max()) + 1)
    elif args.data in ("synthetic", "fashion"):
        make = (datasets.synthetic_fashion_mnist if args.data == "fashion"
                else datasets.synthetic_mnist)
        full = make(args.num_examples, dim=model.input_dim, num_classes=model.output_dim,
                    seed=args.seed)
    else:
        raise ValueError(f"unknown --data {args.data!r}: synthetic | fashion | digits | "
                         "idx:DIR | json:FILE")
    return full.split(0.9, seed=args.seed)


def cmd_train(args) -> int:
    """Native FCNN training (``tdn train``'s single-program path)."""
    import torch

    from tpu_dist_nn_torch.api.engine import Engine
    from tpu_dist_nn_torch.core.schema import load_model
    from tpu_dist_nn_torch.models.fcnn import init_fcnn, spec_from_params
    from tpu_dist_nn_torch.obs.trace import TRACER
    from tpu_dist_nn_torch.train.trainer import TrainConfig
    from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

    if args.trace_sample_rate is not None:
        try:
            TRACER.configure(sample_rate=args.trace_sample_rate)
        except ValueError as e:
            raise ValueError(f"--trace-sample-rate: {e}") from e
    if args.checkpoint_dir and args.checkpoint_format == "orbax":
        raise ValueError(
            "--checkpoint-format orbax is not ported: the port writes its "
            "native .npz store (drop the flag)"
        )
    _validate_metrics_out(args.metrics_out)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.config:
        model = load_model(args.config)
    else:
        if args.layers is None:
            # The reference's 784-128-64-10 torch shape, or its geometry
            # at the 8x8 digits' size; an explicit --layers always wins.
            args.layers = "64,32,16,10" if args.data == "digits" else "784,128,64,10"
            log.info("using default layers %s", args.layers)
        sizes = _parse_distribution(args.layers)
        acts = ["relu"] * (len(sizes) - 2) + ["softmax"]
        params = init_fcnn(torch.Generator().manual_seed(args.seed), sizes, acts, device="cpu")
        model = spec_from_params(params, acts)
    data, eval_data = _train_data(args, model)
    if data.x.shape[1] != model.input_dim:
        raise InvalidArgumentError(
            f"data has {data.x.shape[1]} features but the model expects "
            f"{model.input_dim} inputs — pass --layers (or --config) "
            f"matching the dataset (e.g. --data digits is 64-dim)"
        )
    engine = Engine.up(
        model, _parse_distribution(args.distribution), data_parallel=args.data_parallel,
        num_microbatches=args.microbatches, virtual_stages=args.virtual_stages,
        device=args.device,
    )
    cfg = TrainConfig(
        learning_rate=args.lr, epochs=args.epochs, batch_size=args.batch_size,
        seed=args.seed, clip_norm=args.clip_norm, warmup_steps=args.warmup_steps,
        lr_schedule=args.lr_schedule, weight_decay=args.weight_decay,
        grad_accum=args.grad_accum,
    )
    checkpoints = None
    if args.checkpoint_dir:
        from tpu_dist_nn_torch.checkpoint import AsyncCheckpointManager, CheckpointManager

        manager = AsyncCheckpointManager if args.async_checkpoints else CheckpointManager
        checkpoints = manager(args.checkpoint_dir, keep=args.keep_checkpoints)
    try:
        history = engine.train(data, cfg, eval_data=eval_data, checkpoints=checkpoints,
                               schedule=args.schedule)
    finally:
        if hasattr(checkpoints, "close"):
            checkpoints.close()
    if args.metrics_out:
        _write_metrics_jsonl(args.metrics_out, history)
    for h in history:
        msg = f"epoch {h['epoch']}: loss {h['loss']:.4f} ({h['seconds']:.2f}s)"
        if "eval" in h:
            msg += f" eval_acc {h['eval']['accuracy']:.4f}"
        log.info(msg)
    metrics = history[-1].get("eval") if history else None
    if args.out:
        engine.export(args.out, metrics=metrics)
        log.info("exported trained model to %s", args.out)
    return 0


def cmd_lm(args) -> int:
    """Train + evaluate the byte-level Transformer LM (``tdn lm``'s
    single-device path)."""
    import torch

    from tpu_dist_nn_torch.data.text import encode, lm_batches, lm_sequences, load_corpus
    from tpu_dist_nn_torch.models.transformer import (
        TransformerConfig,
        init_transformer,
        num_params,
    )
    from tpu_dist_nn_torch.train.lm_trainer import LMTrainConfig, evaluate_lm, train_lm
    from tpu_dist_nn_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = TransformerConfig(
        vocab_size=256, d_model=args.d_model, n_heads=args.heads, n_layers=args.layers,
        d_ff=4 * args.d_model, max_seq_len=args.seq_len,
        compute_dtype="bfloat16" if args.bf16 else "float32", remat=args.remat)
    text, source = load_corpus(args.corpus)
    rows = lm_sequences(encode(text), args.seq_len)
    split = max(1, int(len(rows) * 0.95))
    train_rows, eval_rows = rows[:split], rows[split:]
    params = init_transformer(torch.Generator().manual_seed(args.seed), cfg, device=device)
    log.info("tiny-transformer: %d params, corpus=%s, %d train rows, %d eval rows, device %s",
             num_params(params), source, len(train_rows), len(eval_rows), device)
    train_cfg = LMTrainConfig(
        learning_rate=args.lr, steps=args.steps, batch_size=args.batch_size,
        seq_len=args.seq_len, clip_norm=args.clip_norm, warmup_steps=args.warmup_steps,
        lr_schedule=args.lr_schedule, weight_decay=args.weight_decay,
        grad_accum=args.grad_accum, log_every=args.log_every)
    batches = lm_batches(train_rows, args.batch_size, seed=args.seed, epochs=None)
    t0 = time.monotonic()
    params, history = train_lm(params, cfg, batches, train_cfg)
    train_seconds = time.monotonic() - t0
    for h in history:
        log.info("step %d: loss %.4f (%.2fs)", h["step"], h["loss"], h["seconds"])
    held_out = len(eval_rows) >= args.batch_size
    if not held_out:
        log.warning(
            "eval split has %d rows < batch size %d; reporting metrics over the FULL "
            "dataset (includes training rows)", len(eval_rows), args.batch_size)
    cap = args.eval_batches
    eval_rows_used = eval_rows if held_out else rows
    avail_batches = len(eval_rows_used) // args.batch_size
    if 0 < cap < avail_batches:
        log.warning(
            "--eval-batches %d truncates the eval set (%d of %d batches evaluated); "
            "loss/perplexity cover a subset — compare eval_rows_used across runs",
            cap, cap, avail_batches)
    eval_metrics = evaluate_lm(params, cfg, eval_rows_used, batch_size=args.batch_size,
                               max_batches=cap if cap > 0 else None)
    report = {
        "train_seconds": round(train_seconds, 2),
        "final_train_loss": history[-1]["loss"] if history else None,
        "eval_split": "held-out" if held_out else "full-dataset",
        **{k: round(v, 4) for k, v in eval_metrics.items()},
    }
    if args.metrics_out:
        _write_metrics_jsonl(args.metrics_out, history + [{"final_report": report}])
    print(json.dumps(report))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m tpu_dist_nn_torch.cli",
        description="PyTorch/CUDA port of tpu-dist-nn",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    def add_engine_args(p, config_required=True):
        p.add_argument("--config", required=config_required, help="model JSON file")
        p.add_argument("--distribution", help="layer distribution, e.g. 1,1,1")
        p.add_argument("--data-parallel", type=int, default=1)
        p.add_argument("--microbatches", type=int, default=4)
        p.add_argument("--virtual-stages", type=int, default=1,
                       help="interleaved (virtual-stage) placement: the distribution's "
                            "V entries become V pipeline chunks on V/v stage slots, "
                            "chunk c on slot c %% (V/v)")
        p.add_argument("--quantize", choices=["int8"],
                       help="serve through the int8 chain kernel")
        p.add_argument("--device", default=None,
                       help="'cuda' (default) or 'cpu' for the plain PyTorch path")

    p = sub.add_parser("up", help="validate, place, warm (orchestrator); optionally serve")
    add_engine_args(p)
    p.add_argument("--inputs", help="example inputs JSON file: one smoke inference")
    p.add_argument("--probe-latency", action="store_true",
                   help="report p50/p90/p99 pipeline step latency")
    p.add_argument("--serve", action="store_true",
                   help="stay up until Ctrl-C, then tear down "
                        "(the reference orchestrator's supervisor loop)")
    p.add_argument("--grpc-port", type=int, default=None,
                   help="serve the reference's LayerService Process RPC on this "
                        "port (0 = ephemeral; printed as {\"grpc_port\": P}) "
                        "and stay up until Ctrl-C")
    p.add_argument("--serve-warm-rows", type=int, default=64,
                   help="run the coalescing bucket ladder up to this many rows "
                        "before opening the port (0 disables)")
    p.add_argument("--serve-seconds", type=float, default=None,
                   help="serve for N seconds then tear down (default: until "
                        "interrupted)")
    p.add_argument("--max-pending-rows", type=int, default=None,
                   help="admission watermark: a request that would queue past "
                        "this many pending rows is shed with RESOURCE_EXHAUSTED "
                        "(default: unbounded)")
    p.add_argument("--class-watermarks", default=None, metavar="SPEC",
                   help="per-SLO-class shed fractions of --max-pending-rows, e.g. "
                        "'critical=1.0,standard=1.0,best_effort=0.5' (the default)")
    p.add_argument("--drain-grace-seconds", type=float, default=5.0,
                   help="graceful-drain window on SIGTERM: new RPCs are refused "
                        "and in-flight ones get this long to finish")
    p.set_defaults(fn=cmd_up)

    p = sub.add_parser("infer", help="run inference on a local engine, or as a gRPC client")
    p.add_argument("input_index", nargs="?", type=int, default=None)
    add_engine_args(p, config_required=False)
    p.add_argument("--inputs", required=True, help="example inputs JSON file")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--target",
                   help="host:port of a running `up --grpc-port` server: act as "
                        "a pure gRPC client (no --config needed)")
    p.add_argument("--port", type=int, default=None,
                   help="with no --config: shorthand for --target 127.0.0.1:PORT")
    p.add_argument("--timeout", type=float, default=None,
                   help="per-RPC budget for --target (default 30 s), retries "
                        "included")
    p.add_argument("--retry-max-attempts", type=int, default=None,
                   help="with --target: attempts per RPC (jittered backoff on "
                        "UNAVAILABLE/DEADLINE_EXCEEDED within --timeout; 1 = no "
                        "retries, default 3)")
    p.add_argument("--session-key",
                   help="with --target: send this x-tdn-session key on every RPC")
    p.add_argument("--slo-class", default=None,
                   choices=["critical", "standard", "best_effort"],
                   help="with --target: send this x-tdn-class SLO class on "
                        "every RPC (queue priority and shed watermark)")
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("oracle", help="numpy float64 baseline (manual_nn)")
    p.add_argument("--config", required=True)
    p.add_argument("--inputs", required=True)
    p.set_defaults(fn=cmd_oracle)

    p = sub.add_parser("doctor", help="readiness report: oracle parity + kernel probe")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu' for the plain PyTorch path")
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser("train", help="native FCNN training")
    p.add_argument("--config", help="start from an existing model JSON")
    p.add_argument("--layers", default=None,
                   help="fresh model sizes; default 784,128,64,10 "
                        "(generate_mnist_pytorch.py:25-27), or 64,32,16,10 "
                        "with --data digits")
    p.add_argument("--data", default="synthetic",
                   help="synthetic | fashion | digits (vendored real "
                        "handwritten digits) | idx:DIR | json:FILE")
    p.add_argument("--num-examples", type=int, default=12000)
    p.add_argument("--distribution", help="layer distribution: a pipeline over the "
                   "visible cards where they suffice, else one program")
    p.add_argument("--data-parallel", type=int, default=1)
    p.add_argument("--microbatches", type=int, default=4)
    p.add_argument("--schedule", choices=["gpipe", "1f1b", "interleaved"], default="gpipe",
                   help="pipeline training schedule (a single-program placement "
                        "trains gpipe only)")
    p.add_argument("--virtual-stages", type=int, default=1,
                   help="interleaved (virtual-stage) placement: V chunks on V/v "
                        "stage slots")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--clip-norm", type=float, default=None,
                   help="global-norm gradient clipping")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--lr-schedule", choices=["constant", "cosine"], default="constant")
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="decoupled (AdamW) weight decay")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="average gradients over N micro-steps per optimizer update")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", help="export trained model JSON here")
    p.add_argument("--metrics-out", help="append per-epoch training records as JSONL here")
    p.add_argument("--checkpoint-dir",
                   help="save per-epoch training state here and resume from it")
    p.add_argument("--keep-checkpoints", type=int, default=3)
    p.add_argument("--async-checkpoints", action="store_true",
                   help="write checkpoints on a background thread")
    p.add_argument("--checkpoint-format", choices=["native", "orbax"], default="native",
                   help="native .npz store (orbax is not ported)")
    p.add_argument("--trace-sample-rate", type=float, default=None, metavar="RATE",
                   help="head-sampling rate for the run trace (epoch spans) in [0, 1]")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu' for the plain PyTorch path")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("lm", help="train + eval the byte-level Transformer LM")
    p.add_argument("--corpus", help="path to a text corpus (WikiText-2); falls back "
                   "to the vendored real corpus, then a synthetic one")
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--clip-norm", type=float, default=None,
                   help="global-norm gradient clipping")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--lr-schedule", choices=["constant", "cosine"], default="constant")
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="decoupled (AdamW) weight decay")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="average gradients over N micro-steps per optimizer update")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (f32 master params + CE)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block's activations in the backward")
    p.add_argument("--eval-batches", type=int, default=0,
                   help="cap the held-out eval at N batches (0 = the full split)")
    p.add_argument("--log-every", type=int, default=50,
                   help="record the loss every N steps (each record waits for the device)")
    p.add_argument("--metrics-out",
                   help="append per-step records + the final report as JSONL here")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu' for the plain PyTorch path")
    p.set_defaults(fn=cmd_lm)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s"
    )
    try:
        return args.fn(args)
    except (ValueError, FileNotFoundError, ImportError, FrameworkError) as e:
        # Config/placement errors and a missing card are user errors,
        # not crashes.
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
