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
  ``--virtual-stages`` (the Engine's placement: the layer pipeline, or
  a conv model's heterogeneous pipeline, over the visible cards; one
  program on one card). With
  ``--target host:port`` (or ``--port``) it is a pure gRPC client of a
  running ``up --grpc-port`` server (the reference client's role; no
  ``--config``).
* ``oracle`` — the float64 numpy baseline (scripts/manual_nn.py:88-99).
* ``doctor`` — a readiness report: the forward against the oracle, and
  a ``fused_dense`` kernel probe against its plain version.
* ``train`` — native training (``tdn train``): a fresh FCNN
  (``--layers``, dataset-aware default) or ``--config`` (a dense or a
  conv model, single-program or through ``--distribution``), on
  synthetic, fashion, the vendored digits, IDX or examples-JSON data,
  with the optimizer controls, per-epoch checkpoints and resume,
  per-epoch report lines, ``--metrics-out`` and ``--out`` (the trained
  model JSON). The step is plain autograd; each epoch's eval runs the
  chain (and conv) kernels on the card. Left for later slices:
  ``--metrics-port`` and the multi-host flags; ``--checkpoint-format
  orbax`` is refused.
* ``lm`` — train and evaluate the byte-level Transformer LM on one
  device (the flash-attention kernels on the card), with ``tdn lm``'s
  corpus tiers, 95/5 split, per-step log lines and final JSON report;
  step checkpoints and resume (``--checkpoint-dir``), and a sample from
  the trained model (``--sample-bytes``, greedy or top-k / top-p
  sampling, ``--eos-id``). ``--serve-generate PORT`` then serves
  generation from the trained params (``Generate`` and
  ``GenerateStream``; the continuous scheduler by default, ``--scheduler
  static`` the run-to-completion arm, ``--serve-stages N`` the pipelined
  overlapped decoder over N stage slots with ``--serve-groups``), prints
  the report with its ``serving`` block before it blocks, and drains on
  SIGTERM; every serving flag is checked before training. ``--stages``
  trains the per-block pipeline (``--schedule`` gpipe, 1f1b,
  interleaved with ``--virtual-stages``, or the zero-bubble zb, zb-v and
  zb-stash; ``--microbatches``, ``--data-parallel`` replicas),
  Megatron-sharded with ``--tensor-parallel`` (but zb-stash); a slot
  count above the visible cards places the slots on one card, where the
  step runs as one CUDA graph. ``--seq-parallel N`` splits each row over
  N seq slots with ``--sp-mode`` ring or ulysses attention: alone (with
  ``--data-parallel`` replicas) or through the pipeline, on every
  schedule but zb-stash and with ``--tensor-parallel``; its rows carry
  ``seq_len + 1`` tokens, so the position table has one more row.
  ``--sample-pipeline-stages`` and
  ``--sample-tensor-parallel`` decode the sample in those placements.
  ``lm --stream --target HOST:PORT`` is a client only: it streams one
  generation of ``--prompt`` from a running endpoint. ``--experts E``
  trains the mixture-of-experts LM (``--router-top-k``,
  ``--capacity-factor``): on one program, with the experts over
  ``--expert-parallel`` expert slots and ``--data-parallel`` replicas,
  Megatron-split inside the experts (``--tensor-parallel``), with
  ``--seq-parallel``, or through ``--stages`` on every schedule but
  zb-stash (with ``--seq-parallel`` too: gpipe only); the JAX package's
  refusals of its other combinations come first, in its texts.
  ``--zero1`` / ``--fsdp`` with ``--data-parallel N`` train the dense LM
  with Adam's state (and, for FSDP, the params) sliced over N data
  slots, alone or with ``--seq-parallel`` (ring or Ulysses); the JAX
  package's refusals of the other combinations, in its texts. The dense
  ``--data-parallel`` without those, ``--stages`` or ``--seq-parallel``
  trains one program, as ``tdn lm`` does (it builds no mesh there), and
  says so in a log line. ``up``, ``infer`` and ``train`` take
  ``--data-parallel N`` to the Engine's data-sharded placement (N slots;
  on one card it collapses, as the JAX Engine does on one chip). Left
  for later slices: ``--metrics-port``.

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


def _engine_from_args(args, warm_rows: int = 0):
    from tpu_dist_nn_torch.api.engine import Engine

    return Engine.up(
        args.config,
        _parse_distribution(args.distribution),
        data_parallel=args.data_parallel,
        num_microbatches=args.microbatches,
        virtual_stages=args.virtual_stages,
        device=args.device,
        quantize=args.quantize,
        warm_rows=warm_rows,
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
    # A server warms its bucket ladder at bring-up, so a quantized
    # engine's warm-up gate decides at the largest serving bucket.
    engine = _engine_from_args(
        args, warm_rows=args.serve_warm_rows if args.grpc_port is not None else 0)
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
            # Every thread that can touch CUDA ends before the engine
            # (and, when cmd_up returns, the interpreter) lets go of it.
            drain.begin()
            drain.wait(args.drain_grace_seconds + 10.0)
            if not server.join_closed(args.drain_grace_seconds + 10.0):
                log.warning("serving threads still alive after the drain; downing the engine")
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


def _refuse_orbax(args) -> None:
    if args.checkpoint_dir and args.checkpoint_format == "orbax":
        raise ValueError(
            "--checkpoint-format orbax is not ported: the port writes its "
            "native .npz store (drop the flag)"
        )


def _checkpoint_manager(args):
    """The ``--checkpoint-dir`` store (asynchronous writes with
    ``--async-checkpoints``), or None."""
    if not args.checkpoint_dir:
        return None
    from tpu_dist_nn_torch.checkpoint import AsyncCheckpointManager, CheckpointManager

    manager = AsyncCheckpointManager if args.async_checkpoints else CheckpointManager
    return manager(args.checkpoint_dir, keep=args.keep_checkpoints)


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
    """Native training of an FCNN or a ``--config`` model (dense or conv),
    single-program or through the Engine's pipelined placement."""
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
    _refuse_orbax(args)
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
    checkpoints = _checkpoint_manager(args)
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


def _validate_sampling(args, cfg, generator) -> None:
    """``tdn lm``'s sampling flags, refused before training with the JAX
    package's texts (its CLI checks, then the shared generation
    contract), so a bad flag cannot discard a run."""
    from tpu_dist_nn_torch.data.text import encode
    from tpu_dist_nn_torch.models.generate import validate_generate_args

    if args.sample_tensor_parallel > 1 and args.sample_bytes <= 0:
        raise ValueError(
            "--sample-tensor-parallel requires --sample-bytes > 0 "
            "(it shards the decode; without sampling it would be "
            "silently ignored)"
        )
    if args.sample_pipeline_stages > 1 and args.sample_bytes <= 0:
        raise ValueError(
            "--sample-pipeline-stages requires --sample-bytes > 0 "
            "(it places the decode; without sampling it would be "
            "silently ignored)"
        )
    if args.eos_id is not None and not 0 <= args.eos_id < 256:
        raise ValueError(f"--eos-id must be a byte id in [0, 256), got {args.eos_id}")
    if args.sample_bytes <= 0:
        return
    if args.temperature < 0:
        raise ValueError("--temperature must be >= 0")
    prompt_len = len(encode(args.prompt))
    if prompt_len == 0:
        raise ValueError("--prompt must be non-empty")
    if prompt_len >= args.seq_len:
        raise ValueError(
            f"--prompt is {prompt_len} bytes but must be shorter than "
            f"--seq-len {args.seq_len} to leave room for generation"
        )
    if args.sample_bytes > args.seq_len - prompt_len:
        raise ValueError(
            f"--sample-bytes {args.sample_bytes} does not fit: the "
            f"{prompt_len}-byte prompt leaves {args.seq_len - prompt_len} "
            f"positions within --seq-len {args.seq_len}"
        )
    if args.eos_id is not None and (args.sample_pipeline_stages > 1
                                    or args.sample_tensor_parallel > 1):
        raise ValueError(
            "--eos-id applies to the single-chip decode only (the "
            "pipelined/tensor-parallel decoders have no done-mask); "
            "drop the placement flag to sample with a stop token"
        )
    spp, stp = args.sample_pipeline_stages, args.sample_tensor_parallel
    if spp > 1:
        if stp > 1:
            raise ValueError(
                "--sample-pipeline-stages and --sample-tensor-parallel "
                "are different decode placements: pick one"
            )
        if args.layers % spp:
            raise ValueError(
                f"--sample-pipeline-stages {spp} must divide "
                f"--layers ({args.layers})"
            )
    if stp > 1 and (args.heads % stp or (4 * args.d_model) % stp):
        raise ValueError(
            f"--sample-tensor-parallel {stp} must divide --heads "
            f"({args.heads}) and d_ff (4*--d-model = {4 * args.d_model})"
        )
    validate_generate_args(cfg, prompt_len, args.sample_bytes, args.temperature, args.top_k,
                           args.top_p, generator, args.eos_id)


def _validate_zero(args) -> None:
    """``--zero1`` / ``--fsdp`` with the JAX package's texts and in its
    order (checked with the dense LM's placement flags)."""
    if args.zero1 and args.fsdp:
        raise ValueError("--fsdp already shards the optimizer state; drop --zero1")
    if (args.zero1 or args.fsdp) and args.data_parallel < 2:
        raise ValueError(
            ("--fsdp" if args.fsdp else "--zero1")
            + " shards over the data axis: needs --data-parallel >= 2"
        )
    if args.stages > 1 and (args.zero1 or args.fsdp):
        raise ValueError(
            "--zero1/--fsdp compose with --data-parallel only "
            "(state already lives per-stage in the pipeline)"
        )


def _validate_moe(args) -> None:
    """``tdn lm --experts``'s flags, with the JAX package's texts and in
    its order, before any work (sampling and serving a MoE LM included:
    the JAX package refuses both)."""
    if args.schedule == "zb-v" and args.virtual_stages not in (None, 2):
        raise ValueError(
            "--schedule zb-v fixes the chunk count at 2 per device (the "
            "V placement's two legs); drop --virtual-stages or use "
            "--schedule zb for a free chunk count"
        )
    if args.tensor_parallel > 1:
        if args.stages > 1:
            raise ValueError(
                "--tensor-parallel x --experts x --stages is out "
                "of scope: TP-inside-experts runs on the flat "
                "(model, expert, data) mesh; pipelined MoE shards "
                "experts over `expert` (README matrix footnote)"
            )
        if args.seq_parallel > 1:
            raise ValueError(
                "--tensor-parallel x --experts x --seq-parallel "
                "is out of scope (README matrix footnote)"
            )
        if (4 * args.d_model) % args.tensor_parallel:
            raise ValueError(
                f"d_ff={4 * args.d_model} must be divisible by "
                f"--tensor-parallel {args.tensor_parallel} "
                "(TP-inside-experts shards the FF dim)"
            )
    if args.sample_tensor_parallel > 1 and args.sample_bytes <= 0:
        raise ValueError(
            "--sample-tensor-parallel requires --sample-bytes > 0 "
            "(it shards the decode; without sampling it would be "
            "silently ignored)"
        )
    if args.sample_pipeline_stages > 1 and args.sample_bytes <= 0:
        raise ValueError(
            "--sample-pipeline-stages requires --sample-bytes > 0 "
            "(it places the decode; without sampling it would be "
            "silently ignored)"
        )
    if args.serve_generate is not None:
        raise ValueError("--serve-generate supports the dense LM only")
    if args.sample_bytes > 0:
        raise ValueError("--sample-bytes supports the dense LM only")
    if args.zero1:
        raise ValueError("--zero1 supports the dense LM only")
    if args.seq_parallel > 1 and args.stages > 1 and args.schedule != "gpipe":
        raise ValueError(
            "--experts x --seq-parallel x --stages supports --schedule "
            "gpipe only (three-axis MoE rides the branch-free gpipe "
            "executor; the scheduled executors' three-axis product is "
            "out of scope — README matrix footnote)"
        )
    if args.fsdp:
        raise ValueError("--fsdp supports the dense LM only")
    ep, dp, mb = max(args.expert_parallel, 1), args.data_parallel, args.microbatches
    if args.stages > 1 and args.layers % args.stages:
        raise ValueError(f"--layers {args.layers} must be divisible by --stages {args.stages}")
    if args.seq_parallel > 1 and (args.seq_len + 1) % args.seq_parallel:
        raise ValueError(
            f"--seq-len+1 ({args.seq_len + 1}) must be divisible "
            f"by --seq-parallel {args.seq_parallel} (rows carry "
            "the next-token target)"
        )
    if args.stages > 1:
        if args.batch_size % (mb * ep * dp):
            raise ValueError(
                f"--batch-size {args.batch_size} must be divisible by "
                f"microbatches*expert_parallel*data_parallel={mb * ep * dp}"
            )
    elif args.batch_size % (ep * dp):
        raise ValueError(
            f"--batch-size {args.batch_size} must be divisible "
            f"by expert_parallel*data_parallel={ep * dp}"
        )
    if args.schedule != "gpipe" and args.stages <= 1:
        raise ValueError(
            f"--schedule {args.schedule} applies to the pipelined dense LM "
            "only (--stages > 1, without --experts/--seq-parallel/"
            "--zero1/--fsdp)"
        )
    if args.sp_mode != "ring" and args.seq_parallel <= 1:
        raise ValueError(
            "--sp-mode requires --seq-parallel > 1 (it picks the "
            "sequence-parallel decomposition)"
        )
    if args.stages > 1 and args.schedule == "zb-stash":
        raise ValueError(
            "zb-stash is dense-LM only (the stash split knows the "
            "dense block structure); use schedule='zb' with --experts"
        )
    if args.seq_parallel > 1 and args.sp_mode == "ulysses" and args.heads % args.seq_parallel:
        raise ValueError(f"ulysses needs n_heads ({args.heads}) divisible by the seq axis "
                         f"({args.seq_parallel})")


def _validate_parallel(args) -> None:
    """``tdn lm``'s pipeline and tensor-parallel flags, with the JAX
    package's texts, before any work."""
    if args.experts <= 0 and args.expert_parallel > 1:
        raise ValueError("--expert-parallel requires --experts > 0")
    if args.experts > 0:
        _validate_moe(args)
        return
    if args.schedule == "zb-v" and args.virtual_stages not in (None, 2):
        raise ValueError(
            "--schedule zb-v fixes the chunk count at 2 per device (the "
            "V placement's two legs); drop --virtual-stages or use "
            "--schedule zb for a free chunk count"
        )
    if args.tensor_parallel > 1:
        if args.stages <= 1:
            raise ValueError(
                "--tensor-parallel shards each pipeline stage's "
                "blocks: it requires --stages > 1 (use "
                "--sample-tensor-parallel for sharded decode)"
            )
        if args.heads % args.tensor_parallel:
            raise ValueError(
                f"--heads {args.heads} must be divisible by "
                f"--tensor-parallel {args.tensor_parallel} "
                "(Megatron shards attention head-wise)"
            )
    _validate_zero(args)
    if args.schedule != "gpipe" and args.stages <= 1:
        raise ValueError(
            f"--schedule {args.schedule} applies to the pipelined dense LM "
            "only (--stages > 1, without --experts/--seq-parallel/"
            "--zero1/--fsdp)"
        )
    if args.sp_mode != "ring" and args.seq_parallel <= 1:
        raise ValueError(
            "--sp-mode requires --seq-parallel > 1 (it picks the "
            "sequence-parallel decomposition)"
        )
    if args.seq_parallel > 1:
        _validate_seq_parallel(args)
    if args.stages > 1:
        if args.batch_size % (args.microbatches * args.data_parallel):
            raise ValueError(
                f"--batch-size {args.batch_size} must be divisible "
                f"by microbatches*data_parallel="
                f"{args.microbatches * args.data_parallel}"
            )
    elif (args.zero1 or args.fsdp) and args.seq_parallel <= 1 and (
            args.batch_size % args.data_parallel):
        raise ValueError(
            f"--batch-size {args.batch_size} must be divisible by "
            f"--data-parallel {args.data_parallel}"
        )


def _validate_seq_parallel(args) -> None:
    """``--seq-parallel``'s sizes, with the JAX package's texts (the
    ulysses head split and zb-stash are refused there when the step is
    built; here before any work)."""
    n = args.seq_parallel
    if (args.seq_len + 1) % n:
        raise ValueError(
            f"--seq-len+1 ({args.seq_len + 1}) must be divisible by --seq-parallel {n} "
            "(rows carry the next-token target)"
        )
    if args.stages <= 1 and args.batch_size % args.data_parallel:
        raise ValueError(
            f"--batch-size {args.batch_size} must be divisible by "
            f"--data-parallel {args.data_parallel}"
        )
    if args.stages > 1 and args.schedule == "zb-stash":
        raise ValueError(
            "zb-stash is dense-LM only (the stash split knows the "
            "dense block structure); use schedule='zb' with "
            "seq-parallel"
        )
    if args.sp_mode == "ulysses":
        if args.stages <= 1 and args.heads % n:
            raise ValueError(
                f"--sp-mode ulysses needs n_heads ({args.heads}) divisible by the seq axis "
                f"({n}); use ring or adjust heads")
        local = args.heads // args.tensor_parallel
        if args.stages > 1 and local % n:
            raise ValueError(f"ulysses needs n_heads ({local}) divisible by the seq axis ({n})")


def _default_virtual(args) -> int:
    """--virtual-stages' default: 2 for interleaved (it IS the v > 1
    placement), else 1 (zb's contiguous placement); zb-v's V fixes 2."""
    if args.schedule == "zb-v":
        return 2
    if args.virtual_stages is not None:
        return args.virtual_stages
    return 2 if args.schedule == "interleaved" else 1


def _slot_devices(device, n: int) -> list:
    """``n`` slots: the visible cards when there are enough, else ``n``
    slots (streams) of ``device``'s one card (or the CPU)."""
    from tpu_dist_nn_torch.parallel.mesh import visible_devices

    cards = visible_devices(device)
    return cards[:n] if len(cards) >= n else [device] * n


def _validate_serving(args, cfg, generator) -> None:
    """``tdn lm --serve-generate``'s flags, refused before training with
    the JAX package's texts (its CLI checks, then the endpoint's decode
    contract), so a bad combination cannot discard a run."""
    from tpu_dist_nn_torch.models.generate import validate_generate_args

    if args.gen_slots < 1:
        raise ValueError(f"--gen-slots must be >= 1, got {args.gen_slots}")
    if args.prefill_chunk is not None and args.prefill_chunk < 1:
        raise ValueError(f"--prefill-chunk must be >= 1, got {args.prefill_chunk}")
    if args.prefix_cache_blocks < 0:
        raise ValueError(
            f"--prefix-cache-blocks must be >= 0, got {args.prefix_cache_blocks}"
        )
    _parse_class_watermarks(args.class_watermarks)
    if args.serve_generate is None:
        return
    if args.scheduler == "continuous" and args.serve_stages > 1:
        raise ValueError(
            "--scheduler continuous is single-chip; --serve-stages "
            "> 1 serves the pipelined overlapped decoder (use "
            "--scheduler static or auto)"
        )
    if args.eos_id is not None and args.serve_stages > 1:
        raise ValueError(
            "--eos-id is not supported by the pipelined overlapped "
            "decoder; serve --serve-stages 1 for stop-token "
            "semantics"
        )
    if (args.prefix_cache_blocks or args.prefill_chunk is not None) \
            and (args.scheduler == "static" or args.serve_stages > 1):
        raise ValueError(
            "--prefix-cache-blocks / --prefill-chunk are continuous-"
            "scheduler features; drop --scheduler static / "
            "--serve-stages > 1 (or drop the prefix/chunk flags)"
        )
    if (args.prefix_cache_blocks and args.prefill_chunk is not None
            and args.prefill_chunk > args.serve_prompt_len - 1):
        raise ValueError(
            f"--prefix-cache-blocks needs a cacheable tier: "
            f"--prefill-chunk {args.prefill_chunk} must be <= "
            f"--serve-prompt-len - 1 = {args.serve_prompt_len - 1}"
        )
    if args.layers % max(args.serve_stages, 1):
        raise ValueError(
            f"--layers {args.layers} must be divisible by "
            f"--serve-stages {args.serve_stages}"
        )
    if args.serve_prompt_len + args.serve_new_tokens - 1 > args.seq_len:
        raise ValueError(
            f"--serve-prompt-len {args.serve_prompt_len} + "
            f"--serve-new-tokens {args.serve_new_tokens} - 1 must fit "
            f"--seq-len {args.seq_len} (the positional table)"
        )
    if args.serve_groups is not None and args.serve_groups < args.serve_stages:
        raise ValueError(
            f"--serve-groups {args.serve_groups} must be >= "
            f"--serve-stages {args.serve_stages} (the round-robin "
            "grants each group G ticks before its next decode)"
        )
    validate_generate_args(cfg, args.serve_prompt_len, args.serve_new_tokens,
                           args.temperature, args.top_k, args.top_p, generator, args.eos_id)


def _lm_stream_demo(args) -> int:
    """Client-only streaming (``lm --stream --target HOST:PORT``): no
    training, no model — stream ONE generation of ``--prompt`` from a
    running ``--serve-generate`` endpoint over ``GenerateStream``,
    printing bytes as each token frame lands, then a JSON latency
    summary (TTFT, inter-token gaps, the terminal)."""
    from tpu_dist_nn_torch.data.text import decode, encode
    from tpu_dist_nn_torch.serving.server import GrpcClient

    if not args.target:
        raise ValueError(
            "tdn lm --stream is client-only: pass --target HOST:PORT of "
            "a running --serve-generate endpoint (continuous scheduler; "
            "a router front door works too)"
        )
    T = args.serve_prompt_len
    ids = encode(args.prompt).tolist()
    # The endpoint decodes ONE static prompt shape: pad on the LEFT with
    # spaces so the text stays next to its continuation; keep the tail.
    row = ([32] * max(0, T - len(ids)) + ids)[-T:]
    client = GrpcClient(args.target, session_key=args.session_key)
    t0 = time.monotonic()
    first = last = None
    gaps: list[float] = []
    n = 0
    try:
        reply = client.generate_stream(np.asarray([row], np.int64))
        for tok in reply:
            now = time.monotonic()
            if first is None:
                first = now - t0
            else:
                gaps.append(now - last)
            last = now
            n += 1
            sys.stdout.write(decode([tok]))
            sys.stdout.flush()
        sys.stdout.write("\n")
        print(json.dumps({
            "tokens": n,
            "ttft_s": round(first, 6) if first is not None else None,
            "intertoken_p50_ms": (round(sorted(gaps)[len(gaps) // 2] * 1000, 3)
                                  if gaps else None),
            "intertoken_max_ms": round(max(gaps) * 1000, 3) if gaps else None,
            "finish": reply.finish,
            "trace_id": reply.trace_id,
        }), flush=True)
        return 0
    finally:
        client.close()


def _serve_generation(args, params, cfg, device, report) -> None:
    """Serve generation from the trained params until
    ``--serve-seconds`` pass, SIGINT, or SIGTERM (a graceful drain); the
    report, with its ``serving`` block, is printed before blocking."""
    from tpu_dist_nn_torch.serving.resilience import GracefulDrain
    from tpu_dist_nn_torch.serving.server import serve_lm_generate

    drain = GracefulDrain(grace_seconds=args.drain_grace_seconds)
    server, bound = serve_lm_generate(
        params, cfg, args.serve_generate, max_new_tokens=args.serve_new_tokens,
        prompt_len=args.serve_prompt_len, num_stages=args.serve_stages,
        num_groups=args.serve_groups, temperature=args.temperature, top_k=args.top_k,
        top_p=args.top_p, seed=args.seed, max_pending_rows=args.max_pending_rows,
        class_watermarks=_parse_class_watermarks(args.class_watermarks),
        scheduler=args.scheduler, gen_slots=args.gen_slots, eos_id=args.eos_id,
        prefix_cache_blocks=args.prefix_cache_blocks, prefill_chunk=args.prefill_chunk,
        # The continuous endpoint opens hot (its chunk lengths run and
        # its step is captured); the static arm's ladder stays opt-in.
        warm_rows=1 if args.scheduler in ("continuous", "auto") else 0,
        device=device,
    )
    # SIGTERM -> drain: stop accepting, finish in-flight decodes within
    # --drain-grace-seconds, then exit.
    drain.add_server(server)
    drain.install_signal_handler()
    report["serving"] = {
        "port": bound,
        "prompt_len": args.serve_prompt_len,
        "max_new_tokens": args.serve_new_tokens,
        "stages": args.serve_stages,
        "scheduler": "continuous" if server.scheduler is not None else "static",
    }
    if server.scheduler is not None:
        report["serving"]["gen_slots"] = args.gen_slots
        report["serving"]["prefix_cache_blocks"] = args.prefix_cache_blocks
        report["serving"]["prefill_chunk"] = args.prefill_chunk
    print(json.dumps(report), flush=True)
    try:
        # A SIGTERM-initiated drain ends the wait early.
        drain.wait(args.serve_seconds)
    except KeyboardInterrupt:
        pass
    drain.begin()
    drain.wait(args.drain_grace_seconds + 10.0)
    # Every serving thread ends before the process lets go of the card.
    if not server.join_closed(args.drain_grace_seconds + 10.0):
        log.warning("serving threads still alive after the drain")


def _sample(args, params, cfg, prompt, generator, device):
    """``--sample-bytes`` new tokens: single-program, in the pipeline
    placement (``--sample-pipeline-stages``) or Megatron-sharded
    (``--sample-tensor-parallel``)."""
    import torch

    from tpu_dist_nn_torch.models.generate import generate
    from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh

    n = args.sample_bytes
    kw = dict(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p)
    spp, stp = args.sample_pipeline_stages, args.sample_tensor_parallel
    if spp > 1:
        from tpu_dist_nn_torch.parallel.pp_generate import make_pipeline_generate
        from tpu_dist_nn_torch.parallel.transformer_pipeline import shard_blocks

        mesh = build_mesh(MeshSpec(stage=spp), _slot_devices(device, spp))
        fn = make_pipeline_generate(mesh, cfg, spp, n, **kw)
        full = fn(dict(params, blocks=shard_blocks(params["blocks"], spp)),
                  torch.as_tensor(prompt, device=device),
                  generator if args.temperature != 0 else None)
        return full[:, prompt.shape[1]:]
    if stp > 1:
        from tpu_dist_nn_torch.parallel.tensor_parallel import tp_shard_blocks
        from tpu_dist_nn_torch.parallel.tp_generate import tp_generate

        mesh = build_mesh(MeshSpec(model=stp), _slot_devices(device, stp))
        return tp_generate(mesh, dict(params, blocks=tp_shard_blocks(params["blocks"], cfg, stp)),
                           cfg, torch.as_tensor(prompt, device=device), n,
                           generator=generator if args.temperature != 0 else None, **kw)
    return generate(params, cfg, prompt, n, generator=generator, eos_id=args.eos_id, **kw)


def cmd_lm(args) -> int:
    """Train + evaluate the byte-level Transformer LM (``tdn lm``'s
    single-device path), resuming from and saving to ``--checkpoint-dir``,
    then sample ``--sample-bytes`` from it and serve generation
    (``--serve-generate``); ``--stream`` is the streaming client."""
    if args.stream:
        # Client only: nothing below (training, the model) applies.
        return _lm_stream_demo(args)
    import torch

    from tpu_dist_nn_torch.data.text import (
        decode,
        encode,
        lm_batches,
        lm_sequences,
        load_corpus,
    )
    from tpu_dist_nn_torch.models.transformer import (
        TransformerConfig,
        init_transformer,
        num_params,
    )
    from tpu_dist_nn_torch.parallel import expert_parallel as epl
    from tpu_dist_nn_torch.train.lm_trainer import (
        LMTrainConfig,
        evaluate_lm,
        evaluate_moe_lm,
        train_lm,
    )
    from tpu_dist_nn_torch.utils.device import resolve_device

    _refuse_orbax(args)
    device = resolve_device(args.device)
    _validate_parallel(args)
    moe = args.experts > 0
    common = dict(
        vocab_size=256, d_model=args.d_model, n_heads=args.heads, n_layers=args.layers,
        # sp feeds full (seq_len + 1)-token rows: one more position
        d_ff=4 * args.d_model, max_seq_len=args.seq_len + (1 if args.seq_parallel > 1 else 0),
        compute_dtype="bfloat16" if args.bf16 else "float32", remat=args.remat)
    if moe:
        cfg = epl.MoEConfig(**common, n_experts=args.experts,
                            capacity_factor=args.capacity_factor,
                            router_top_k=args.router_top_k)
        init_fn, eval_fn = epl.init_moe_transformer, evaluate_moe_lm
    else:
        cfg = TransformerConfig(**common)
        init_fn, eval_fn = init_transformer, evaluate_lm
    generator = torch.Generator(device=device).manual_seed(args.seed)
    _validate_sampling(args, cfg, generator)
    _validate_serving(args, cfg, generator)
    text, source = load_corpus(args.corpus)
    rows = lm_sequences(encode(text), args.seq_len)
    split = max(1, int(len(rows) * 0.95))
    train_rows, eval_rows = rows[:split], rows[split:]
    params = init_fn(torch.Generator().manual_seed(args.seed), cfg, device=device)
    log.info("tiny-transformer%s: %d params, corpus=%s, %d train rows, %d eval rows, device %s",
             f" (MoE x{args.experts})" if moe else "", num_params(params), source,
             len(train_rows), len(eval_rows), device)
    train_cfg = LMTrainConfig(
        learning_rate=args.lr, steps=args.steps, batch_size=args.batch_size,
        seq_len=args.seq_len, clip_norm=args.clip_norm, warmup_steps=args.warmup_steps,
        lr_schedule=args.lr_schedule, weight_decay=args.weight_decay,
        grad_accum=args.grad_accum, log_every=args.log_every,
        steps_per_call=args.steps_per_call)
    batches = lm_batches(train_rows, args.batch_size, seed=args.seed, epochs=None)
    checkpoints = _checkpoint_manager(args)
    pipeline = {}
    flat_moe = moe and max(args.expert_parallel, args.data_parallel, args.tensor_parallel) > 1
    if args.zero1 or args.fsdp:
        from tpu_dist_nn_torch.parallel import zero
        from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh

        spec = MeshSpec(seq=args.seq_parallel, data=args.data_parallel)
        zero_mesh = build_mesh(spec, _slot_devices(device, spec.num_devices))
        if args.seq_parallel > 1:
            pipeline = dict(step_fn=lambda opt: zero.make_sp_sharded_lm_train_step(
                zero_mesh, cfg, opt, params, mode=args.sp_mode, shard_params=args.fsdp))
        else:
            make = zero.make_fsdp_lm_train_step if args.fsdp else zero.make_zero_lm_train_step
            pipeline = dict(step_fn=lambda opt: make(zero_mesh, cfg, opt, params))
    elif args.data_parallel > 1 and not moe and args.stages <= 1 and args.seq_parallel <= 1:
        log.info("--data-parallel %d without --zero1/--fsdp, --stages or --seq-parallel: "
                 "the dense LM trains as one program (tdn lm builds no mesh here)",
                 args.data_parallel)
    elif args.stages > 1 or args.seq_parallel > 1 or flat_moe:
        from tpu_dist_nn_torch.parallel.mesh import MeshSpec, build_mesh

        spec = MeshSpec(stage=args.stages, data=args.data_parallel, model=args.tensor_parallel,
                        seq=args.seq_parallel, expert=max(args.expert_parallel, 1))
        pipeline = dict(mesh=build_mesh(spec, _slot_devices(device, spec.num_devices)),
                        num_stages=args.stages, num_microbatches=args.microbatches,
                        schedule=args.schedule, num_virtual=_default_virtual(args),
                        tensor_parallel=args.tensor_parallel, sp_mode=args.sp_mode)
    t0 = time.monotonic()
    try:
        params, history = train_lm(params, cfg, batches, train_cfg, checkpoints=checkpoints,
                                   **pipeline)
    finally:
        if hasattr(checkpoints, "close"):
            checkpoints.close()
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
    eval_metrics = eval_fn(params, cfg, eval_rows_used, batch_size=args.batch_size,
                           max_batches=cap if cap > 0 else None)
    report = {
        "train_seconds": round(train_seconds, 2),
        "final_train_loss": history[-1]["loss"] if history else None,
        "eval_split": "held-out" if held_out else "full-dataset",
        **{k: round(v, 4) for k, v in eval_metrics.items()},
    }
    if args.metrics_out:
        _write_metrics_jsonl(args.metrics_out, history + [{"final_report": report}])
    if args.sample_bytes > 0:
        # Sizes and flags were validated before training.
        out = _sample(args, params, cfg, encode(args.prompt)[None, :], generator, device)
        sample_row = out[0].cpu().numpy()
        if args.eos_id is not None:
            # Trim at the stop token: everything after it is pad.
            hits = np.flatnonzero(sample_row == args.eos_id)
            if hits.size:
                sample_row = sample_row[:hits[0]]
        # Raw bytes decode as UTF-8 with replacement: the string may be
        # shorter than the bytes.
        report["sample"] = decode(sample_row)
    if args.serve_generate is not None:
        _serve_generation(args, params, cfg, device, report)
        return 0
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
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="K optimizer steps per device call (one "
                        "lax.scan over a K-step superbatch): removes "
                        "per-step Python dispatch + host sync on the "
                        "single-chip path; losses fetch once per call")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stages", type=int, default=1,
                   help="pipeline stages (per-block pipeline over stage slots) when > 1")
    p.add_argument("--schedule", choices=["gpipe", "1f1b", "interleaved", "zb", "zb-v",
                                          "zb-stash"], default="gpipe",
                   help="pipeline training schedule when --stages > 1 "
                        "(interleaved = Megatron virtual stages, see "
                        "--virtual-stages; zb = zero-bubble ZB-H1 split "
                        "backward, half the 1F1B bubble; zb-v = zero "
                        "bubble on the V-shape placement — bubble S-1 "
                        "chunk-ticks independent of M (zb needs larger "
                        "M to match), embedding+loss co-located; "
                        "zb-stash = ZB-H1 with the cotangent-stash "
                        "split: W ticks are pure dW GEMMs, no "
                        "recompute — the measured-cost zero bubble, "
                        "dense LM only, ~16x bridge memory)")
    p.add_argument("--virtual-stages", type=int, default=None,
                   help="model chunks per device for --schedule "
                        "interleaved/zb (bubble shrinks ~v-fold under "
                        "interleaved); default 2 for interleaved, 1 "
                        "(classic contiguous placement) for zb")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="data replicas of the pipeline (with --stages > 1), of the "
                        "sequence-parallel program (with --seq-parallel > 1), or of the "
                        "ZeRO-1 / FSDP step (with --zero1 / --fsdp)")
    p.add_argument("--seq-parallel", type=int, default=1,
                   help="shard the sequence axis over N seq slots for long-context "
                        "training (see --sp-mode)")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="Megatron-shard each stage's blocks over N model slots "
                        "(requires --stages > 1); with --experts, each expert's FFN")
    p.add_argument("--sample-tensor-parallel", type=int, default=1,
                   help="decode --sample-bytes with heads + KV cache Megatron-sharded "
                        "over N model slots")
    p.add_argument("--sample-pipeline-stages", type=int, default=1,
                   help="decode --sample-bytes IN the pipeline placement: blocks + "
                        "per-stage KV caches over N stage slots")
    p.add_argument("--sp-mode", choices=["ring", "ulysses"], default="ring",
                   help="sequence-parallel decomposition: ring attention "
                        "(K/V rotation, O(T/N) memory) or ulysses "
                        "(all-to-all head scatter; needs heads %% N == 0)")
    p.add_argument("--microbatches", type=int, default=4)
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: slice Adam's moments over the --data-parallel slots "
                        "(dense LM; alone or with --seq-parallel)")
    p.add_argument("--fsdp", action="store_true",
                   help="FSDP: slice the params and Adam's moments over the "
                        "--data-parallel slots, gathered at use")
    p.add_argument("--experts", type=int, default=0,
                   help="MoE: experts per block (0 = dense MLP)")
    p.add_argument("--capacity-factor", type=float, default=1.25)
    p.add_argument("--router-top-k", type=int, default=1, choices=[1, 2],
                   help="experts per token: 1 = Switch, 2 = GShard gates")
    p.add_argument("--expert-parallel", type=int, default=1,
                   help="shard experts over this many expert slots (all_to_all)")
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
    p.add_argument("--checkpoint-dir",
                   help="save per-interval training state here and resume from it")
    p.add_argument("--keep-checkpoints", type=int, default=3)
    p.add_argument("--async-checkpoints", action="store_true",
                   help="write checkpoints on a background thread")
    p.add_argument("--checkpoint-format", choices=["native", "orbax"], default="native",
                   help="native .npz store (orbax is not ported)")
    p.add_argument("--sample-bytes", type=int, default=0,
                   help="generate this many bytes after training")
    p.add_argument("--prompt", default="The ", help="generation prompt")
    p.add_argument("--top-k", type=int, default=None,
                   help="sample from the k highest-probability bytes only")
    p.add_argument("--top-p", type=float, default=None,
                   help="nucleus sampling: smallest set with cumulative probability >= p")
    p.add_argument("--temperature", type=float, default=0.8, help="0 = greedy")
    p.add_argument("--eos-id", type=int, default=None,
                   help="stop token: a generated row freezes at this byte id and pads "
                        "the remainder with it (--sample-bytes, and both "
                        "--serve-generate schedulers identically)")
    p.add_argument("--serve-generate", type=int, default=None, metavar="PORT",
                   help="after training, serve GENERATION on this port (0 = ephemeral; "
                        "the reference wire's Matrix of token ids on "
                        "LayerService/Generate, and GenerateStream). Sampling follows "
                        "--temperature/--top-k/--top-p")
    p.add_argument("--serve-stages", type=int, default=1,
                   help="serve decode in the pipelined placement with the OVERLAPPED "
                        "round-robin decoder (requests coalesce into its group slots)")
    p.add_argument("--serve-groups", type=int, default=None,
                   help="round-robin request groups for --serve-stages "
                        "(default max(stages, 2))")
    p.add_argument("--serve-prompt-len", type=int, default=16,
                   help="the endpoint's static prompt length")
    p.add_argument("--serve-new-tokens", type=int, default=32,
                   help="tokens generated per request")
    p.add_argument("--scheduler", choices=["auto", "static", "continuous"], default="auto",
                   help="decode scheduling for --serve-generate: continuous = the "
                        "iteration-level slot scheduler (admit at step granularity, "
                        "retire on EOS/budget); static = the run-to-completion batch "
                        "(the A/B control arm); auto (default) = continuous")
    p.add_argument("--gen-slots", type=int, default=8,
                   help="KV-cache slots of the continuous scheduler (sequences "
                        "decoding a step)")
    p.add_argument("--prefix-cache-blocks", type=int, default=0,
                   help="shared-prefix KV pool blocks in the continuous scheduler's "
                        "slot cache: prompts sharing a cached prefix admit by block "
                        "copy + suffix-only prefill (ref-counted, LRU; 0 = off)")
    p.add_argument("--prefill-chunk", type=int, default=None, metavar="TOKENS",
                   help="prefill prompts in chunks of at most this many tokens, one "
                        "chunk a scheduler iteration; also the prefix-cache tier "
                        "grain (default: the whole prompt in one launch)")
    p.add_argument("--serve-seconds", type=float, default=None,
                   help="serve for N seconds then exit (default: until interrupted)")
    p.add_argument("--max-pending-rows", type=int, default=None,
                   help="admission-control watermark for --serve-generate: requests "
                        "that would queue past this many pending rows are shed "
                        "RESOURCE_EXHAUSTED (default: unbounded)")
    p.add_argument("--class-watermarks", default=None, metavar="SPEC",
                   help="per-SLO-class shed fractions of --max-pending-rows, e.g. "
                        "'critical=1.0,standard=1.0,best_effort=0.5' (the default)")
    p.add_argument("--drain-grace-seconds", type=float, default=5.0,
                   help="graceful-drain window on SIGTERM while serving: finish "
                        "in-flight decodes within this long before exit")
    p.add_argument("--stream", action="store_true",
                   help="client only: stream ONE generation of --prompt from a running "
                        "--serve-generate endpoint (--target HOST:PORT) over "
                        "LayerService/GenerateStream, printing bytes as each token "
                        "frame lands, then a JSON latency summary. The prompt "
                        "pads/truncates to --serve-prompt-len")
    p.add_argument("--target", default=None, metavar="HOST:PORT",
                   help="the --serve-generate endpoint for --stream")
    p.add_argument("--session-key", default=None,
                   help="x-tdn-session affinity key for --stream behind a router")
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
