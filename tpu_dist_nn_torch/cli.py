"""Command line for the PyTorch/CUDA port: ``python -m tpu_dist_nn_torch.cli``.

Verbs ported from ``tdn`` (:mod:`tpu_dist_nn.cli`), with the same
printed lines:

* ``infer`` — local-engine inference of a dense or conv model JSON over
  an examples file: whole set, ``--batch-size`` chunks, or one
  ``input_index``; ``--quantize int8`` (dense models);
  ``--distribution`` (validated, then served on one card).
* ``oracle`` — the float64 numpy baseline (scripts/manual_nn.py:88-99).
* ``doctor`` — a readiness report: the forward against the oracle, and
  a ``fused_dense`` kernel probe against its plain version.
* ``lm`` — train and evaluate the byte-level Transformer LM on one
  device (the flash-attention kernels on the card), with ``tdn lm``'s
  corpus tiers, 95/5 split, per-step log lines and final JSON report.
  Its generation, serving, checkpoint and parallel flags wait for their
  slices.

Everything runs on the card unless ``--device cpu`` is given.
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


def cmd_infer(args) -> int:
    from tpu_dist_nn_torch.api.engine import Engine
    from tpu_dist_nn_torch.core.schema import load_examples

    engine = Engine.up(
        args.config,
        _parse_distribution(args.distribution),
        device=args.device,
        quantize=args.quantize,
    )
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

    p = sub.add_parser("infer", help="run inference on a local engine")
    p.add_argument("input_index", nargs="?", type=int, default=None)
    p.add_argument("--config", required=True, help="model JSON file")
    p.add_argument("--inputs", required=True, help="example inputs JSON file")
    p.add_argument("--distribution", help="layer distribution, e.g. 1,1,1")
    p.add_argument("--quantize", choices=["int8"],
                   help="serve through the int8 chain kernel")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu' for the plain PyTorch path")
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("oracle", help="numpy float64 baseline (manual_nn)")
    p.add_argument("--config", required=True)
    p.add_argument("--inputs", required=True)
    p.set_defaults(fn=cmd_oracle)

    p = sub.add_parser("doctor", help="readiness report: oracle parity + kernel probe")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu' for the plain PyTorch path")
    p.set_defaults(fn=cmd_doctor)

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
    except (ValueError, FileNotFoundError, FrameworkError) as e:
        # Config/placement errors and a missing card are user errors,
        # not crashes.
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
