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
