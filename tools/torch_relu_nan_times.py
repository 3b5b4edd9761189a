#!/usr/bin/env python3
"""Device time of the kernels whose relu, pool max or int8 row maximum keeps
NaN (the F9 repair), at the main paths' shapes, on one GPU.

Times, with CUDA events (TF32 off), each call both in a host loop of 50
and as a CUDA graph of 50: ``fused_dense`` relu at 8192 x 784 -> 128,
``fcnn_fused_forward`` 784-128-64-10 at 8192 rows and the conv tail's
2048-64-10 at 1024, ``fcnn_quantized_forward`` 784-128-64-10 at 8192
(relu, relu, softmax), and ``fused_conv2d`` relu + 2x2 pool on the
CIFAR-10 network's two stages at batch 1024. Seeded weights and inputs;
four rotating dense inputs (4 x 25.7 MB, more than the 50 MB L2). Prints
one JSON line: the card, the root, and each kernel's median of
``--repeat`` timings a timer.

    python3 tools/torch_relu_nan_times.py [--root CHECKOUT] [--repeat 5]

``--root`` imports ``tpu_dist_nn_torch`` from another checkout (the
parent commit, say), which builds its own kernels, so two versions can
be timed in one machine call, in turns.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="checkout whose tpu_dist_nn_torch is imported")
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tpu_dist_nn_torch.kernels import (
        fcnn_fused_forward,
        fcnn_quantized_forward,
        fused_conv2d,
        fused_dense,
        quantize_fcnn,
    )
    from tpu_dist_nn_torch.utils.profiling import cuda_graph_time_ms, cuda_time_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)

    def dense(din, dout, act):
        return {"w": (torch.randn(din, dout, generator=g) * math.sqrt(2.0 / din)).to(dev),
                "b": (torch.randn(dout, generator=g) * 0.05).to(dev), "act": act}

    relu, softmax = 1, 3  # core/activations.py's ids
    mnist = [dense(784, 128, relu), dense(128, 64, relu), dense(64, 10, softmax)]
    tail = [dense(2048, 64, relu), dense(64, 10, softmax)]
    q = quantize_fcnn(mnist)
    xs = [torch.rand(8192, 784, generator=g).to(dev) for _ in range(4)]
    x_tail = torch.rand(1024, 2048, generator=g).to(dev)
    img1 = torch.rand(1024, 32, 32, 3, generator=g).to(dev)
    img2 = torch.rand(1024, 16, 16, 16, generator=g).to(dev)
    cw1 = (torch.randn(3, 3, 3, 16, generator=g) * math.sqrt(2.0 / 27)).to(dev)
    cw2 = (torch.randn(3, 3, 16, 32, generator=g) * math.sqrt(2.0 / 144)).to(dev)
    cb1 = (torch.randn(16, generator=g) * 0.05).to(dev)
    cb2 = (torch.randn(32, generator=g) * 0.05).to(dev)
    pool = dict(padding="same", pool_window=(2, 2), activation="relu")

    def cycled(fn):
        state = {"i": 0}

        def call():
            state["i"] = (state["i"] + 1) % len(xs)
            return fn(xs[state["i"]])
        return call

    calls = {
        "fused_dense 8192x784->128 relu": cycled(
            lambda x: fused_dense(x, mnist[0]["w"], mnist[0]["b"], activation="relu")),
        "fcnn_fused_forward 784-128-64-10 x8192": cycled(lambda x: fcnn_fused_forward(mnist, x)),
        "fcnn_fused_forward 2048-64-10 x1024": lambda: fcnn_fused_forward(tail, x_tail),
        "fcnn_quantized_forward 784-128-64-10 x8192": cycled(
            lambda x: fcnn_quantized_forward(q, x)),
        "fused_conv2d conv1+pool x1024": lambda: fused_conv2d(img1, cw1, cb1, **pool),
        "fused_conv2d conv2+pool x1024": lambda: fused_conv2d(img2, cw2, cb2, **pool),
    }
    out = {"card": smi.strip(), "root": str(Path(args.root).resolve()), "ms": {}}
    for name, fn in calls.items():
        loop = [cuda_time_ms(fn) for _ in range(args.repeat)]
        graph = [cuda_graph_time_ms(fn) for _ in range(args.repeat)]
        out["ms"][name] = {"loop": statistics.median(loop), "graph": statistics.median(graph)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
