#!/usr/bin/env python3
"""Where a training step of the PyTorch port's FCNN trainer spends its time.

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 tools/torch_train_profile.py [--batch-size 64] [--warmup 50] [--steps 200]

Builds ``chip_smoke.py``'s full-width training recipe (784-128-64-10,
relu / relu / softmax, Adam at 1e-3, seeded weights, ``synthetic_mnist``
rows) and runs ``--warmup`` steps of
``tpu_dist_nn_torch.train.trainer.make_train_step`` with the trainer's
per-step host-to-device copies, then ``--steps`` more timed on the host
clock (ending in a synchronise), then ``--steps`` more under
``torch.profiler`` (CPU and CUDA activities). Prints the step's wall
time with the profiler off and on, the device time per step by group
(matrix products, copies, everything else), the launches per step, and
the share of the profiled wall time in which the device ran nothing.
Exits 1 when the profiler recorded no device time. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def group_of(name: str) -> str:
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "matmul", "gemv")):
        return "matrix products (cuBLAS)"
    return "other (elementwise, reductions, loss, optimizer)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_train_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tpu_dist_nn_torch.data.datasets import synthetic_mnist
    from tpu_dist_nn_torch.data.feed import batch_iterator
    from tpu_dist_nn_torch.models.fcnn import init_fcnn
    from tpu_dist_nn_torch.train.trainer import (
        TrainConfig,
        _leaves,
        _split_params,
        make_train_step,
        optimizer_for,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    acts = ["relu", "relu", "softmax"]
    data = synthetic_mnist(args.batch_size * (args.warmup + 2 * args.steps), seed=0)
    params = init_fcnn(torch.Generator().manual_seed(0), [784, 128, 64, 10], acts, device=dev)
    wb, ids = _split_params(params)
    opt = optimizer_for(TrainConfig(batch_size=args.batch_size), data)
    state = opt.init(_leaves(wb))
    step = make_train_step(ids, opt)
    batches = batch_iterator(data.x, data.y, args.batch_size, shuffle=True, seed=0,
                             drop_remainder=True)

    def run(n):
        for _ in range(n):
            bx, by = next(batches)
            x = torch.as_tensor(bx, dtype=torch.float32, device=dev)
            y = torch.as_tensor(by, dtype=torch.long, device=dev)
            step(wb, state, x, y)
        torch.cuda.synchronize()

    run(args.warmup)
    t0 = time.perf_counter()
    run(args.steps)
    plain_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(args.steps)
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    per_step = {e.key: e.self_device_time_total / 1e3 / args.steps for e in events}
    counts = {e.key: e.count / args.steps for e in events}
    busy = sum(per_step.values())
    print(f"device {torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"784-128-64-10 at batch {args.batch_size}; {args.steps} steps timed after "
          f"{args.warmup}, {args.steps} more profiled")
    if busy <= 0:
        print("torch_train_profile: the profiler recorded no device time", file=sys.stderr)
        return 1
    print(f"wall {plain_ms:.4f} ms/step (host clock, profiler off; "
          f"{args.batch_size / plain_ms * 1e3:.1f} samples/s), {wall_ms:.4f} ms/step "
          f"profiler on; device busy {busy:.4f} ms/step; device idle "
          f"{100 * (1 - busy / wall_ms):.1f}% of the profiled wall time; "
          f"{sum(counts.values()):.1f} device operations/step")
    groups: dict[str, list[float]] = {}
    for key, ms in per_step.items():
        g = groups.setdefault(group_of(key), [0.0, 0.0])
        g[0] += ms
        g[1] += counts[key]
    for group, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.4f} ms/step  {100 * ms / busy:5.1f}% of device time  "
              f"{n:6.1f} operations/step  {group}")
    print("top device operations (ms/step, count/step):")
    for key, ms in sorted(per_step.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:9.4f}  {counts[key]:6.1f}  {key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
