#!/usr/bin/env python3
"""Where a training step of the PyTorch port's LM spends device time.

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 tools/torch_lm_profile.py [--layers 12] [--warmup 5] [--steps 3]
        [--experts 8 --router-top-k 2]

Builds the 85M recipe of ``chip_smoke.py``'s LM path (d 768, 12 heads,
``--layers`` layers, T 1024, batch 16, bf16 over float32 masters, remat,
Adam at 3e-4) on random weights and corpus batches, runs ``--warmup``
steps through ``make_lm_train_step`` (``--experts E``: the single MoE
program, capacity 1.25, through ``make_moe_lm_train_step``), then
``--steps`` more under
``torch.profiler`` (CPU and CUDA activities). Prints each kernel's device
time per step, the sums by group (each flash kernel: the bf16 path's
sm90 forward and fused backward, or the float32 path's f32 pair; matrix products;
everything else), the steps' wall time and the share of it in
which the device ran no kernel. Exits 1 when the profiler recorded no
device time. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


FLASH_KERNELS = ("flash_fwd_sm90", "flash_bwd_sm90", "flash_fwd_f32", "flash_bwd_f32")


def group_of(name: str) -> str:
    """A kernel's group: each flash kernel by its own name (the bf16
    sm90 pair, or the float32 f32 pair), then the matrix products, then
    everything else."""
    for key in FLASH_KERNELS:
        if f"{key}_kernel" in name:
            return key
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "matmul")):
        return "matrix products (cuBLAS)"
    return "other (elementwise, reductions, copies, optimizer)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--experts", type=int, default=0)
    ap.add_argument("--router-top-k", type=int, default=1, choices=[1, 2])
    args = ap.parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_lm_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tpu_dist_nn_torch.data.text import encode, lm_batches, lm_sequences, load_corpus
    from tpu_dist_nn_torch.models.transformer import (
        TransformerConfig,
        init_transformer,
        param_leaves,
        tree_map,
    )
    from tpu_dist_nn_torch.parallel import expert_parallel as ep
    from tpu_dist_nn_torch.train.lm_trainer import make_lm_train_step, make_moe_lm_train_step
    from tpu_dist_nn_torch.train.optimizers import build_optimizer

    dev = torch.device("cuda")
    shape = dict(vocab_size=256, d_model=768, n_heads=12, n_layers=args.layers, d_ff=3072,
                 max_seq_len=1024, compute_dtype="bfloat16", remat=True)
    if args.experts:
        cfg = ep.MoEConfig(**shape, n_experts=args.experts, router_top_k=args.router_top_k)
        init = ep.init_moe_transformer
    else:
        cfg, init = TransformerConfig(**shape), init_transformer
    rows = lm_sequences(encode(load_corpus()[0]), 1024)
    stream = lm_batches(rows, 16, seed=0, epochs=None)
    params = tree_map(lambda a: a.requires_grad_(True),
                      init(torch.Generator().manual_seed(0), cfg, device=dev))
    opt = build_optimizer(3e-4)
    state = opt.init(param_leaves(params))
    step = make_moe_lm_train_step(cfg, opt) if args.experts else make_lm_train_step(cfg, opt)

    def run(n):
        for _ in range(n):
            tokens = torch.from_numpy(next(stream)).to(dev)
            _, _, loss = step(params, state, tokens)
            float(loss)

    run(args.warmup)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(args.steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    per_step = {e.key: e.self_device_time_total / 1e3 / args.steps for e in kernels}
    busy = sum(per_step.values())
    name = torch.cuda.get_device_name(0)
    print(f"device {name}; torch {torch.__version__}; {args.layers} layers"
          f"{f', {args.experts} experts, top-{args.router_top_k}' if args.experts else ''}; "
          f"{args.steps} profiled steps after {args.warmup}")
    if busy <= 0:
        print("torch_lm_profile: the profiler recorded no device time", file=sys.stderr)
        return 1
    groups: dict[str, float] = {}
    for key, ms in per_step.items():
        groups[group_of(key)] = groups.get(group_of(key), 0.0) + ms
    print(f"wall {wall_ms:.3f} ms/step (host clock, profiler on); kernels {busy:.3f} ms/step; "
          f"device idle {100 * (1 - busy / wall_ms):.1f}% of the wall time")
    counts = {e.key: e.count / args.steps for e in kernels}
    launches: dict[str, float] = {}
    for key, n in counts.items():
        launches[group_of(key)] = launches.get(group_of(key), 0.0) + n
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms/step  {100 * ms / busy:5.1f}% of kernel time  "
              f"{launches[group]:7.1f} launches/step  {group}")
    print("top kernels (ms/step, launches/step):")
    for key, ms in sorted(per_step.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms:9.3f}  {counts[key]:6.1f}  {key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
