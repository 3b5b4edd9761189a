#!/usr/bin/env python3
"""Time of the flash backward kernels on one GPU.

Times ``flash_bwd_sm90`` (bf16) and ``flash_bwd_f32`` (float32) of the
port at the 85M LM's shape (B 16, H 12, T 1024, Dh 64, causal; CUDA
events, 3 rotating inputs) and the float32 one at the recipe's shape
(B 16, H 4, T 128, Dh 32) in a CUDA graph of 50 calls. One JSON line a
time, then a summary line.

    python3 tools/torch_flash_bwd_order.py [--root CHECKOUT]

``--root`` imports ``tpu_dist_nn_torch`` from another checkout (the
parent commit, say), so two versions can be timed in one machine call.
Their repeatability (two calls bit-equal) and their agreement with the
plain versions are checked by ``chip_smoke.py``'s kernel phase, not
here.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

SHAPE_85M = (16, 1024, 12, 64)
SHAPE_RECIPE = (16, 128, 4, 32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="checkout whose tpu_dist_nn_torch is imported")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import importlib

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    fa = importlib.import_module("tpu_dist_nn_torch.kernels.flash_attention")
    from tpu_dist_nn_torch.utils.profiling import cuda_graph_time_ms, cuda_time_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = smi.strip().splitlines()[0] if smi.strip() else "unknown"
    dev = torch.device("cuda", 0)

    def inputs(shape, dtype, seed):
        B, T, H, Dh = shape
        g = torch.Generator(device="cpu").manual_seed(seed)
        qkv = torch.randn((B, T, 3 * H, Dh), generator=g).to(dev, dtype)
        do = torch.randn((B, T, H, Dh), generator=g).to(dev, dtype)
        q, k, v = qkv.split(H, dim=2)
        scale = 1.0 / math.sqrt(Dh)
        qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
        return q, k, v, do, qf, kf, vf, dof, scale

    def lse_delta(qf, kf, vf, dof, scale, causal):
        o, lse = fa.flash_fwd_plain(qf, kf, vf, scale=scale, causal=causal)
        return lse, (dof * o).sum(-1).transpose(1, 2).contiguous()

    kernels = {"sm90": (fa.flash_bwd_sm90, torch.bfloat16),
               "f32": (fa.flash_bwd_f32, torch.float32)}

    def emit(rec):
        print(json.dumps(rec), flush=True)

    # Times at the 85M shape (3 rotating inputs) and the recipe's.
    for route, (kern, dtype) in kernels.items():
        sets = []
        for seed in range(3):
            q, k, v, do, qf, kf, vf, dof, scale = inputs(SHAPE_85M, dtype, 200 + seed)
            lse, delta = lse_delta(qf, kf, vf, dof, scale, True)
            sets.append((q, k, v, do, lse, delta))
            del qf, kf, vf, dof
        turn = iter(range(1 << 30))
        ms = cuda_time_ms(lambda: kern(*sets[next(turn) % 3], causal=True))
        emit({"time": f"flash_bwd_{route}", "shape": SHAPE_85M, "ms": ms, "card": card})
        del sets
        torch.cuda.empty_cache()
    q, k, v, do, qf, kf, vf, dof, scale = inputs(SHAPE_RECIPE, torch.float32, 300)
    lse, delta = lse_delta(qf, kf, vf, dof, scale, True)
    graph_ms = cuda_graph_time_ms(lambda: fa.flash_bwd_f32(q, k, v, do, lse, delta, causal=True))
    emit({"time": "flash_bwd_f32", "shape": SHAPE_RECIPE, "graph_of_50_ms": graph_ms,
          "card": card})
    emit({"root": str(Path(args.root).resolve()), "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
