#!/usr/bin/env python3
"""What bounds the port's conv kernel: it timed beside variants of itself.

Run from the root of a checkout on a machine with one NVIDIA GPU and
``nvcc``::

    python3 tools/torch_conv_variants.py

Builds ``tpu_dist_nn_torch/kernels/csrc/conv2d.cu`` as it is and with one
change each (text substitutions; the variants compute wrong values on
purpose and only time), into a temporary directory, and times each at
the CIFAR conv+MLP network's two stages (batch 1024, 3x3 SAME, relu,
2x2 pool) with CUDA events over 50 launches on 5 rotating inputs:

* ``kernel``: the source as it is;
* ``fma/16``: only one channel's FMA of the 16 a thread keeps (the loads,
  the gather and the epilogue as they are);
* ``no-weight-loads``: constant weights instead of the shared-memory
  reads (the FMAs as they are);
* ``no-gather``: the patch's cp.async gather skipped;
* ``8x16-tile``: 8 pixels x 16 channels a thread, one CTA an SM (every
  float read from shared memory then feeds 8 FMAs, not 3.2).

Prints ptxas' register and spill lines and one line per variant and
stage. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

FMA = "for (int jj = 0; jj < kChan; ++jj) acc[p][jj] = fmaf(av[p], wv[jj], acc[p][jj]);"
WEIGHTS = """            const float4 t = reinterpret_cast<const float4*>(wp + ci * nct)[q];
            wv[4 * q] = t.x;
            wv[4 * q + 1] = t.y;
            wv[4 * q + 2] = t.z;
            wv[4 * q + 3] = t.w;"""
GATHER = "      cp_async4(dst + ci, ok ? src + ci : x, ok);"
STAGES = (((1024, 32, 32, 3), (3, 3, 3, 16)), ((1024, 16, 16, 16), (3, 3, 16, 32)))


def variants(src: str) -> dict[str, tuple[str, int]]:
    """name -> (source, conv pixels a thread computes)."""
    for piece in (FMA, WEIGHTS, GATHER):
        if piece not in src:
            raise SystemExit(f"csrc/conv2d.cu no longer holds: {piece.strip()[:60]}")
    return {
        "kernel": (src, 4),
        "fma/16": (src.replace(FMA, "acc[p][0] = fmaf(av[p], wv[0], acc[p][0]);"), 4),
        "no-weight-loads": (src.replace(WEIGHTS, """            wv[4 * q] = 1.0f + q;
            wv[4 * q + 1] = 2.0f + q;
            wv[4 * q + 2] = 3.0f + q;
            wv[4 * q + 3] = 4.0f + q;"""), 4),
        "no-gather": (src.replace(GATHER, "      (void)ok;"), 4),
        "8x16-tile": (src.replace("constexpr int kPix = 4;", "constexpr int kPix = 8;")
                      .replace("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)"),
                      8),
    }


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_conv_variants: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from tpu_dist_nn_torch.kernels import _build
    from tpu_dist_nn_torch.kernels import conv2d as conv

    src = (_build.CSRC / "conv2d.cu").read_text()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="conv_variants_") as tmp:
        built, procs = {}, {}
        for name, (text, pix) in variants(src).items():
            cu = Path(tmp) / f"{len(procs)}.cu"
            cu.write_text(text)
            so = cu.with_suffix(".so")
            procs[name] = (pix, so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                 str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (pix, so, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"nvcc {name}:\n{log[-3000:]}")
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.split('ptxas info    :')[-1].strip()}")
            fn = ctypes.CDLL(str(so)).tdn_conv2d
            fn.argtypes = (ctypes.c_void_p,) * 4 + (ctypes.POINTER(ctypes.c_int), ctypes.c_void_p)
            fn.restype = ctypes.c_int
            built[name] = (pix, fn)

        rng = np.random.default_rng(0)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for shape, w_shape in STAGES:
            ins = [torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(dev)
                   for _ in range(5)]
            w = torch.from_numpy(rng.normal(0, 0.1, w_shape).astype(np.float32)).to(dev)
            b = torch.zeros(w_shape[3], device=dev)
            for name, (pix, fn) in built.items():
                # The planner for this variant's pixels a thread.
                conv._conv_plan.cache_clear()
                conv.PIX_PER_THREAD, conv._CTA_PIXELS = pix, 8 * 32 * pix
                plan = conv.conv_plan(shape, w_shape, (1, 1), "same", (2, 2), None, "relu")
                args = conv.conv_args(plan, shape, w_shape, (1, 1), "relu")
                argv = (ctypes.c_int * len(args))(*args)
                out = torch.empty(plan.out_shape, device=dev)

                def launch(i):
                    code = fn(ins[i % 5].data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                              argv, stream)
                    if code != 0:
                        raise SystemExit(f"{name}: launch returned CUDA error {code}")

                for i in range(5):
                    launch(i)
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                for i in range(50):
                    launch(i)
                stop.record()
                stop.synchronize()
                print(f"conv variant {name:16s} {shape} x {w_shape}: "
                      f"{start.elapsed_time(stop) / 50:.4f} ms a launch "
                      f"({plan.grid[0]} CTAs, {plan.smem_bytes} B shared memory)")
        conv._conv_plan.cache_clear()
        conv.PIX_PER_THREAD, conv._CTA_PIXELS = 4, 8 * 32 * 4


if __name__ == "__main__":
    main()
