#!/usr/bin/env python3
"""What bounds the port's float32 flash kernels: each timed beside
variants of itself.

Run from the root of a checkout on a machine with one NVIDIA GPU and
``nvcc``::

    python3 tools/torch_flash_f32_variants.py

Builds ``tpu_dist_nn_torch/kernels/csrc/flash_attention_f32.cu`` as it
is and with one change each (text substitutions, into a temporary
directory; ``no-split``, ``1xTF32`` and ``no-exp`` compute wrong values
on purpose and only time), and times the forward and the fused
backward at the 85M LM's shape (B 16, H 12, T 1024, Dh 64, causal,
float32) with CUDA events over 20 launches on 2 rotating input sets
(2 x 201 MB, more than the 50 MB L2), beside SDPA float32 (TF32 off) in
the same run:

* ``kernel``: the source as it is;
* ``cvt-rna``: the TF32 rounding by ``cvt.rna.tf32.f32`` instead of the
  integer add and mask (bit for bit the same, checked here);
* ``no-split``: the operands' raw bits as both halves (no rounding, no
  subtraction): what the 3xTF32 split costs;
* ``1xTF32``: one product per fragment instead of three: what the
  tensor-core work costs;
* ``no-exp``: ``exp2f`` replaced by ``fabsf``: what the exponentials cost;
* ``fwd-64-rows`` / ``fwd-64-keys``: forward CTAs of 64 query rows (16 a
  warp) / K and V tiles of 64 keys;
* ``bwd-16-rows`` / ``bwd-64-rows``: backward Q/dO tiles of 16 / 64 rows;
* ``bwd-1-chain``: one accumulator set for the backward's S^T, dP^T and
  dQ instead of two (k-steps alternating between them).

Prints ptxas' register and spill lines and one line per variant and
kernel. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

INT_RNA = "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;"
CVT_RNA = """  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));
  return r;"""
SPLIT = """  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));"""
MMA3 = """  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);"""
FWD_ROWS = "fwd_rows(int D) { return D == 128 ? 64 : 128; }"
FWD_KEYS = "fwd_keys(int) { return 32; }"
BWD_ROWS = "bwd_rows(int D) { return D == 32 ? 64 : D == 64 ? 32 : 16; }"
CHAINS = "constexpr int kChains = 2;"
SHAPE = (16, 1024, 12, 64)


def variants(src: str) -> dict[str, tuple[str, tuple[int, int], tuple[int, int]]]:
    """name -> (source, forward (rows, keys), backward (keys, rows)) at Dh 64."""
    for piece in (INT_RNA, SPLIT, MMA3, FWD_ROWS, FWD_KEYS, BWD_ROWS, CHAINS, "exp2f("):
        if piece not in src:
            raise SystemExit(f"csrc/flash_attention_f32.cu no longer holds: {piece.strip()[:60]}")
    fwd, bwd = (128, 32), (64, 32)
    return {
        "kernel": (src, fwd, bwd),
        "cvt-rna": (src.replace(INT_RNA, CVT_RNA), fwd, bwd),
        "no-split": (src.replace(SPLIT, "  hi = lo = __float_as_uint(x);"), fwd, bwd),
        "1xTF32": (src.replace(MMA3, "  mma(d, a.hi, b.hi);"), fwd, bwd),
        "no-exp": (src.replace("exp2f(", "fabsf("), fwd, bwd),
        "fwd-64-rows": (src.replace(FWD_ROWS, "fwd_rows(int) { return 64; }"), (64, 32), bwd),
        "fwd-64-keys": (src.replace(FWD_KEYS, "fwd_keys(int) { return 64; }"), (128, 64), bwd),
        "bwd-16-rows": (src.replace(BWD_ROWS, "bwd_rows(int) { return 16; }"), fwd, (64, 16)),
        "bwd-64-rows": (src.replace(BWD_ROWS, "bwd_rows(int) { return 64; }"), fwd, (64, 64)),
        "bwd-1-chain": (src.replace(CHAINS, "constexpr int kChains = 1;"), fwd, bwd),
    }


def main() -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_f32_variants: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    from tpu_dist_nn_torch.kernels import _build
    from tpu_dist_nn_torch.kernels.flash_attention import _f32_params, flash_fwd_plain

    src = (_build.CSRC / "flash_attention_f32.cu").read_text()
    dev = torch.device("cuda")
    P, F_ = ctypes.c_void_p, ctypes.c_float
    PI = ctypes.POINTER(ctypes.c_int)
    with tempfile.TemporaryDirectory(prefix="flash_f32_variants_") as tmp:
        built, procs = {}, {}
        for name, (text, ftiles, btiles) in variants(src).items():
            cu = Path(tmp) / f"{len(procs)}.cu"
            cu.write_text(text)
            so = cu.with_suffix(".so")
            procs[name] = (ftiles, btiles, so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                 str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (ftiles, btiles, so, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"nvcc {name}:\n{log[-3000:]}")
            for line in log.splitlines():
                if "registers" in line or "Compiling entry" in line:
                    print(f"ptxas {name}: {line.split('ptxas info    :')[-1].strip()[:160]}")
            lib = ctypes.CDLL(str(so))
            fwd, bwd = lib.tdn_flash_fwd_f32, lib.tdn_flash_bwd_f32
            fwd.argtypes = (P, P, P, P, P, PI, F_, P)
            bwd.argtypes = (P, P, P, P, P, P, P, P, P, PI, F_, P)
            fwd.restype = bwd.restype = ctypes.c_int
            built[name] = (ftiles, btiles, fwd, bwd)

        B, T, H, Dh = SHAPE
        rng = np.random.default_rng(0)
        scale = 1.0 / math.sqrt(Dh)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        sets = []
        for _ in range(2):
            qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * H, Dh)).astype(np.float32))
            q, k, v = qkv.to(dev).split(H, dim=2)
            do = torch.from_numpy(rng.standard_normal((B, T, H, Dh)).astype(np.float32)).to(dev)
            o, lse = flash_fwd_plain(q, k, v, scale=scale, causal=True)
            delta = (do * o).sum(-1).transpose(1, 2).contiguous()
            sets.append((q, k, v, do, lse, delta))
        o = torch.empty(B, T, H, Dh, device=dev)
        lse_out = torch.empty(B, H, T, device=dev)
        dq, dk, dv = (torch.zeros(B, T, H, Dh, device=dev) for _ in range(3))

        def timed(launch):
            for i in range(3):
                launch(i)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            for i in range(20):
                launch(i)
            stop.record()
            stop.synchronize()
            return start.elapsed_time(stop) / 20

        ref = None
        for name, (ftiles, btiles, fwd, bwd) in built.items():
            q, k, v = sets[0][:3]
            pf = list(_f32_params(q, k, v, T, True, backward=False))
            pb = list(_f32_params(q, k, v, T, True, backward=True))
            pf[-2:], pb[-2:] = ftiles, btiles
            pf, pb = (ctypes.c_int * len(pf))(*pf), (ctypes.c_int * len(pb))(*pb)

            def launch_fwd(i):
                q, k, v = sets[i % 2][:3]
                code = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                           lse_out.data_ptr(), pf, scale, stream)
                if code:
                    raise SystemExit(f"{name}: forward launch returned CUDA error {code}")

            def launch_bwd(i):
                q, k, v, do, lse, delta = sets[i % 2]
                dq.zero_()
                code = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                           dv.data_ptr(), pb, scale, stream)
                if code:
                    raise SystemExit(f"{name}: backward launch returned CUDA error {code}")

            launch_fwd(0)
            torch.cuda.synchronize()
            if name == "kernel":
                ref = o.clone()
            same = "bit-equal to kernel" if torch.equal(o, ref) else "differs from kernel"
            f_ms, b_ms = timed(launch_fwd), timed(launch_bwd)
            print(f"flash_f32 variant {name:12s}: forward {f_ms:.4f} ms ({ftiles[0]} rows x "
                  f"{ftiles[1]}-key tiles), backward {b_ms:.4f} ms incl. zeroing dq ({btiles[0]} "
                  f"keys x {btiles[1]}-row tiles); forward output {same}")

        lib_in = [t.transpose(1, 2).detach().requires_grad_(True) for t in sets[0][:3]]
        lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True)
        g = sets[0][3].transpose(1, 2)
        f_ms = timed(lambda i: F.scaled_dot_product_attention(*lib_in, is_causal=True))
        b_ms = timed(lambda i: torch.autograd.grad(lib_out, lib_in, g, retain_graph=True))
        print(f"SDPA float32 (TF32 off), same shape: forward {f_ms:.4f} ms, backward {b_ms:.4f} ms")


if __name__ == "__main__":
    main()
