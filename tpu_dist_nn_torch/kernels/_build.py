"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes`; a library
exports one launch function per kernel (each flash-attention library
two). Tensors
cross as ``data_ptr()`` integers and PyTorch's current stream as its
``cuda_stream`` handle. No source includes PyTorch's headers, so a
cold build takes seconds rather than the minutes a
``torch.utils.cpp_extension`` build of ``torch/extension.h`` takes.

The build happens at first use, never at import: one ``nvcc`` process
per source, all started together. Libraries land in ``kernels/build/``
(listed in ``.gitignore``) under a name that hashes the sources and
flags, so an unchanged checkout reuses them and a changed source
rebuilds. Flags: ``sm_90a`` (Hopper), ``-O3``, and no
``--use_fast_math`` — the int8 chain's quantisation divides and rounds
and must match its plain version bit for bit, and attention's softmax
uses ``expf`` / ``logf`` as its plain version does. The sm90
flash-attention library builds its TMA tensor maps on the host with
``cuTensorMapEncodeTiled``, which it looks up through the CUDA runtime
at first use, so no library links ``-lcuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from tpu_dist_nn_torch.utils.errors import InternalError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)

_F = ctypes.c_float
_PL = ctypes.POINTER(ctypes.c_longlong)

# library name -> {exported launch function: its ctypes argtypes}
LIBRARIES = {
    "fused_dense": {"tdn_fused_dense": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)},
    "fcnn_chain": {
        "tdn_fcnn_chain": (_P, _I, _F, _P, _I, _PP, _PP, _PI, _PI, _I, _I, _I, _I, _I, _P),
        "tdn_fcnn_chain_max_clusters": (_I, _I, _I, _PI),
    },
    "int8_chain": {
        "tdn_int8_chain": (_P, _P, _I, _PP, _PP, _PP, _PI, _PI, _I, _I, _I, _I, _I, _I, _P),
    },
    "conv2d": {"tdn_conv2d": (_P, _P, _P, _P, _PI, _P)},
    "flash_attention_f32": {
        "tdn_flash_fwd_f32": (_P, _P, _P, _P, _P, _PI, _F, _P),
        "tdn_flash_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _PI, _F, _P),
    },
    "flash_attention_sm90": {
        "tdn_flash_fwd_sm90": (_P, _P, _P, _P, _P, _PL, _F, _P),
        "tdn_flash_bwd_sm90": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _PL, _F, _P),
    },
}

_lock = threading.Lock()
_launchers: dict = {}
_error_string = None

#: Wall seconds of this process's kernel build (0.0 when every library
#: was already built), None before the first use.
build_seconds: float | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise InternalError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from kernels/csrc at first use"
    )


def library_path(name: str) -> Path:
    """Where library ``name`` is built: keyed by its source, the shared
    headers and the flags."""
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every library not yet built, one ``nvcc`` per source, all
    in parallel; returns the wall seconds spent. Raises
    :class:`InternalError` with the compiler's output on a failure."""
    todo = [(n, library_path(n)) for n in LIBRARIES if not library_path(n).is_file()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    procs = []
    for name, so in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log[-4000:]}")
        else:
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise InternalError("kernel build failed:\n" + "\n".join(failures))
    return time.monotonic() - t0


def launcher(name: str, fn: str | None = None):
    """The C launch function ``fn`` of library ``name`` (by default its
    only one), building and loading every library on first use."""
    global build_seconds, _error_string
    with _lock:
        if not _launchers:
            seconds = build_all()
            for lib_name, functions in LIBRARIES.items():
                lib = ctypes.CDLL(str(library_path(lib_name)))
                for fn_name, argtypes in functions.items():
                    c_fn = getattr(lib, fn_name)
                    c_fn.argtypes = argtypes
                    c_fn.restype = ctypes.c_int
                    _launchers[lib_name, fn_name] = c_fn
                if _error_string is None:
                    _error_string = lib.tdn_error_string
                    _error_string.argtypes = (ctypes.c_int,)
                    _error_string.restype = ctypes.c_char_p
            build_seconds = seconds
        if fn is None:
            (fn,) = LIBRARIES[name]
        return _launchers[name, fn]


def check(code: int, what: str) -> None:
    """Raise :class:`InternalError` for a nonzero cudaError_t code
    returned by a launch function."""
    if code != 0:
        text = _error_string(code).decode() if _error_string is not None else "?"
        raise InternalError(f"{what}: CUDA error {code} ({text})")
