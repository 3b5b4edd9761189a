"""Silent-corruption defense: fingerprints, the numeric guard, canary
inputs.

Port of the serving-local half of :mod:`tpu_dist_nn.serving.integrity`
(the replica probes, ``CanaryProber`` and ``SpotChecker``, ride the
fleet's replica pool and come with it):

* **Fingerprints** — :func:`array_checksum` is a SHA-256 over an array's
  dtype, shape and C-contiguous bytes; :func:`fingerprint_tree` folds a
  tree's per-array checksums (keyed by their ``jax.tree_util.keystr``
  paths, ``['blocks']['w_qkv']``) into one whole-model digest, equal to
  the JAX package's on the same arrays; :func:`verify_tree` lists the
  mismatches against a saved fingerprint. Torch tensors hash as the
  numpy array of the same dtype (bfloat16 by its raw 16-bit words,
  under the name ``bfloat16`` that ``ml_dtypes`` gives it).
* **The numeric guard** (:class:`NumericGuard`, the process-wide
  :data:`GUARD`) — a per-row ``isfinite`` + magnitude screen at the
  launch boundaries: ``Engine.fetch`` (one vectorized pass over the
  host array it has just copied back) and the continuous scheduler's
  decode step (an in-graph ``isfinite`` over the logits riding the
  step's one device-to-host copy). Affected rows fail with
  :class:`~tpu_dist_nn_torch.utils.errors.IntegrityError` (wire:
  ``DATA_LOSS``); the rest of the launch ships untouched.
  ``TDN_INTEGRITY_GUARD=0`` at import, or ``GUARD.enabled = False``,
  disarms it.
* **Canary inputs** — the fixed seeded ``Process`` rows and ``Generate``
  prompts every prober of a fleet sends, and :func:`reply_digest` of a
  raw reply.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from tpu_dist_nn_torch.obs.registry import REGISTRY

# One fixed seed for every canary input in a fleet: every replica of the
# same weights must compute the SAME answer, so the input is a constant.
CANARY_SEED = 0x7DD

GUARD_ROWS_FAILED = REGISTRY.counter(
    "tdn_integrity_guard_rows_total",
    "rows failed by the numeric guard (non-finite or out-of-magnitude "
    "activations caught at the launch boundary)",
)
GUARD_LAUNCHES = REGISTRY.counter(
    "tdn_integrity_guard_launches_total",
    "device launches in which the numeric guard failed at least one row",
)


# --------------------------------------------------------- fingerprints


def _host_array(a) -> tuple[str, tuple, bytes]:
    """(dtype name, shape, C-contiguous bytes) of a numpy array or a
    torch tensor (any device)."""
    if hasattr(a, "detach") and hasattr(a, "cpu"):  # a torch tensor
        import torch

        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(t.shape), t.view(torch.int16).numpy().tobytes()
        a = t.numpy()
    a = np.asarray(a)
    return str(a.dtype), tuple(a.shape), np.ascontiguousarray(a).tobytes()


def array_checksum(a) -> str:
    """SHA-256 over an array's dtype + shape + raw bytes: equal for
    equal values across processes and hosts, and an f32/f64 confusion
    cannot collide."""
    dtype, shape, raw = _host_array(a)
    h = hashlib.sha256()
    h.update(dtype.encode())
    h.update(repr(shape).encode())
    h.update(raw)
    return h.hexdigest()


def _is_array(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _named_leaves(tree, path: str = "") -> list[tuple[str, object]]:
    """(path, leaf) pairs for every array leaf of a tree of dicts, lists
    and tuples, in ``jax.tree_util`` order (dict keys sorted) under its
    ``keystr`` names. A flat ``{name: array}`` dict keeps its plain
    names, as the JAX package's short-cut does."""
    if not path and isinstance(tree, dict) and all(_is_array(v) for v in tree.values()):
        return sorted(tree.items())
    if _is_array(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _named_leaves(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _named_leaves(v, f"{path}[{i}]")]
    return []  # None, ints and other non-array leaves carry no bytes


def fingerprint_tree(tree) -> dict:
    """Per-array checksums plus the whole-model fingerprint:
    ``{"model": sha, "arrays": {path: sha}, "count": n}``. The model
    digest hashes the sorted ``path=checksum`` lines, so it pins every
    array's bytes AND the tree's structure."""
    arrays = {path: array_checksum(leaf) for path, leaf in _named_leaves(tree)}
    h = hashlib.sha256()
    for path in sorted(arrays):
        h.update(f"{path}={arrays[path]}\n".encode())
    return {"model": h.hexdigest(), "arrays": arrays, "count": len(arrays)}


def verify_tree(tree, expected: dict) -> list[str]:
    """Check a tree against a saved fingerprint: readable mismatch lines
    (empty = verified). Missing and extra arrays are reported beside
    value drift: a truncated restore is as corrupt as a flipped bit."""
    got = fingerprint_tree(tree)
    exp_arrays = dict(expected.get("arrays") or {})
    mismatches = []
    for path, sha in sorted(got["arrays"].items()):
        want = exp_arrays.pop(path, None)
        if want is None:
            mismatches.append(f"{path}: not in saved fingerprint")
        elif want != sha:
            mismatches.append(f"{path}: checksum {sha[:12]}… != saved {want[:12]}…")
    for path in sorted(exp_arrays):
        mismatches.append(f"{path}: missing from restored state")
    want_model = expected.get("model")
    if not mismatches and want_model and want_model != got["model"]:
        mismatches.append(
            f"model fingerprint {got['model'][:12]}… != saved {want_model[:12]}…"
        )
    return mismatches


# ------------------------------------------------------- numeric guard


class NumericGuard:
    """Per-row corruption screen at a launch boundary.

    ``bad_rows(out)`` reduces a float host batch to an ``(N,)`` bool
    mask of rows carrying non-finite values or magnitudes past
    ``abs_limit``: one vectorized pass over memory the caller has just
    copied back. Callers fail exactly the masked rows with
    IntegrityError and ship the rest untouched."""

    def __init__(self, enabled: bool | None = None, abs_limit: float = 1e8):
        if enabled is None:
            enabled = os.environ.get("TDN_INTEGRITY_GUARD", "1") != "0"
        self.enabled = bool(enabled)
        self.abs_limit = float(abs_limit)

    def bad_rows(self, out) -> np.ndarray | None:
        """``(N,)`` bool mask of corrupt rows; None when the guard is
        disarmed or the output is not a float batch (token ids are
        screened in the decode step instead)."""
        if not self.enabled:
            return None
        out = np.asarray(out)
        if out.dtype.kind != "f" or out.ndim == 0 or out.size == 0:
            return None
        axes = tuple(range(1, out.ndim))
        finite = np.isfinite(out)
        if finite.all() and not (self.abs_limit
                                 and max(out.max(), -out.min()) > self.abs_limit):
            # A clean batch, the common case: whole-array reductions cost
            # a tenth of the per-row ones below over a narrow row.
            return np.zeros(out.shape[0], dtype=bool)
        ok = finite.all(axis=axes) if axes else finite
        if self.abs_limit:
            # where() masks the non-finite entries first: they are caught
            # above, and abs(nan) comparisons would warn.
            bounded = np.abs(np.where(finite, out, 0.0)) <= self.abs_limit
            ok = ok & (bounded.all(axis=axes) if axes else bounded)
        bad = ~ok
        if bad.any():
            GUARD_ROWS_FAILED.inc(int(bad.sum()))
            GUARD_LAUNCHES.inc()
        return bad


# The process-wide guard: the serving batcher, the Engine, the continuous
# scheduler and the guard-cost measurement all arm or disarm THIS object.
GUARD = NumericGuard()


# ------------------------------------------------------- canary inputs


def canary_rows(dim: int, rows: int = 2, seed: int = CANARY_SEED) -> np.ndarray:
    """The fixed seeded Process canary input: the same (rows, dim) batch
    on every prober of a fleet."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (int(rows), int(dim)))


def canary_prompts(prompt_len: int, vocab_size: int, rows: int = 1,
                   seed: int = CANARY_SEED) -> np.ndarray:
    """The fixed seeded Generate canary prompt(s): token ids ride the
    Matrix wire as exact doubles."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, int(vocab_size), (int(rows), int(prompt_len))).astype(np.float64)


def reply_digest(reply_bytes: bytes) -> str:
    """Digest of a raw wire reply. The encoder is deterministic and the
    greedy serving path bit-identical, so equal answers give equal
    bytes: comparing digests needs no decode."""
    return hashlib.sha256(reply_bytes).hexdigest()


def overhead_snapshot() -> dict:
    """Counter totals for a measurement's record (absent families read
    0)."""
    def total(name: str) -> float:
        m = REGISTRY.get(name)
        if m is None:
            return 0.0
        return float(sum(child.value for _, child in m.samples()))

    return {
        "guard_rows_failed": total("tdn_integrity_guard_rows_total"),
        "canary_probes": total("tdn_canary_probes_total"),
        "spotchecks": total("tdn_integrity_spotchecks_total"),
        "quarantines": total("tdn_quarantines_total"),
    }
