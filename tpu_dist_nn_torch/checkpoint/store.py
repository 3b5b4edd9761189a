"""Native checkpoint store: ``.npz`` state files, atomic writes, retention.

Port of the single-process half of :mod:`tpu_dist_nn.checkpoint.store`.
Layout of a checkpoint directory::

    ckpt_00000003.npz     one file per step: np.savez of the state's leaves
    manifest.json         {"latest_step": 3, "steps": [1, 2, 3], "metadata": {...}}

The state is a tree of dicts, lists, tuples and dataclasses (the
trainer's ``{"params": [...], "opt_state": OptState}``) whose leaves are
tensors, numpy arrays or Python numbers; a file holds each leaf as a
host array under its key path (``params/0/w``, ``opt_state/mu/3``).
The JAX package writes flax msgpack, which this port does not read: the
JSON model file stays the interchange between the two.

Restore is template-based: the caller rebuilds the state skeleton
(initial params and ``optimizer.init``) and the stored arrays are
poured into it, each tensor leaf landing on its template's device and
dtype. Every leaf of the template must be in the file and nothing else.
A leaf sliced over data slots (the ZeRO / FSDP state of
:mod:`tpu_dist_nn_torch.parallel.zero`) is written whole under its usual
key and re-sliced by its template's layout on restore, so a sharded
run's checkpoint and an unsharded run's are the same file (the JAX
package fetches sharded leaves whole to the host the same way).
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import queue
import tempfile
import threading
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

_MANIFEST = "manifest.json"
_PREFIX = "ckpt_"
_SUFFIX = ".npz"


def _atomic_write_bytes(path: Path, data: bytes) -> None:
    """Write-then-rename so a crash never leaves a torn checkpoint."""
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=".tmp_ckpt_")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _map_leaves(fn: Callable[[str, Any], Any], tree: Any, path: str = "") -> Any:
    """``tree`` with each leaf replaced by ``fn(key_path, leaf)``. Dicts,
    lists, tuples and dataclass instances are containers; ``None`` stays
    ``None`` (an empty slot, e.g. an unused accumulator)."""
    def sub(key) -> str:
        return f"{path}/{key}" if path else str(key)

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, sub(i)) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_leaves(fn, getattr(tree, f.name), sub(f.name))
            for f in dataclasses.fields(tree)})
    return fn(path or "_", tree)


def _to_host(leaf) -> np.ndarray:
    """A host copy of one leaf (a snapshot: the trainer updates its
    tensors in place after the save). A leaf sliced over data slots
    (:class:`~tpu_dist_nn_torch.parallel.zero.Shards`) is saved whole."""
    if hasattr(leaf, "host_array"):
        return leaf.host_array()
    if isinstance(leaf, torch.Tensor):
        return np.array(leaf.detach().cpu())
    return np.array(leaf)


def _host_arrays(state: Any) -> dict[str, np.ndarray]:
    """``{key_path: host array}`` for every leaf of ``state``."""
    arrays: dict[str, np.ndarray] = {}
    _map_leaves(lambda k, leaf: arrays.__setitem__(k, _to_host(leaf)), state)
    return arrays


def _restore_leaf(template, arr: np.ndarray):
    if hasattr(template, "restored"):
        return template.restored(arr)  # re-sliced by the template's layout
    if isinstance(template, torch.Tensor):
        t = torch.from_numpy(arr).to(device=template.device, dtype=template.dtype)
        return t.requires_grad_(True) if template.requires_grad else t
    if isinstance(template, bool):
        return bool(arr)
    if isinstance(template, int):
        return int(arr)
    if isinstance(template, float):
        return float(arr)
    return arr


def _write_arrays(path: Path, arrays: dict[str, np.ndarray]) -> None:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    _atomic_write_bytes(path, buf.getvalue())


def save_pytree(state: Any, path: str | Path) -> None:
    """Write one state tree to an ``.npz`` file (host copy included)."""
    _write_arrays(Path(path), _host_arrays(state))


def restore_pytree(template: Any, path: str | Path) -> Any:
    """Restore a state tree into ``template``'s structure from a file."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    try:
        state = _map_leaves(lambda k, t: _restore_leaf(t, arrays.pop(k)), template)
        if arrays:
            raise KeyError(f"leaves not in the template: {sorted(arrays)}")
    except KeyError as e:
        raise ValueError(
            f"checkpoint {path} does not match this run's training state "
            f"layout ({e}). It was likely written under a different "
            "placement or trainer configuration — resume with the "
            "original configuration or start a fresh --checkpoint-dir"
        ) from e
    return state


class CheckpointManager:
    """Step-indexed checkpoints with retention and a JSON manifest.

    ``save`` is atomic per file; the manifest is rewritten after the
    checkpoint lands, so ``latest_step`` never points at a torn file.
    ``keep`` bounds disk use by deleting the oldest checkpoints.
    """

    def __init__(self, directory: str | Path, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _path(self, step: int) -> Path:
        return self.directory / f"{_PREFIX}{step:08d}{_SUFFIX}"

    def _manifest_path(self) -> Path:
        return self.directory / _MANIFEST

    def _read_manifest(self) -> dict:
        p = self._manifest_path()
        if not p.exists():
            return {"latest_step": None, "steps": []}
        with open(p) as f:
            return json.load(f)

    def _write_manifest(self, manifest: dict) -> None:
        _atomic_write_bytes(self._manifest_path(), json.dumps(manifest).encode("utf-8"))

    def steps(self) -> list[int]:
        return list(self._read_manifest()["steps"])

    def latest_step(self) -> int | None:
        return self._read_manifest()["latest_step"]

    def _retention_error(self, step: int, extra_steps=()) -> str | None:
        """Reject a ``step`` older than the oldest retained step: its
        own save would prune it, a caller bug."""
        manifest = self._read_manifest()
        steps = sorted(set(manifest["steps"]) | set(extra_steps) | {step})
        if len(steps) > self.keep and step in steps[: len(steps) - self.keep]:
            return (
                f"step {step} is older than the retention window "
                f"(keep={self.keep}, existing steps {manifest['steps']})"
            )
        return None

    def _save_local(self, step: int, arrays: dict[str, np.ndarray],
                    metadata: dict | None = None) -> Path:
        """Filesystem half of a save: write + prune + manifest."""
        path = self._path(step)
        manifest = self._read_manifest()
        steps = sorted(set(manifest["steps"]) | {step})
        _write_arrays(path, arrays)
        if metadata:
            manifest.setdefault("metadata", {})[str(step)] = metadata
        while len(steps) > self.keep:
            victim = steps.pop(0)
            vpath = self._path(victim)
            if vpath.exists():
                vpath.unlink()
            manifest.get("metadata", {}).pop(str(victim), None)
        manifest.update({"latest_step": max(steps), "steps": steps})
        self._write_manifest(manifest)
        return path

    def save(self, step: int, state: Any, metadata: dict | None = None) -> Path:
        """Persist ``state`` under ``step``; prunes beyond ``keep``."""
        step = int(step)
        err = self._retention_error(step)
        if err is not None:
            raise ValueError(err)
        return self._save_local(step, _host_arrays(state), metadata)

    def restore(self, template: Any, step: int | None = None) -> tuple[int, Any]:
        """Restore ``step`` (default: newest intact) into ``template``.

        Returns ``(step, state)``. Raises ``FileNotFoundError`` when the
        directory holds no checkpoints (callers start fresh). When the
        manifest lists steps but every listed file is missing, raises
        ``RuntimeError``: that is corruption, not a fresh start.
        """
        if step is not None:
            path = self._path(int(step))
            if not path.exists():
                raise FileNotFoundError(f"no checkpoint for step {step} in {self.directory}")
            return int(step), restore_pytree(template, path)
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        # Fall back past a torn or lost newest file to the newest intact one.
        for candidate in sorted(steps, reverse=True):
            path = self._path(candidate)
            if path.exists():
                return int(candidate), restore_pytree(template, path)
        raise RuntimeError(
            f"manifest in {self.directory} lists steps {steps} but no "
            "checkpoint files exist — refusing to restart from scratch"
        )

    def restore_or_none(self, template: Any) -> tuple[int, Any] | None:
        try:
            return self.restore(template)
        except FileNotFoundError:
            return None


class AsyncCheckpointManager(CheckpointManager):
    """Non-blocking saves: the training loop enqueues and moves on.

    ``save`` copies the state to host arrays on the caller's thread (the
    trainer updates its tensors in place, so the copy is the snapshot);
    one daemon worker writes the files in order, so retention and the
    manifest stay race-free. A worker failure is re-raised on the next
    ``save``, ``wait`` or ``restore``, never swallowed. ``wait()`` blocks
    until everything enqueued is durable; ``restore`` waits first.
    """

    def __init__(self, directory: str | Path, keep: int = 3):
        super().__init__(directory, keep)
        self._queue: queue.Queue = queue.Queue(maxsize=2)
        self._error: BaseException | None = None
        self._closed = False
        # Steps enqueued but not yet in the manifest: retention
        # validation counts them (the on-disk manifest lags the queue).
        self._pending_steps: list[int] = []
        self._thread = threading.Thread(target=self._worker, name="tdn-ckpt-writer",
                                        daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                step, arrays, metadata = item
                self._save_local(step, arrays, metadata)
            except BaseException as e:  # surfaced on the caller's side
                self._error = e
            finally:
                if item is not None:
                    try:
                        self._pending_steps.remove(item[0])
                    except ValueError:
                        pass
                self._queue.task_done()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, state: Any, metadata: dict | None = None) -> Path:
        if self._closed:
            # Enqueueing with no consumer would deadlock a later wait().
            raise RuntimeError("AsyncCheckpointManager is closed")
        step = int(step)
        arrays = _host_arrays(state)
        self._raise_pending()
        err = self._retention_error(step, extra_steps=tuple(self._pending_steps))
        if err is not None:
            raise ValueError(err)
        self._pending_steps.append(step)
        self._queue.put((step, arrays, metadata))
        return self._path(step)

    def wait(self) -> None:
        """Block until every enqueued checkpoint is on disk."""
        self._queue.join()
        self._raise_pending()

    def restore(self, template: Any, step: int | None = None):
        self.wait()
        return super().restore(template, step)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._thread.join()
        self._raise_pending()


def flush(checkpoints) -> None:
    """Make enqueued saves durable; a no-op for sync managers and None.
    The trainers call it on both exits of their loop, so a save enqueued
    before a crash still lands."""
    wait = getattr(checkpoints, "wait", None)
    if wait is not None:
        wait()


def _shape(a) -> tuple:
    return tuple(a.shape) if hasattr(a, "shape") else np.shape(a)


def _shape_check_leaf(t, r):
    """Template-vs-restored leaf shape gate (see :func:`resume_or_init`)."""
    ts, rs = _shape(t), _shape(r)
    if ts != rs:
        raise InvalidArgumentError(
            f"checkpoint leaf shape {rs} does not match this run's "
            f"template shape {ts} — the checkpoint was written under "
            "a different placement (e.g. a different --stages or "
            "model size); use a matching configuration or a fresh "
            "checkpoint directory"
        )
    return r


def resume_or_init(checkpoints, state: dict) -> tuple[int, dict]:
    """The trainers' resume step: restore the newest checkpoint into
    ``state``'s structure, or keep ``state`` as it is when none exists.
    Returns ``(completed_epochs, state)``. Restored leaf shapes are
    checked against the template: the file matches by key path, so a
    checkpoint of another model size would otherwise fail deep inside
    the first step."""
    if checkpoints is None:
        return 0, state
    restored = checkpoints.restore_or_none(state)
    if restored is None:
        return 0, state
    step, restored_state = restored
    template: dict[str, Any] = {}
    _map_leaves(lambda k, leaf: template.__setitem__(k, leaf), state)
    return step, _map_leaves(lambda k, r: _shape_check_leaf(template[k], r), restored_state)
