"""Checkpoint / resume: the training state (params, optimizer state,
completed epochs) as per-step ``.npz`` files with atomic writes,
retention and a JSON manifest. Port of :mod:`tpu_dist_nn.checkpoint`;
the JSON model file (:mod:`tpu_dist_nn_torch.core.schema`) stays the
public interchange format."""

from tpu_dist_nn_torch.checkpoint.store import (
    AsyncCheckpointManager,
    CheckpointManager,
    flush,
    restore_pytree,
    resume_or_init,
    save_pytree,
)

__all__ = [
    "AsyncCheckpointManager",
    "CheckpointManager",
    "flush",
    "restore_pytree",
    "resume_or_init",
    "save_pytree",
]
