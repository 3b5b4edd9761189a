"""Structured error taxonomy — the reference's gRPC status contract
without an RPC layer.

The reference surfaces failures as gRPC status codes: a dim mismatch
returns ``INVALID_ARGUMENT`` (``grpc_node.py:149-153``), any other
compute failure ``INTERNAL`` (``:154-158``), and a downstream stage's
failure is propagated upstream verbatim with an empty Matrix
(``:136-140``). On TPU there is no wire to carry status codes, so the
contract becomes typed exceptions raised host-side *before* compile
where possible (shapes are static — SURVEY.md §7 hard part 5) and from
the step function's driver otherwise. Each type records the stage that
failed, mirroring how the reference's codes identified the failing hop.
"""

from __future__ import annotations


class FrameworkError(Exception):
    """Base for all structured framework errors.

    ``code`` mirrors the reference's gRPC StatusCode names so client
    code migrating from the reference can switch on the same values.
    """

    code = "UNKNOWN"

    def __init__(self, message: str, *, stage: int | None = None):
        self.stage = stage
        if stage is not None:
            message = f"[stage {stage}] {message}"
        super().__init__(message)


class InvalidArgumentError(FrameworkError, ValueError):
    """Bad input/config — the reference's INVALID_ARGUMENT
    (dim mismatch, grpc_node.py:83-84,149-153; distribution mismatch,
    run_grpc_fcnn.py:182-183)."""

    code = "INVALID_ARGUMENT"


class InternalError(FrameworkError, RuntimeError):
    """Stage compute failure — the reference's INTERNAL
    (grpc_node.py:154-158)."""

    code = "INTERNAL"


class DeadlineExceededError(FrameworkError, TimeoutError):
    """A bounded wait expired — the reference's DEADLINE_EXCEEDED
    (its per-RPC timeouts: 10 s forward hop grpc_node.py:133, client
    ``--timeout`` run_grpc_inference.py:87,141)."""

    code = "DEADLINE_EXCEEDED"


class UnavailableError(FrameworkError, RuntimeError):
    """Cluster/engine not ready — the reference's readiness-poll failure
    (run_grpc_fcnn.py:157-172 timing out) / UNAVAILABLE channel state."""

    code = "UNAVAILABLE"


class ResourceExhaustedError(FrameworkError, RuntimeError):
    """Admission control shed: the serving queue is at its pending-rows
    watermark. Distinct from UNAVAILABLE ("retry elsewhere" — the
    target is gone) and DEADLINE_EXCEEDED (admitted but too slow): the
    server is healthy and explicitly asking this client to back off
    and retry HERE later. The reference had no backpressure story at
    all — overload just queued until something timed out."""

    code = "RESOURCE_EXHAUSTED"


class IntegrityError(FrameworkError, RuntimeError):
    """A correctness check failed: the result exists but cannot be
    trusted — non-finite activations past a numeric guard, a checkpoint
    array whose checksum disagrees with the fingerprint written at save
    time, a canary probe answering off-golden. Distinct from INTERNAL
    ("the computation crashed") because the hazard is the opposite: the
    computation *succeeded* and would have shipped a wrong answer. On
    the wire this maps to DATA_LOSS — unrecoverable data corruption —
    which is deliberately NOT in the transient-retry set: the fix is
    failover to a different replica plus quarantine of this one, never
    a retry against the same weights."""

    code = "INTEGRITY"


def check_full_batch(num_examples: int, batch_size: int) -> None:
    """Fail fast when ``drop_remainder`` batching would yield zero
    batches — shared by every trainer's epoch loop."""
    if num_examples < batch_size:
        raise InvalidArgumentError(
            f"dataset has {num_examples} examples but "
            f"batch_size={batch_size} drops remainders: no full "
            "batch to train on — lower batch_size"
        )


def check_input_dim(expected: int, got: int, *, stage: int | None = None) -> None:
    """The per-forward dim check every reference node ran
    (grpc_node.py:83-84), raised host-side before trace/compile."""
    if expected != got:
        raise InvalidArgumentError(
            f"Expected input dimension {expected}, got {got}", stage=stage
        )
