"""The Engine: orchestrator + client surface in one object."""

from tpu_dist_nn_torch.api.engine import Engine, InferenceResult, PendingInference

__all__ = ["Engine", "InferenceResult", "PendingInference"]
