"""Models: the FCNN params + forward, and mixed dense/conv/pool networks."""

from tpu_dist_nn_torch.models.fcnn import (
    forward,
    forward_logits,
    init_fcnn,
    params_from_spec,
    spec_from_params,
)
from tpu_dist_nn_torch.models.network import (
    LayerPlan,
    build_network,
    init_conv_mlp,
    network_forward,
    network_forward_lax,
    network_logits,
    network_model_from_params,
    network_params_from_jax,
)

__all__ = [
    "LayerPlan",
    "build_network",
    "forward",
    "forward_logits",
    "init_conv_mlp",
    "init_fcnn",
    "network_forward",
    "network_forward_lax",
    "network_logits",
    "network_model_from_params",
    "network_params_from_jax",
    "params_from_spec",
    "spec_from_params",
]
