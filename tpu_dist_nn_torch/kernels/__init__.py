"""Hand-written CUDA kernels for Hopper, each beside its plain version:
the dense chains, the fused conv, and flash attention (forward, dq and
dk/dv).

Sources live in ``csrc/`` and are built at first use
(:mod:`tpu_dist_nn_torch.kernels._build`); importing this package
builds nothing.
"""

from tpu_dist_nn_torch.kernels.conv2d import fused_conv2d, fused_conv2d_plain
from tpu_dist_nn_torch.kernels.flash_attention import (
    flash_attention,
    flash_bwd_dkv,
    flash_bwd_dkv_plain,
    flash_bwd_dq,
    flash_bwd_dq_plain,
    flash_fwd,
    flash_fwd_plain,
)
from tpu_dist_nn_torch.kernels.fused_dense import (
    fcnn_fused_forward,
    fcnn_fused_forward_plain,
    fused_dense,
    fused_dense_plain,
)
from tpu_dist_nn_torch.kernels.quantized import (
    fcnn_quantized_forward,
    forward_quantized,
    quantize_fcnn,
)

#: Every kernel wrapper; each carries a ``launches`` count.
KERNEL_WRAPPERS = (fused_dense, fcnn_fused_forward, fcnn_quantized_forward, fused_conv2d,
                   flash_fwd, flash_bwd_dq, flash_bwd_dkv)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's ``launches`` to 0."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


__all__ = [
    "KERNEL_WRAPPERS",
    "fcnn_fused_forward",
    "fcnn_fused_forward_plain",
    "fcnn_quantized_forward",
    "flash_attention",
    "flash_bwd_dkv",
    "flash_bwd_dkv_plain",
    "flash_bwd_dq",
    "flash_bwd_dq_plain",
    "flash_fwd",
    "flash_fwd_plain",
    "forward_quantized",
    "fused_conv2d",
    "fused_conv2d_plain",
    "fused_dense",
    "fused_dense_plain",
    "quantize_fcnn",
    "reset_launch_counts",
]
