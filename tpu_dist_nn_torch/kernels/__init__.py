"""Hand-written CUDA kernels for Hopper, each beside its plain version:
the dense chains, the fused conv, and flash attention on Hopper tensor
cores (bf16 through wgmma, float32 through 3xTF32 mma.sync: each a
forward and one fused backward).

Sources live in ``csrc/`` and are built at first use
(:mod:`tpu_dist_nn_torch.kernels._build`); importing this package
builds nothing.
"""

from tpu_dist_nn_torch.kernels.conv2d import fused_conv2d, fused_conv2d_plain
from tpu_dist_nn_torch.kernels.flash_attention import (
    flash_attention,
    flash_bwd,
    flash_bwd_dkv_plain,
    flash_bwd_dq_plain,
    flash_bwd_f32,
    flash_bwd_plain,
    flash_bwd_sm90,
    flash_fwd,
    flash_fwd_f32,
    flash_fwd_plain,
    flash_fwd_sm90,
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

#: Every kernel wrapper; each carries a ``launches`` count. (``flash_fwd``
#: and ``flash_bwd`` route to the flash wrappers and launch nothing
#: themselves.)
KERNEL_WRAPPERS = (fused_dense, fcnn_fused_forward, fcnn_quantized_forward, fused_conv2d,
                   flash_fwd_f32, flash_bwd_f32, flash_fwd_sm90, flash_bwd_sm90)


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
    "flash_bwd",
    "flash_bwd_dkv_plain",
    "flash_bwd_dq_plain",
    "flash_bwd_f32",
    "flash_bwd_plain",
    "flash_bwd_sm90",
    "flash_fwd",
    "flash_fwd_f32",
    "flash_fwd_plain",
    "flash_fwd_sm90",
    "forward_quantized",
    "fused_conv2d",
    "fused_conv2d_plain",
    "fused_dense",
    "fused_dense_plain",
    "quantize_fcnn",
    "reset_launch_counts",
]
