"""Device resolution: the port's one seam between the card and the CPU.

Replaces the JAX package's backend probing (``utils/backend.py``).
Every entry point resolves its device here: ``None`` means the card,
and a missing card is an error rather than a silent move to the CPU.
The CPU runs only when the caller asks for it (the tests do).
"""

from __future__ import annotations

import torch

from tpu_dist_nn_torch.utils.errors import InvalidArgumentError, UnavailableError


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises :class:`UnavailableError` without a
    visible GPU); ``"cpu"`` / ``"cuda"`` / ``"cuda:N"`` as asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise UnavailableError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return dev
    if dev.type != "cpu":
        raise InvalidArgumentError(
            f"unsupported device {device!r}: the port runs on 'cuda' or 'cpu'"
        )
    return dev
