"""Host-side batch feeding.

Port of the unshuffled path of :func:`tpu_dist_nn.data.feed.
batch_iterator`: zero-copy numpy views in order. The shuffled native
row gather is not ported yet.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def batch_iterator(
    x: np.ndarray,
    y: np.ndarray | None = None,
    batch_size: int = 64,
    *,
    drop_remainder: bool = False,
) -> Iterator:
    """Yield ``(x_batch, y_batch)`` (or bare ``x_batch``) views in order."""
    n = len(x)
    for start in range(0, n, batch_size):
        stop = start + batch_size
        if drop_remainder and stop > n:
            return
        yield (x[start:stop], y[start:stop]) if y is not None else x[start:stop]
