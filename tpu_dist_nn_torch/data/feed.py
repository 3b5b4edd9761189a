"""Host-side batch feeding.

Port of :func:`tpu_dist_nn.data.feed.batch_iterator`: in order, zero-copy
numpy views; shuffled, the rows of each batch gathered by numpy
indexing in the order of ``np.random.default_rng(seed).permutation(n)``
(the same rows the JAX package's native gather gives).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def batch_iterator(
    x: np.ndarray,
    y: np.ndarray | None = None,
    batch_size: int = 64,
    *,
    shuffle: bool = False,
    seed: int = 0,
    drop_remainder: bool = False,
) -> Iterator:
    """Yield ``(x_batch, y_batch)`` (or bare ``x_batch``) host batches."""
    n = len(x)
    if not shuffle:
        for start in range(0, n, batch_size):
            stop = start + batch_size
            if drop_remainder and stop > n:
                return
            yield (x[start:stop], y[start:stop]) if y is not None else x[start:stop]
        return
    x = np.asarray(x)
    y = None if y is None else np.asarray(y)
    order = np.random.default_rng(seed).permutation(n)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        if drop_remainder and len(idx) < batch_size:
            return
        yield (x[idx], y[idx]) if y is not None else x[idx]
