"""The layer-distribution pipeline over stage slots (devices + CUDA
streams): placement, the GPipe / 1F1B / interleaved schedules, and
their tables, and the heterogeneous (conv) pipeline. Port of
:mod:`tpu_dist_nn.parallel`'s pipelines."""
