"""The layer-distribution pipeline over stage slots (devices + CUDA
streams): placement, the GPipe / 1F1B / interleaved schedules, and
their tables. Port of the dense half of :mod:`tpu_dist_nn.parallel`."""
