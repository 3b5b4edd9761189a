"""The layer-distribution pipeline over stage slots (devices + CUDA
streams): placement, the GPipe / 1F1B / interleaved / zero-bubble
schedules and their tables, the heterogeneous (conv) pipeline, the
Megatron split over model slots and sequence parallelism over seq
slots. Port of :mod:`tpu_dist_nn.parallel`'s pipelines, tensor and
sequence parallelism."""
