"""Observability for the port's serving path: the metric registry,
structured logging and request-scoped trace spans.

Counterparts of :mod:`tpu_dist_nn.obs` (``registry``, ``log``,
``trace``), kept as the port's own copies: these modules import the
standard library only.
"""
