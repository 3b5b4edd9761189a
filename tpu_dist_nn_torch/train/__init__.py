"""Training: classification metrics, the optimizer, the LM trainer."""
