"""Activations and the public JSON model schema."""
