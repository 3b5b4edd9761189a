"""Errors, device resolution and timing helpers."""
