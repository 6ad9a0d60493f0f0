"""Numpy-only helpers: synthetic scenes and reference-parameter conversion."""
