"""Numpy-only helpers: synthetic scenes, reference-parameter conversion
and the golden model of the firmware's integer arithmetic."""
