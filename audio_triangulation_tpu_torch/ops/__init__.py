"""Tensor ops of the pipeline; ``cuda/`` holds the hand-written kernels."""
