"""Command-line entry point (``python -m audio_triangulation_tpu_torch``)."""
