"""Measurement tools of the port, each run as
``python -m audio_triangulation_tpu_torch.tools.<name>``."""
