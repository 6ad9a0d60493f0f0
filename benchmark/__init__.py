"""The benchmark of ``audio_triangulation_tpu_torch`` on one H100: one run
of one cell a process (``python3 -m benchmark.run --help``).  See
``README.md``."""
