"""The JAX package's examples on the port: ``quickstart``, ``advanced``,
``production``, ``robustness`` and ``serving_http``, each printing the
reference's lines.  Run one with ``python -m
audio_triangulation_tpu_torch.examples.<name> [--device cpu]``: on the card
unless given ``--device cpu``."""
