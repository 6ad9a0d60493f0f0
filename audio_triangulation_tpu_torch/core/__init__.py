"""Configuration, array geometry and array design (``design``: CRLB maps
and gradient-based mic placement)."""
