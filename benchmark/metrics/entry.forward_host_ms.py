"""Entry: the host's time in ``Localizer.forward`` (the program's
``loc.forward`` span, host only), median over the traced stretch's
calls."""

import statistics

from benchmark.spans import host_ms


def read(r):
    ms = host_ms(r, "loc.forward")
    return statistics.median(ms) if ms else None
