"""Entry: the host's time from the call of ``Localizer.forward`` to its
return, with no wait for the device (the harness's own span), median over
the window's calls."""

import statistics


def read(r):
    ms = r.host.get("entry_ms")
    return statistics.median(ms) if ms else None
