"""DoA estimator: the device time of the program's ``doa.srp`` span a call
(the best lag, the taper and the azimuth scores, in ``models/doa.py``;
timed by the span's CUDA events), the median over the traced stretch's
calls."""

from benchmark.spans import device_ms_a_call


def read(r):
    return device_ms_a_call(r, "doa.srp")
