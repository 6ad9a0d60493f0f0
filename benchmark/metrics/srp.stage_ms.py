"""SRP scoring: the device time of the program's ``loc.srp`` span a call
(the scores, the score bias and the grid peak in ``localize_frames``,
timed by the span's CUDA events), the median over the traced stretch's
calls."""

from benchmark.spans import device_ms_a_call


def read(r):
    return device_ms_a_call(r, "loc.srp")
