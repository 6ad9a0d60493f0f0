"""GCC kernel: the device time of the program's ``loc.gcc`` span a call
(``fused_gcc_srp`` or ``gcc_peaks`` in ``localize_frames``, timed by the
span's CUDA events), the median over the traced stretch's calls."""

from benchmark.spans import device_ms_a_call


def read(r):
    return device_ms_a_call(r, "loc.gcc")
