"""Hold two printouts of the command line to each other: the same command
run on two devices, or the port's CLI against the reference's.

:func:`compare_printouts` takes the printouts line by line: the same lines
once numbers are masked, every integer equal (shifts, trigger samples,
counts, ids), every decimal within ``tol`` (absolute) plus ``rel`` times
its size.  Host timings are masked first, and lines that match a pattern
of ``skip`` are left out."""

from __future__ import annotations

import re

NUMBER = re.compile(r"[-+]?\d+(?:\.\d*)?(?:[eE][-+]?\d+)?")
# host timings: "(1.2s)", "ingest rate: 15k samples/s"
TIMING = (re.compile(r"\(\d+\.\d+s\)"),
          re.compile(r"ingest rate: \d+k samples/s"))


def normalise(text: str, skip=()) -> list:
    """The printout's lines without those matching ``skip``, host timings
    masked."""
    lines = []
    for line in text.splitlines():
        if any(re.search(s, line) for s in skip):
            continue
        for pat in TIMING:
            line = pat.sub("<t>", line)
        lines.append(line)
    return lines


def skeleton(line: str) -> str:
    """The line with its numbers masked and its spacing dropped (numpy
    pads printed arrays to the widest value)."""
    return re.sub(r"\s+", "", NUMBER.sub("#", line))


def is_int(token: str) -> bool:
    return not any(c in token for c in ".eE")


def compare_printouts(ref: str, got: str, *, tol: float = 1.5e-3,
                      rel: float = 0.0, skip=()) -> tuple[bool, float, str]:
    """(agree, the largest gap of a decimal, the first disagreement or
    '') of two printouts."""
    a, b = normalise(ref, skip), normalise(got, skip)
    if len(a) != len(b):
        return False, 0.0, f"{len(a)} lines against {len(b)}"
    worst = 0.0
    for la, lb in zip(a, b):
        if skeleton(la) != skeleton(lb):
            return False, worst, f"{la!r} / {lb!r}"
        for ta, tb in zip(NUMBER.findall(la), NUMBER.findall(lb)):
            if is_int(ta) and is_int(tb):
                if int(ta) != int(tb):
                    return False, worst, f"{la!r} / {lb!r}"
                continue
            fa, fb = float(ta), float(tb)
            gap = abs(fa - fb)
            worst = max(worst, gap)
            if gap > tol + rel * abs(fa):
                return False, worst, f"{la!r} / {lb!r} (gap {gap:.3g})"
    return True, worst, ""
