"""Shared by the CLI parity tests (``tests/test_torch_cli*.py``): run one
command through the JAX package's CLI and through the port's
(``--device cpu``) in this process, and compare what they print with one
parser.

``compare_output`` holds two printouts to each other by the port's own
comparator (``cli.compare.compare_printouts``: the same lines once
numbers are masked, every integer equal, every decimal within ``tol``
(absolute) or ``rel`` (relative), host timings masked).  The one line that
differs by design is normalised first: the JAX CLI's "jax events" count is
the port's "device events"."""

from __future__ import annotations

import numpy as np

from audio_triangulation_tpu_torch.cli.compare import (NUMBER,
                                                       compare_printouts)


def run_both(capsys, argv, *, extra_port=()):
    """(JAX CLI printout, port CLI printout) of ``argv``."""
    from audio_triangulation_tpu.cli import main as jcli
    from audio_triangulation_tpu_torch.cli import main as tcli

    capsys.readouterr()
    jcli.main(list(argv))
    ref = capsys.readouterr().out
    tcli.main(list(argv) + ["--device", "cpu", *extra_port])
    got = capsys.readouterr().out
    return ref, got


def compare_output(ref: str, got: str, *, tol: float = 1.5e-3,
                   rel: float = 0.0, skip=()) -> float:
    """Assert the printouts agree (see the module docstring); returns the
    largest gap of a decimal."""
    agree, worst, why = compare_printouts(
        ref.replace("jax events", "device events"),
        got.replace("jax events", "device events"), tol=tol, rel=rel,
        skip=skip)
    assert agree, why
    return worst


def floats_after(text: str, key: str) -> np.ndarray:
    """The numbers in the parentheses after ``key`` on its first line."""
    line = [ln for ln in text.splitlines() if key in ln][0]
    inside = line.split(key, 1)[1].split(")")[0]
    return np.array([float(v) for v in NUMBER.findall(inside)])


def png_pixels(path: str) -> np.ndarray:
    """RGB [H, W, 3] of a PNG written by ``viz.png`` (filter 0 rows)."""
    import struct
    import zlib

    data = open(path, "rb").read()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)
