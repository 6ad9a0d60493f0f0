"""Minimal dependency-free PNG writer (RGB8).

Counterpart of ``audio_triangulation_tpu.viz.png``, copied (numpy only;
the port imports nothing of the JAX package).

The reference's output plane is a DMA-streamed VGA framebuffer
(``src/lib/vga/vga16_graphics.c:89-148``); ours is files/arrays.  zlib +
struct only, so viz output works in any environment.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(rgb: np.ndarray) -> bytes:
    """Encode an RGB uint8 array [H, W, 3] as a PNG byte string."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    raw = b"".join(
        b"\x00" + rgb[y].tobytes() for y in range(h))  # filter 0 per row
    return b"".join([
        b"\x89PNG\r\n\x1a\n",
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(raw, 6)),
        _chunk(b"IEND", b""),
    ])


def write_png(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(rgb))
