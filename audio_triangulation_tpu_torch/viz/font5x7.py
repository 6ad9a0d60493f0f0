"""Embedded 5x7 bitmap font (ASCII 32-126), dependency-free.

Counterpart of ``audio_triangulation_tpu.viz.font5x7``, copied (numpy only;
the port imports nothing of the JAX package).

The reference firmware always renders status text from its own font ROM
(``src/lib/vga/glcdfont.c``, drawn by ``vga_text.h`` /
``vga16_graphics.c drawChar``).  This table fills the same role so
``Canvas.text`` never silently no-ops.  Glyphs are authored here row-wise
('X' = lit) and compiled to a [96, 7, 5] bool array at import; glyph shapes
are original (any legible 5x7 face necessarily looks similar).
"""

from __future__ import annotations

import numpy as np

GLYPH_W, GLYPH_H = 5, 7

# Each glyph: 7 rows of 5 cells, rows separated by '/'.
_GLYPHS = {
    ' ': "...../...../...../...../...../...../.....",
    '!': "..X../..X../..X../..X../..X../...../..X..",
    '"': ".X.X./.X.X./.X.X./...../...../...../.....",
    '#': ".X.X./.X.X./XXXXX/.X.X./XXXXX/.X.X./.X.X.",
    '$': "..X../.XXXX/X.X../.XXX./..X.X/XXXX./..X..",
    '%': "XX.../XX..X/...X./..X../.X.../X..XX/...XX",
    '&': ".XX../X..X./X.X../.X.../X.X.X/X..X./.XX.X",
    "'": "..X../..X../..X../...../...../...../.....",
    '(': "...X./..X../.X.../.X.../.X.../..X../...X.",
    ')': ".X.../..X../...X./...X./...X./..X../.X...",
    '*': "...../..X../X.X.X/.XXX./X.X.X/..X../.....",
    '+': "...../..X../..X../XXXXX/..X../..X../.....",
    ',': "...../...../...../...../..X../..X../.X...",
    '-': "...../...../...../XXXXX/...../...../.....",
    '.': "...../...../...../...../...../.XX../.XX..",
    '/': "...../....X/...X./..X../.X.../X..../.....",
    '0': ".XXX./X...X/X..XX/X.X.X/XX..X/X...X/.XXX.",
    '1': "..X../.XX../..X../..X../..X../..X../.XXX.",
    '2': ".XXX./X...X/....X/...X./..X../.X.../XXXXX",
    '3': ".XXX./X...X/....X/..XX./....X/X...X/.XXX.",
    '4': "...X./..XX./.X.X./X..X./XXXXX/...X./...X.",
    '5': "XXXXX/X..../XXXX./....X/....X/X...X/.XXX.",
    '6': ".XXX./X..../X..../XXXX./X...X/X...X/.XXX.",
    '7': "XXXXX/....X/...X./..X../.X.../.X.../.X...",
    '8': ".XXX./X...X/X...X/.XXX./X...X/X...X/.XXX.",
    '9': ".XXX./X...X/X...X/.XXXX/....X/....X/.XXX.",
    ':': "...../.XX../.XX../...../.XX../.XX../.....",
    ';': "...../.XX../.XX../...../.XX../..X../.X...",
    '<': "...X./..X../.X.../X..../.X.../..X../...X.",
    '=': "...../...../XXXXX/...../XXXXX/...../.....",
    '>': ".X.../..X../...X./....X/...X./..X../.X...",
    '?': ".XXX./X...X/....X/...X./..X../...../..X..",
    '@': ".XXX./X...X/X.XXX/X.X.X/X.XX./X..../.XXX.",
    'A': ".XXX./X...X/X...X/XXXXX/X...X/X...X/X...X",
    'B': "XXXX./X...X/X...X/XXXX./X...X/X...X/XXXX.",
    'C': ".XXX./X...X/X..../X..../X..../X...X/.XXX.",
    'D': "XXXX./X...X/X...X/X...X/X...X/X...X/XXXX.",
    'E': "XXXXX/X..../X..../XXXX./X..../X..../XXXXX",
    'F': "XXXXX/X..../X..../XXXX./X..../X..../X....",
    'G': ".XXX./X...X/X..../X.XXX/X...X/X...X/.XXXX",
    'H': "X...X/X...X/X...X/XXXXX/X...X/X...X/X...X",
    'I': ".XXX./..X../..X../..X../..X../..X../.XXX.",
    'J': "..XXX/...X./...X./...X./...X./X..X./.XX..",
    'K': "X...X/X..X./X.X../XX.../X.X../X..X./X...X",
    'L': "X..../X..../X..../X..../X..../X..../XXXXX",
    'M': "X...X/XX.XX/X.X.X/X.X.X/X...X/X...X/X...X",
    'N': "X...X/XX..X/X.X.X/X..XX/X...X/X...X/X...X",
    'O': ".XXX./X...X/X...X/X...X/X...X/X...X/.XXX.",
    'P': "XXXX./X...X/X...X/XXXX./X..../X..../X....",
    'Q': ".XXX./X...X/X...X/X...X/X.X.X/X..X./.XX.X",
    'R': "XXXX./X...X/X...X/XXXX./X.X../X..X./X...X",
    'S': ".XXXX/X..../X..../.XXX./....X/....X/XXXX.",
    'T': "XXXXX/..X../..X../..X../..X../..X../..X..",
    'U': "X...X/X...X/X...X/X...X/X...X/X...X/.XXX.",
    'V': "X...X/X...X/X...X/X...X/X...X/.X.X./..X..",
    'W': "X...X/X...X/X...X/X.X.X/X.X.X/XX.XX/X...X",
    'X': "X...X/X...X/.X.X./..X../.X.X./X...X/X...X",
    'Y': "X...X/X...X/.X.X./..X../..X../..X../..X..",
    'Z': "XXXXX/....X/...X./..X../.X.../X..../XXXXX",
    '[': ".XXX./.X.../.X.../.X.../.X.../.X.../.XXX.",
    '\\': "...../X..../.X.../..X../...X./....X/.....",
    ']': ".XXX./...X./...X./...X./...X./...X./.XXX.",
    '^': "..X../.X.X./X...X/...../...../...../.....",
    '_': "...../...../...../...../...../...../XXXXX",
    '`': ".X.../..X../...X./...../...../...../.....",
    'a': "...../...../.XXX./....X/.XXXX/X...X/.XXXX",
    'b': "X..../X..../X.XX./XX..X/X...X/X...X/XXXX.",
    'c': "...../...../.XXX./X..../X..../X...X/.XXX.",
    'd': "....X/....X/.XX.X/X..XX/X...X/X...X/.XXXX",
    'e': "...../...../.XXX./X...X/XXXXX/X..../.XXX.",
    'f': "..XX./.X..X/.X.../XXX../.X.../.X.../.X...",
    'g': "...../.XXXX/X...X/X...X/.XXXX/....X/.XXX.",
    'h': "X..../X..../X.XX./XX..X/X...X/X...X/X...X",
    'i': "..X../...../.XX../..X../..X../..X../.XXX.",
    'j': "...X./...../..XX./...X./...X./X..X./.XX..",
    'k': "X..../X..../X..X./X.X../XX.../X.X../X..X.",
    'l': ".XX../..X../..X../..X../..X../..X../.XXX.",
    'm': "...../...../XX.X./X.X.X/X.X.X/X.X.X/X.X.X",
    'n': "...../...../X.XX./XX..X/X...X/X...X/X...X",
    'o': "...../...../.XXX./X...X/X...X/X...X/.XXX.",
    'p': "...../XXXX./X...X/X...X/XXXX./X..../X....",
    'q': "...../.XXXX/X...X/X...X/.XXXX/....X/....X",
    'r': "...../...../X.XX./XX.../X..../X..../X....",
    's': "...../...../.XXXX/X..../.XXX./....X/XXXX.",
    't': ".X.../.X.../XXX../.X.../.X.../.X..X/..XX.",
    'u': "...../...../X...X/X...X/X...X/X..XX/.XX.X",
    'v': "...../...../X...X/X...X/X...X/.X.X./..X..",
    'w': "...../...../X...X/X.X.X/X.X.X/X.X.X/.X.X.",
    'x': "...../...../X...X/.X.X./..X../.X.X./X...X",
    'y': "...../X...X/X...X/.XXXX/....X/X...X/.XXX.",
    'z': "...../...../XXXXX/...X./..X../.X.../XXXXX",
    '{': "...XX/..X../..X../.X.../..X../..X../...XX",
    '|': "..X../..X../..X../..X../..X../..X../..X..",
    '}': "XX.../..X../..X../...X./..X../..X../XX...",
    '~': "...../.X.../X.X.X/...X./...../...../.....",
}


def _compile() -> np.ndarray:
    table = np.zeros((127 - 32, GLYPH_H, GLYPH_W), dtype=bool)
    for ch, spec in _GLYPHS.items():
        rows = spec.split("/")
        assert len(rows) == GLYPH_H and all(len(r) == GLYPH_W for r in rows), ch
        g = np.array([[c == "X" for c in row] for row in rows])
        table[ord(ch) - 32] = g
    return table


FONT = _compile()


def glyph(ch: str) -> np.ndarray:
    """[7, 5] bool bitmap for a character (unknown chars render as '?')."""
    o = ord(ch)
    if not (32 <= o < 127):
        o = ord("?")
    return FONT[o - 32]


def render_text(s: str, scale: int = 1) -> np.ndarray:
    """[7*scale, (6*len(s)-1)*scale] bool mask for a line of text
    (1-pixel inter-glyph spacing, like drawChar's 6-px advance)."""
    if not s:
        return np.zeros((GLYPH_H * scale, 0), dtype=bool)
    cells = []
    for i, ch in enumerate(s):
        cells.append(glyph(ch))
        if i != len(s) - 1:
            cells.append(np.zeros((GLYPH_H, 1), dtype=bool))
    mask = np.concatenate(cells, axis=1)
    if scale != 1:
        mask = np.repeat(np.repeat(mask, scale, axis=0), scale, axis=1)
    return mask
