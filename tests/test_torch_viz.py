"""PyTorch port, the renderers (``viz``: raster canvas, 5x7 font, PNG
writer, panels, terminal view): the cases of ``tests/test_viz.py`` on the
port's copy, each held bit-equal to the JAX package's ``viz`` on the same
inputs (images as arrays, PNG files as bytes, terminal output as text).
The viz modules are numpy only; the port keeps its own copy because
importing any module of the JAX package runs its ``__init__`` (jax)."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import io
import zlib

import numpy as np
import pytest

from audio_triangulation_tpu.core import config as jcfg
from audio_triangulation_tpu.viz import (font5x7 as jfont, png as jpng,
                                         raster as jraster,
                                         render as jrender,
                                         terminal as jterm)
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.core import geometry
from audio_triangulation_tpu_torch.utils import golden
from audio_triangulation_tpu_torch.viz import (font5x7 as tfont, png as tpng,
                                               raster as traster,
                                               render as trender,
                                               terminal as tterm)

MICS = geometry.reference_array()
JAX = dict(cfg=jcfg, font=jfont, png=jpng, raster=jraster, render=jrender,
           term=jterm)
PORT = dict(cfg=tcfg, font=tfont, png=tpng, raster=traster, render=trender,
            term=tterm)


def both(scene, seed=0):
    """``scene(mods, rng)`` for the JAX package's viz and the port's, each
    with a fresh generator of ``seed``: (jax result, port result)."""
    return (scene(JAX, np.random.default_rng(seed)),
            scene(PORT, np.random.default_rng(seed)))


def assert_same(a, b):
    """Equal arrays, bytes, strings, or tuples / lists of them."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_canvas_primitives():
    def scene(m, rng):
        c = m["raster"].Canvas(64, 48)
        c.fill_rect(10, 10, 5, 5, m["raster"].WHITE)
        filled = c.rgb.copy()
        c.line(0, 0, 63, 47, 4)
        c.circle(32, 24, 10, 2)
        return filled, c.rgb.copy()

    ref, got = both(scene)
    assert_same(ref, got)
    filled, img = got
    assert (filled[10:15, 10:15] == 255).all()
    assert tuple(img[0, 0]) == tuple(traster.VGA16[4])
    assert tuple(img[47, 63]) == tuple(traster.VGA16[4])
    assert tuple(img[24, 42]) == tuple(traster.VGA16[2])


def test_heatmap_levels_palette_matches_reference_colors():
    def scene(m, rng):
        scores = rng.integers(0, 10**6, size=(101, 101)).astype(np.int64)
        levels = golden.heatmap_colors(scores)
        img = m["render"].heatmap_rgb(levels, m["cfg"].GridConfig(),
                                      cell_px=1, axes=False)
        return scores, levels, img

    ref, got = both(scene, 1)
    assert_same(ref, got)
    scores, levels, img = got
    y, x = np.unravel_index(scores.argmax(), scores.shape)
    assert tuple(img[y, x]) == (255, 255, 255)
    yz, xz = np.nonzero(levels == 0)
    assert (img[yz, xz] == 0).all()


def test_heatmap_continuous_and_markers():
    def scene(m, rng):
        scores = np.linspace(0, 1, 101 * 101).reshape(101, 101)
        return m["render"].heatmap_rgb(
            scores, m["cfg"].GridConfig(), mode="continuous",
            mic_positions=MICS, cell_px=4)

    ref, got = both(scene)
    assert_same(ref, got)
    assert got.shape == (404, 404, 3) and got.max() == 255


def test_panels_shapes():
    def scene(m, rng):
        wf = m["render"].waveform_panel(rng.normal(size=(3, 1024)),
                                        np.array([0, 5, -3]))
        cp = m["render"].correlogram_panel(rng.normal(size=(3, 93)))
        return wf, cp

    ref, got = both(scene, 2)
    assert_same(ref, got)
    assert got[0].shape == (81, 160, 3) and got[1].shape == (81, 160, 3)


def test_status_text_format():
    def scene(m, rng):
        return m["render"].status_text(
            frame_powers=[100, 200, 300], best_shifts=[1, -2, 3],
            mic_positions=MICS, pair_names=["AB", "AC", "BC"])

    ref, got = both(scene)
    assert ref == got
    assert "Mic A" in got and "Shift AB:  +1" in got
    assert "Mic Positions" in got


def test_dashboard_composes():
    def scene(m, rng):
        frames = rng.normal(size=(3, 1024))
        corr = rng.normal(size=(3, 93))
        scores = rng.integers(0, 10**6, size=101 * 101).astype(np.int64)
        levels = golden.heatmap_colors(scores.reshape(101, 101))
        return m["render"].dashboard(
            frames=frames, correlograms=corr,
            heat_levels_or_scores=levels, grid=m["cfg"].GridConfig(),
            mic_positions=MICS, best_shifts=np.array([4, -6, 2]),
            status=m["render"].status_text(best_shifts=[4, -6, 2]))

    ref, got = both(scene, 3)
    assert_same(ref, got)
    assert got.shape == (480, 640, 3) and got.any()


def test_png_roundtrip(tmp_path):
    rgb = np.random.default_rng(4).integers(
        0, 255, size=(20, 30, 3)).astype(np.uint8)
    data = tpng.png_bytes(rgb)
    assert data == jpng.png_bytes(rgb)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    idat_pos = data.find(b"IDAT")
    size = int.from_bytes(data[idat_pos - 4: idat_pos], "big")
    raw = zlib.decompress(data[idat_pos + 4: idat_pos + 4 + size])
    rows = np.frombuffer(raw, np.uint8).reshape(20, 1 + 30 * 3)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(20, 30, 3), rgb)
    # the files the writers leave are the same bytes
    tpng.write_png(str(tmp_path / "t.png"), rgb)
    jpng.write_png(str(tmp_path / "j.png"), rgb)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def test_terminal_heatmap_ansi():
    def scene(m, rng):
        levels = rng.integers(0, 5, size=101 * 101).astype(np.uint8)
        art = m["term"].heatmap_ansi(levels, 101, 101, max_cols=32)
        scores = rng.normal(size=101 * 101)
        art2 = m["term"].heatmap_ansi(scores, 101, 101, mode="ramp",
                                      max_cols=16)
        return art, art2

    ref, got = both(scene, 5)
    assert ref == got
    art, art2 = got
    assert "\x1b[38;5;" in art and art.endswith("\x1b[0m")
    assert art2.count("\n") > 5


def test_live_view_rewrites():
    def scene(m, rng):
        buf = io.StringIO()
        lv = m["term"].LiveView(out=buf)
        lv.update("line1\nline2")
        lv.update("next")
        return buf.getvalue()

    ref, got = both(scene)
    assert ref == got
    assert "line1" in got and "\x1b[2F" in got


def test_live_view_delta_redraw_skips_unchanged_lines():
    def scene(m, rng):
        buf = io.StringIO()
        lv = m["term"].LiveView(out=buf)
        lv.update("header\nrowA\nrowB")
        mark = buf.tell()
        lv.update("header\nrowA CHANGED\nrowB")
        delta = buf.getvalue()[mark:]
        mark = buf.tell()
        lv.update("only")
        return delta, buf.getvalue()[mark:]

    ref, got = both(scene)
    assert ref == got
    delta, tail = got
    assert delta.startswith("\x1b[3F")
    assert "rowA CHANGED" in delta and delta.count("\x1b[2K") == 1
    assert "header" not in delta and "rowB" not in delta
    assert "\x1b[J" in tail and "only" in tail


def test_font_glyphs_well_formed():
    for code in range(32, 127):
        g = tfont.glyph(chr(code))
        np.testing.assert_array_equal(g, jfont.glyph(chr(code)))
        assert g.shape == (7, 5)
        if chr(code) != " ":
            assert g.any(), chr(code)
    dash = tfont.glyph("-")
    assert dash[3].all() and dash.sum() == 5
    pipe = tfont.glyph("|")
    assert pipe[:, 2].all() and pipe.sum() == 7


def test_canvas_text_renders_pixels():
    def scene(m, rng):
        c = m["raster"].Canvas(120, 20, background=(0, 0, 0))
        c.text("XY=0.5", 2, 2, 15)
        c2 = m["raster"].Canvas(120, 40)
        c2.text("A", 0, 0, 15, size=20)
        return c.rgb.copy(), c2.rgb.copy()

    ref, got = both(scene)
    assert_same(ref, got)
    lit = (got[0] != 0).any(axis=-1)
    assert lit.sum() > 40
    ys, xs = lit.nonzero()
    assert ys.min() >= 2 and ys.max() <= 8
    lit2 = (got[1] != 0).any(axis=-1)
    assert lit2[:14, :10].sum() == 4 * int(tfont.glyph("A").sum())


def test_canvas_text_multiline_and_clipping():
    def scene(m, rng):
        c = m["raster"].Canvas(30, 30)
        c.text("AB\nCD", 0, 0, 15)
        first = c.rgb.copy()
        c.text("CLIPPED", -3, 28, 15)
        c.text("OFF", 40, 40, 15)
        return first, c.rgb.copy()

    ref, got = both(scene)
    assert_same(ref, got)
    lit = (got[0] != 0).any(axis=-1)
    assert lit[:7].any() and lit[9:16].any()


def test_ellipse_primitive_draws_closed_outline():
    def scene(m, rng):
        c = m["raster"].Canvas(100, 100)
        c.ellipse(50, 50, 30, 15, np.deg2rad(30.0), 12)
        return c.rgb.copy()

    ref, got = both(scene)
    assert_same(ref, got)
    drawn = np.argwhere((got != 0).any(axis=-1))
    assert len(drawn) > 40
    d = np.linalg.norm(drawn - np.array([50, 50]), axis=-1)
    assert d.max() <= 31.5 and d.min() >= 13.0, (d.min(), d.max())


def test_overlay_uncertainty_marks_position():
    xy = np.array([0.5, 0.4])
    cov = np.diag([0.01, 0.0025])  # 10 cm / 5 cm sigmas

    def scene(m, rng):
        grid = m["cfg"].GridConfig()
        img = m["render"].heatmap_rgb(np.zeros(grid.num_cells, np.uint8),
                                      grid, mode="levels")
        before = img.copy()
        out = m["render"].overlay_uncertainty(img, grid, xy, cov)
        assert out is img
        return before, img

    ref, got = both(scene)
    assert_same(ref, got)
    before, img = got
    grid = tcfg.GridConfig()
    changed = np.argwhere((img != before).any(axis=-1))
    assert len(changed) > 20
    cell = 4
    cx = grid.half_cells_x * cell + cell // 2 + xy[0] * grid.cells_per_m * cell
    cy = grid.half_cells_y * cell + cell // 2 - xy[1] * grid.cells_per_m * cell
    d = np.linalg.norm(changed - np.array([cy, cx]), axis=-1)
    assert d.max() < 30, d.max()


def test_dashboard_with_uncertainty_overlay():
    def scene(m, rng):
        grid = m["cfg"].GridConfig()
        return m["render"].dashboard(
            frames=np.random.default_rng(0).normal(size=(3, 1024)),
            correlograms=np.random.default_rng(1).normal(size=(3, 93)),
            heat_levels_or_scores=np.zeros(grid.num_cells, np.uint8),
            grid=grid, mic_positions=np.zeros((3, 2)),
            xy=np.array([0.3, -0.2]), xy_cov=np.diag([0.004, 0.004]))

    ref, got = both(scene)
    assert_same(ref, got)
    assert got.shape == (480, 640, 3)


def test_volume_panels_marks_peak():
    true = np.array([0.3, -0.2, 1.1])

    def scene(m, rng):
        vol = m["cfg"].VolumeConfig(half_cells_x=10, half_cells_y=10,
                                    cells_per_m=10.0, z_min_m=0.5,
                                    z_max_m=1.5, z_cells=11)
        pts = geometry.volume_points(vol).astype(np.float64)
        scores = np.exp(-((pts - true) ** 2).sum(-1) / 0.02).reshape(-1)
        return m["render"].volume_panels(
            scores, vol, mic_positions=geometry.tetrahedral_array(0.2),
            xyz=true, cell_px=4)

    ref, got = both(scene)
    assert_same(ref, got)
    assert got.ndim == 3 and got.shape[2] == 3
    assert got.shape[1] >= 2 * 21 * 4
    half = got.shape[1] // 2
    assert got[:, :half].max() > 200 and got[:, half:].max() > 200


MODULES = {"font5x7": (jfont, tfont), "png": (jpng, tpng),
           "raster": (jraster, traster), "render": (jrender, trender),
           "terminal": (jterm, tterm)}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_viz_sources_are_the_reference_copies(name):
    """Each module's code is the JAX package's statement for statement
    (only the module docstring says it is the port's copy)."""
    import ast
    import inspect

    def body(mod):
        tree = ast.parse(inspect.getsource(mod))
        tree.body = tree.body[1:]  # the docstring
        return ast.dump(tree)

    jmod, tmod = MODULES[name]
    assert body(jmod) == body(tmod)
