"""Host-side rendering: raster canvas, PNG writer, panels, terminal view."""
