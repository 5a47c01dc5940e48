"""Line drawing (scatter of rasterized lines into an image).

Reference ``core/drawing.h:111-125``.  Here the draw is a single batched
scatter of all lines' rasterized points; out-of-bounds/masked points are
dropped by the scatter itself rather than per-line Python loops.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import geometry as geo
from . import rasterize as ras


@partial(jax.jit, static_argnames=("max_points",))
def seed_points_box(lines: jax.Array, box: jax.Array, max_points: int
                    ) -> tuple[jax.Array, jax.Array]:
    """Clip lines to a (traced) box and rasterize to integer seed pixels.

    Mirrors the clip+rasterize steps of ``drawLines`` (``drawing.h:116-123``).
    ``box``: ``(xmin, xmax, ymin, ymax)`` float array (traced, so differing
    canvas sizes share one compilation).

    Returns ``(points[N, max_points, 2] int32 (x, y), mask[N, max_points])``.
    """
    clipped, keep = ras.clip_lines_masked_dyn(lines, box)
    pts, pmask = ras.rasterize_lines_masked(clipped, max_points)
    mask = pmask & keep[:, None]
    return pts, mask


def seed_points(lines: jax.Array, height: int, width: int, max_points: int
                ) -> tuple[jax.Array, jax.Array]:
    """Static-shape convenience wrapper around :func:`seed_points_box`,
    returning flattened ``(N*max_points, 2)`` points + mask."""
    box = jnp.asarray([0.0, float(width - 1), 0.0, float(height - 1)], jnp.float32)
    pts, mask = seed_points_box(lines, box, max_points)
    return pts.reshape(-1, 2), mask.reshape(-1)


def draw_lines(img: jax.Array, lines: jax.Array, color, max_points: int | None = None) -> jax.Array:
    """Draw lines into ``img`` (shape ``(H, W)``) with a constant color.

    Functional (returns a new image).  Reference ``drawing.h:111-125``.
    """
    lines = geo.as_lines(lines)
    if lines.shape[0] == 0:
        return img
    h, w = img.shape
    if max_points is None:
        d = np.asarray(geo.p2(lines) - geo.p1(lines))
        max_points = max(1, int(np.nanmax(np.trunc(np.maximum(
            np.minimum(np.abs(d[:, 0]), w), np.minimum(np.abs(d[:, 1]), h))))) + 1,
            int(np.trunc(max(w, h))) + 1)
        max_points = min(max_points, w + h + 2)
    return _draw(img, lines, jnp.asarray(color, img.dtype), h, w, max_points)


@partial(jax.jit, static_argnames=("h", "w", "max_points"))
def _draw(img, lines, color, h, w, max_points):
    pts, mask = seed_points(lines, h, w, max_points)
    # Masked points get an out-of-range index and are dropped by the scatter.
    # (Must be positive: negative indices wrap in JAX even under mode="drop".)
    x = jnp.where(mask, pts[:, 0], w)
    y = jnp.where(mask, pts[:, 1], h)
    return img.at[y, x].set(color, mode="drop")
