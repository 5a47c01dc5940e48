"""Vectorized line clipping and rasterization.

Vectorized reformulation of the reference's per-line loops
(``core/drawing.h:57-102``, ``core/src/drawing.cpp:29-112``):

* ``rasterize_vector`` — elementwise, batched.
* ``clip_lines_masked`` — Cohen–Sutherland as a fixed-trip vectorized loop
  (each endpoint is clipped at most twice, so 8 iterations always converge);
  returns masks instead of dynamically-shaped results so it stays jittable.
* ``rasterize_lines_masked`` — all lines rasterized to a static ``(N, L, 2)``
  integer grid with a validity mask, replacing the reference's per-line
  dynamically-sized point lists.  This feeds the distance-transform seeding.

Rounding matches ``std::round`` / Eigen ``.round()`` — half away from zero —
NOT numpy's banker's rounding.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import geometry as geo


def round_half_away(x: jax.Array) -> jax.Array:
    """``std::round`` semantics: round half away from zero."""
    return jnp.sign(x) * jnp.floor(jnp.abs(x) + 0.5)


def rasterize_vector(vec: jax.Array) -> jax.Array:
    """Scale a 2-vector so its max-abs component is exactly ±1, keeping angle.

    Reference ``core/drawing.h:57-67``.  Shape ``(..., 2) -> (..., 2)``.
    A null vector yields NaN (0/0), as in the reference.
    """
    from .geometry import div_cr
    vx, vy = vec[..., 0], vec[..., 1]
    tan = div_cr(vy, vx)        # correctly rounded: feeds probe-pixel math
    # Branch 1: |tan| < 1 (x-major).  The reference condition is
    # `tan >= -1 and tan < 1`.
    b1 = (tan >= -1.0) & (tan < 1.0)
    c1 = vx < 0
    r1 = jnp.stack([1.0 - 2.0 * c1, tan - 2.0 * c1 * tan], axis=-1)
    # Branch 2: y-major.
    c2 = vy < 0
    inv = div_cr(jnp.ones_like(tan), tan)
    r2 = jnp.stack([inv - 2.0 * c2 * inv, 1.0 - 2.0 * c2], axis=-1)
    return jnp.where(b1[..., None], r1, r2)


# ---------------------------------------------------------------------------
# Cohen–Sutherland clipping — reference core/src/drawing.cpp:29-112
# ---------------------------------------------------------------------------

_INSIDE, _LEFT, _RIGHT, _BOTTOM, _TOP = 0, 1, 2, 4, 8


def _outcode(x, y, box):
    xmin, xmax, ymin, ymax = box
    code = jnp.zeros_like(x, dtype=jnp.int32)
    code = code | jnp.where(x < xmin, _LEFT, jnp.where(x > xmax, _RIGHT, 0))
    code = code | jnp.where(y < ymin, _BOTTOM, jnp.where(y > ymax, _TOP, 0))
    return code


def _clip_one_endpoint(px, py, qx, qy, code, box):
    """Clip (px,py) against one boundary chosen by reference priority
    TOP > BOTTOM > RIGHT > LEFT (``drawing.cpp:86-97``)."""
    xmin, xmax, ymin, ymax = box
    top = (code & _TOP) != 0
    bottom = ((code & _BOTTOM) != 0) & ~top
    right = ((code & _RIGHT) != 0) & ~top & ~bottom
    left = ((code & _LEFT) != 0) & ~top & ~bottom & ~right

    y_crop = jnp.where(top, ymax, ymin)
    nx_y = px + (qx - px) * (y_crop - py) / (qy - py)  # clipAgainstY
    x_crop = jnp.where(right, xmax, xmin)
    ny_x = py + (qy - py) * (x_crop - px) / (qx - px)  # clipAgainstX

    use_y = top | bottom
    use_x = right | left
    new_x = jnp.where(use_y, nx_y, jnp.where(use_x, x_crop, px))
    new_y = jnp.where(use_y, y_crop, jnp.where(use_x, ny_x, py))
    return new_x, new_y


@partial(jax.jit, static_argnums=(1,))
def clip_lines_masked(lines: jax.Array, box) -> tuple[jax.Array, jax.Array]:
    """Static-box wrapper around :func:`clip_lines_masked_dyn`."""
    return clip_lines_masked_dyn(lines, jnp.asarray(box, jnp.float32))


@jax.jit
def clip_lines_masked_dyn(lines: jax.Array, box: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Cohen–Sutherland clip of ``(N, 4)`` lines against ``box=(xmin,xmax,ymin,ymax)``.

    Returns ``(clipped_lines, keep_mask)``.  Lines fully outside get
    ``keep_mask=False`` (their coordinates are left as-is; callers mask).
    Jittable, fixed 8-iteration loop.
    """
    x1, y1, x2, y2 = (lines[:, i] for i in range(4))
    done_keep = jnp.zeros(lines.shape[0], dtype=bool)
    done_purge = jnp.zeros(lines.shape[0], dtype=bool)

    def body(_, state):
        x1, y1, x2, y2, keep, purge = state
        c1 = _outcode(x1, y1, box)
        c2 = _outcode(x2, y2, box)
        active = ~(keep | purge)
        both_in = (c1 == 0) & (c2 == 0)
        same_side = (c1 & c2) != 0
        keep = keep | (active & both_in)
        purge = purge | (active & same_side)
        active = active & ~both_in & ~same_side
        # Clip p1 first when it is outside, else p2 (drawing.cpp:85-101).
        clip_p1 = active & (c1 != 0)
        clip_p2 = active & (c1 == 0)
        nx1, ny1 = _clip_one_endpoint(x1, y1, x2, y2, c1, box)
        nx2, ny2 = _clip_one_endpoint(x2, y2, x1, y1, c2, box)
        x1 = jnp.where(clip_p1, nx1, x1)
        y1 = jnp.where(clip_p1, ny1, y1)
        x2 = jnp.where(clip_p2, nx2, x2)
        y2 = jnp.where(clip_p2, ny2, y2)
        return x1, y1, x2, y2, keep, purge

    x1, y1, x2, y2, keep, purge = jax.lax.fori_loop(
        0, 8, body, (x1, y1, x2, y2, done_keep, done_purge))
    clipped = jnp.stack([x1, y1, x2, y2], axis=-1)
    return clipped, keep


def clip_lines(lines, box, delete_oob: bool = True) -> np.ndarray:
    """Host-facing clip with the reference's output conventions.

    Reference ``core/drawing.h:50`` / ``drawing.cpp:64-112``: with
    ``delete_oob`` the out-of-bounds lines are removed; otherwise they are
    replaced by a singular ``(0,0)`` point.  ``box`` is
    ``(xmin, xmax, ymin, ymax)`` like the reference ``Box``.
    """
    arr = geo.as_lines(lines)
    if arr.shape[0] == 0:
        return np.zeros((0, 4), np.float32)
    clipped, keep = clip_lines_masked(arr, tuple(float(v) for v in box))
    clipped = np.array(clipped)
    keep = np.asarray(keep)
    if delete_oob:
        return clipped[keep]
    clipped[~keep] = 0.0
    return clipped


# ---------------------------------------------------------------------------
# Line rasterization — reference core/drawing.h:74-102
# ---------------------------------------------------------------------------

def raster_size(lines: jax.Array) -> jax.Array:
    """Number of rasterized points per line: ``trunc(max(|dx|, |dy|)) + 1``.

    Equivalent to the per-branch sizes in ``drawing.h:82-97`` (in every
    branch the step count reduces to the major-axis extent).
    """
    d = geo.p2(lines) - geo.p1(lines)
    m = jnp.maximum(jnp.abs(d[..., 0]), jnp.abs(d[..., 1]))
    return jnp.trunc(m).astype(jnp.int32) + 1


@partial(jax.jit, static_argnames=("max_points",))
def rasterize_lines_masked(lines: jax.Array, max_points: int) -> tuple[jax.Array, jax.Array]:
    """Rasterize ``(N, 4)`` lines onto a static ``(N, max_points, 2)`` int32 grid.

    Point ``i`` of line ``l`` is ``round(p1 + i * (p2 - p1) / (size - 1))``
    (LinSpaced + round, ``drawing.h:97-101``), valid while ``i < size``.
    Degenerate lines (p1 ≈ p2 within the reference's allClose atol=1e-5,
    ``drawing.h:76-77``) produce the single point ``round(p1)``.

    Returns ``(points[N, max_points, 2] int32, mask[N, max_points] bool)``.
    """
    a = geo.p1(lines)  # (N,2)
    b = geo.p2(lines)
    n = lines.shape[0]
    size = raster_size(lines)  # (N,)
    degenerate = (jnp.abs(b - a) <= 1e-5).all(axis=-1)
    size = jnp.where(degenerate, 1, size)

    i = jnp.arange(max_points, dtype=jnp.float32)  # (L,)
    denom = jnp.maximum(size - 1, 1).astype(jnp.float32)  # (N,)
    frac = i[None, :] / denom[:, None]  # (N,L)
    pts = a[:, None, :] + (b - a)[:, None, :] * frac[:, :, None]
    # Eigen LinSpaced(1, low, high) yields `high`; a degenerate line yields p1.
    single = jnp.where(degenerate[:, None], a, b)
    pts = jnp.where((size == 1)[:, None, None], single[:, None, :], pts)
    pts = round_half_away(pts).astype(jnp.int32)
    mask = i[None, :] < size[:, None].astype(jnp.float32)
    return pts, mask


def rasterize_line(line) -> np.ndarray:
    """Host-facing single-line rasterization returning ``(2, K)`` ints
    (reference layout, ``drawing.h:74``)."""
    arr = geo.as_lines(line)
    k = int(raster_size(arr)[0])
    dgen = bool(jnp.all(jnp.abs(geo.p2(arr) - geo.p1(arr)) <= 1e-5))
    if dgen:
        k = 1
    pts, mask = rasterize_lines_masked(arr, k)
    return np.asarray(pts[0]).T  # (2, K) rows = (x, y)
