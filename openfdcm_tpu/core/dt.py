"""Exact distance transforms of line sets.

The reference computes the DT with sequential separable passes
(Felzenszwalb–Huttenlocher lower envelope for L2/L2², two-pass min
propagation for L1 — ``core/imgproc.h:86-194``).  Both are *exact* EDTs of
the rasterized seed-pixel set, so here we compute the mathematically
identical quantity with two separable passes:

1. **Column pass** — vertical nearest-seed distance per column:
   ``g[y, x] = min over seed rows y' in column x of |y - y'|``.
   Computed with the cumulative-min identity
   ``min_{y'<=y}(f[y'] + (y - y')) = y + cummin(f[y'] - y')`` (one forward
   and one backward ``lax.cummin``) — exact integer arithmetic in f32.

2. **Row pass** — combine columns under the metric:
   * L1:    ``d[y, x] = min_x' (g[y, x'] + |x - x'|)`` — same cummin trick.
   * L2²:   ``d[y, x] = min_x' (g[y, x']² + (x - x')²)`` — a min-plus
     convolution with a quadratic kernel, chosen per compiled platform: on
     the GPU a Pallas kernel that scans only the source chunks inside each
     tile's L1 band that hold a seed (``ops/minplus_gpu.py``); elsewhere a
     streaming scan over source-column chunks (no O(W²) materialization).
   * L2:    sqrt of the L2² result (as the reference, ``imgproc.h:191-192``).

Coordinates are integers < 2^11 in practice, so all intermediate squared
distances are exact in float32 and the result is bit-comparable with the
reference.  Empty seed sets produce an all-``F32_MAX`` image, matching the
reference's initialization value surviving the passes (``imgproc.h:174``).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import geometry as geo
from . import draw
from .types import Distance, F32_MAX

# Row-pass source columns are consumed in chunks of this many columns.
# Small chunks serve two purposes on XLA:CPU (this path is the CPU/test
# backend; the GPU takes the banded Pallas kernel): (a) the fused
# (rows x W x chunk) broadcast-reduce stays inside the cache hierarchy —
# measured 15-25x vs chunk=128 even with every chunk active — and (b) the
# per-chunk all-infinite skip (see _minplus_quadratic_rows) gets fine
# granularity, which is what makes sparse orientation slices cheap.
_SRC_CHUNK = 8
# Rows are processed in blocks (flattening any leading batch axes into the
# row axis) so peak memory stays ~row_block * W * _SRC_CHUNK floats.
_ROW_BLOCK = 64
# Rows per broadcast-reduce of the dense form.
_DENSE_ROW_BLOCK = 512


def _nearest_1d_l1(f: jax.Array) -> jax.Array:
    """``out[..., i] = min_j (f[..., j] + |i - j|)`` along the last axis.

    Exact two-sided distance propagation via cumulative minima; f32-exact
    for index magnitudes < 2^24.
    """
    n = f.shape[-1]
    ax = f.ndim - 1
    i = jnp.arange(n, dtype=jnp.float32)
    fwd = i + jax.lax.cummin(f - i, axis=ax)
    bwd = -i + jax.lax.cummin(f + i, axis=ax, reverse=True)
    return jnp.minimum(fwd, bwd)


def _minplus_quadratic_rows(g: jax.Array) -> jax.Array:
    """``out[r, x] = min_x' (g[r, x'] + (x - x')²)`` for a row block ``(R, W)``.

    Streaming scan over source-column chunks; carry is the running min.
    An all-infinite chunk cannot win the min, so each chunk is gated by a
    ``lax.cond`` — empty / sparse orientation slices (most of a DT3 stack:
    each slice holds only its own angle bucket's lines) skip their source
    scan entirely instead of doing the dense O(W²) work.  Exact: skipping
    only removes +inf candidates.
    """
    r, w = g.shape
    xs = jnp.arange(w, dtype=jnp.float32)
    pad = (-w) % _SRC_CHUNK
    gp = jnp.pad(g, ((0, 0), (0, pad)), constant_values=jnp.inf)
    xp = jnp.pad(xs, (0, pad), constant_values=-1e9)
    n_chunks = gp.shape[1] // _SRC_CHUNK
    src = jnp.moveaxis(gp.reshape(r, n_chunks, _SRC_CHUNK), 1, 0)   # (C, R, S)
    xsrc = xp.reshape(n_chunks, _SRC_CHUNK)                          # (C, S)
    has_src = jnp.any(src < jnp.inf, axis=(1, 2))                    # (C,)

    def dense(carry, s, xc):
        d = xs[:, None] - xc[None, :]                # (W, S)
        cand = s[:, None, :] + (d * d)[None]         # (R, W, S)
        return jnp.minimum(carry, jnp.min(cand, axis=-1))

    def step(carry, inp):
        s, xc, has = inp                             # (R, S), (S,), ()
        out = jax.lax.cond(has, dense, lambda c, *_: c, carry, s, xc)
        return out, None

    init = jnp.full((r, w), jnp.inf, jnp.float32)
    out, _ = jax.lax.scan(step, init, (src, xsrc, has_src))
    return out


def _minplus_dense_rows(rows: jax.Array) -> jax.Array:
    """Dense ``out[r, x] = min_s (rows[r, s] + (x - s)²)`` over ``(R, W)``:
    one broadcast-reduce per block of ``_DENSE_ROW_BLOCK`` rows, no pruning
    and no data-dependent control flow."""
    r, w = rows.shape
    xs = jnp.arange(w, dtype=jnp.float32)
    d2 = (xs[:, None] - xs[None, :]) ** 2                  # (src, dst)
    pad = (-r) % _DENSE_ROW_BLOCK
    blocks = jnp.pad(rows, ((0, pad), (0, 0)), constant_values=jnp.inf)
    blocks = blocks.reshape(-1, _DENSE_ROW_BLOCK, w)
    out = jax.lax.map(lambda b: jnp.min(b[:, :, None] + d2[None], axis=1),
                      blocks)
    return out.reshape(-1, w)[:r]


def _minplus_chunked_rows(rows: jax.Array) -> jax.Array:
    """:func:`_minplus_quadratic_rows` over ``(R, W)`` in row blocks."""
    r, w = rows.shape
    pad = (-r) % _ROW_BLOCK
    rows_p = jnp.pad(rows, ((0, pad), (0, 0)), constant_values=jnp.inf)
    out = jax.lax.map(_minplus_quadratic_rows,
                      rows_p.reshape(-1, _ROW_BLOCK, w))
    return out.reshape(-1, w)[:r]


def _minplus_banded_gpu(rows: jax.Array, g: jax.Array) -> jax.Array:
    from ..ops.minplus_gpu import minplus_rows_banded
    return minplus_rows_banded(rows, _nearest_1d_l1(g).reshape(rows.shape))


# The row-pass form each platform compiles (``lax.platform_dependent``).
_gpu_rows = _minplus_banded_gpu


def row_pass(g: jax.Array, *, metric: Distance) -> jax.Array:
    """Horizontal combine of the column-pass distances ``g`` ``(..., H, W)``
    under ``metric`` — per-row math only (no cross-row dependence), so it is
    reused verbatim by the spatially sharded build
    (``parallel/spatial.py``): identical ops per row => bit-identical.
    """
    w = g.shape[-1]
    lead_hw = g.shape[:-1]

    if metric == Distance.L1:
        out = _nearest_1d_l1(g)
        return jnp.minimum(out, F32_MAX)

    # L2 / L2^2: row-wise min-plus with a quadratic kernel over g².
    g2 = jnp.minimum(g * g, jnp.inf)
    rows = g2.reshape(-1, w)
    out = jax.lax.platform_dependent(
        rows, g, cuda=lambda r, gg: _gpu_rows(r, gg),
        default=lambda r, gg: _minplus_chunked_rows(r))
    out = out.reshape(*lead_hw, w)
    out = jnp.minimum(out, F32_MAX)
    if metric == Distance.L2:
        out = jnp.where(out >= F32_MAX, F32_MAX, jnp.sqrt(out))
    return out


@partial(jax.jit, static_argnames=("metric",))
def dt_from_indicator(ind: jax.Array, *, metric: Distance) -> jax.Array:
    """Exact DT of a seed-indicator image ``(..., H, W)``.

    ``ind`` holds 0.0 at seed pixels and ``F32_MAX`` (or +inf) elsewhere.
    """
    return row_pass(column_pass(ind), metric=metric)


def column_pass(ind: jax.Array) -> jax.Array:
    """Vertical nearest-seed distance along y (axis -2) of a seed
    indicator ``(..., H, W)`` (0 at seeds, ``F32_MAX``/inf elsewhere)."""
    return jnp.swapaxes(_nearest_1d_l1(jnp.swapaxes(ind, -1, -2)), -1, -2)


def indicator_from_points(points: jax.Array, mask: jax.Array, height: int,
                          width: int) -> jax.Array:
    """Seed-indicator image from integer seed pixels ``(S, 2)`` (x, y)."""
    x = jnp.where(mask, points[..., 0], width)
    y = jnp.where(mask, points[..., 1], height)
    ind = jnp.full((height, width), F32_MAX, jnp.float32)
    return ind.at[y.reshape(-1), x.reshape(-1)].set(0.0, mode="drop")


@partial(jax.jit, static_argnames=("height", "width", "metric"))
def distance_from_seeds(points: jax.Array, mask: jax.Array, *, height: int,
                        width: int, metric: Distance) -> jax.Array:
    """Exact DT image ``(height, width)`` from integer seed pixels.

    ``points``: ``(S, 2)`` int32 ``(x, y)``; ``mask``: ``(S,)`` validity.
    Invalid seeds are ignored.  All-invalid -> all ``F32_MAX``.
    """
    ind = indicator_from_points(points, mask, height, width)
    return dt_from_indicator(ind, metric=metric)


def distance_transform(lines, size, metric: Distance = Distance.L2,
                       max_points: int | None = None) -> jax.Array:
    """DT of a line set on a ``(W, H) = size`` canvas.  Reference ``imgproc.h:169-194``.

    ``size`` follows the reference's ``Size`` convention ``(width, height)``.
    """
    lines = geo.as_lines(lines)
    w, h = int(size[0]), int(size[1])
    if lines.shape[0] == 0:
        return jnp.full((h, w), F32_MAX, jnp.float32)
    if max_points is None:
        max_points = int(np.hypot(w, h)) + 2
    pts, mask = draw.seed_points(lines, h, w, max_points)
    return distance_from_seeds(pts, mask, height=h, width=w, metric=metric)
