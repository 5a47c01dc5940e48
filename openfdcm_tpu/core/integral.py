"""Directional line integrals (cumulative sums along a rasterized direction).

The reference implements this as a sequential in-place column/row block-shift
accumulation (``core/imgproc.h:38-84``): sweeping along the major axis, each
swept column adds the previously swept column shifted by
``delta_i = round(i*r) - round((i-1)*r)`` rows (always in {-1, 0, +1}).

Accelerator formulation: a ``lax.scan`` over sweep positions with an
``(H,)`` carry — the per-step shift is one of three static shift patterns
selected by ``delta``, so each step is a handful of elementwise ops with no
gathers.  Slices sharing a sweep orientation run in one vmapped scan.

Physical canvases may be padded beyond the logical region; sweep positions
are assigned so the logical region keeps reference-exact indices (padded
rows are zeros and padded columns occupy trailing sweep positions, so they
never perturb logical sums).  The sweep geometry (major axis, flip, step
ratio, per-step deltas) depends only on the *static* angle set and physical
size; the logical size enters only through a traced permutation, so the
whole stack integral is jittable with no per-scene recompiles.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["sweep_spec", "line_integral", "line_integral_stack"]


def sweep_spec(angle: float):
    """Host-side sweep geometry for ``lineIntegral`` at a static angle.

    Returns ``(x_major, flip, r_minor)``: whether the sweep runs along x,
    whether it starts from the far edge, and the minor-axis step ratio —
    computed in float32 like the reference (``imgproc.h:42-57``,
    ``drawing.h:57-67``).
    """
    c = np.float32(np.cos(np.float32(angle)))
    s = np.float32(np.sin(np.float32(angle)))
    tan = s / c
    if -1.0 <= tan < 1.0:  # x-major
        cond = c < 0
        rv = (np.float32(1 - 2 * cond), np.float32(tan - 2.0 * cond * tan))
    else:
        cond = s < 0
        inv = np.float32(1.0) / tan
        rv = (np.float32(inv - 2.0 * cond * inv), np.float32(1 - 2 * cond))
    x_major = abs(float(rv[0])) == 1.0
    if x_major:
        return True, float(rv[0]) < 0, rv[1]
    return False, float(rv[1]) < 0, rv[0]


def _deltas(r: np.float32, n: int) -> np.ndarray:
    """delta_i = round(i*r) - round((i-1)*r) (std::round, f32), delta_0 = 0."""
    i = np.arange(n, dtype=np.float32)
    prod = i * np.float32(r)
    s = (np.sign(prod) * np.floor(np.abs(prod) + np.float32(0.5))).astype(np.int32)
    d = np.zeros(n, np.int32)
    d[1:] = s[1:] - s[:-1]
    return d


_SWEEP_UNROLL = 8


def _sweep_scan(img: jax.Array, deltas_by_col: jax.Array, flip: bool) -> jax.Array:
    """Integrate along axis 1 in sweep order.

    carry = col + shift(prev_carry, delta); out-of-range rows receive no
    contribution (zero fill), exactly like the reference's block-window add
    (``imgproc.h:59-62``).

    Sweep order visits the logical columns (reversed when ``flip``) before
    the zero-valued physical padding.  A flipped sweep is a plain reversed
    scan over the physical axis: the padding is then visited first, but it
    only accumulates zeros, so every logical column sees exactly the
    reference carry — no permutation gathers needed.  ``deltas_by_col``
    holds each column's sweep-position delta.

    The scan is UNROLLED ``_SWEEP_UNROLL`` columns per step: the per-step
    math is a handful of ops on an ``(H,)`` carry, so a W-step scan is
    bound by per-step loop overhead; the unrolled inner loop keeps the
    exact sequential accumulation order (bit-identical results) at 1/8 the
    step count.
    """
    cols = img.T  # (W, H)
    w = cols.shape[0]
    k = _SWEEP_UNROLL
    pad = (-w) % k
    if pad:
        # Zero columns with delta 0 cannot perturb any carry: appended at
        # the physical end they are swept last (forward) or first (flip),
        # contributing zero either way.
        cols = jnp.concatenate(
            [cols, jnp.zeros((pad,) + cols.shape[1:], cols.dtype)], axis=0)
        deltas_by_col = jnp.concatenate(
            [deltas_by_col, jnp.zeros((pad,), deltas_by_col.dtype)])
    blocks = cols.reshape(-1, k, cols.shape[1])
    dblocks = deltas_by_col.reshape(-1, k)

    def step(carry, inp):
        colb, db = inp                     # (k, H), (k,)
        outs = [None] * k
        order = range(k - 1, -1, -1) if flip else range(k)
        for t in order:                    # sequential within the block
            col, d = colb[t], db[t]
            down = jnp.concatenate([jnp.zeros_like(carry[:1]), carry[:-1]])
            up = jnp.concatenate([carry[1:], jnp.zeros_like(carry[:1])])
            carry = col + jnp.where(d == 1, down,
                                    jnp.where(d == -1, up, carry))
            outs[t] = carry
        return carry, jnp.stack(outs)

    _, out = jax.lax.scan(step, jnp.zeros_like(cols[0]),
                          (blocks, dblocks), reverse=flip)
    out = out.reshape(-1, cols.shape[1])[:w]
    return out.T  # (H, W), already in physical column order


def line_integral(img: jax.Array, angle: float) -> jax.Array:
    """Line integral of one image along ``angle``.  Reference ``imgproc.h:38-84``."""
    h, w = img.shape
    return line_integral_stack(img[None], [angle],
                               logical_hw=jnp.asarray([h, w], jnp.int32))[0]


def _group_geometry(angles, phys_n_by_major):
    """Static per-group geometry: for each major-axis group, the member slice
    indices, flip flags, and delta tables."""
    specs = [sweep_spec(float(a)) for a in angles]
    groups = []
    for want_x_major in (True, False):
        idxs = [i for i, sp in enumerate(specs) if sp[0] == want_x_major]
        if not idxs:
            continue
        n_phys = phys_n_by_major[want_x_major]
        flips = np.array([specs[i][1] for i in idxs])
        dels = np.stack([_deltas(specs[i][2], n_phys) for i in idxs])
        groups.append((want_x_major, tuple(idxs), flips, dels))
    return groups


@partial(jax.jit, static_argnames=("angles",))
def _line_integral_stack(imgs: jax.Array, logical_hw: jax.Array, *, angles):
    d, ph, pw = imgs.shape
    groups = _group_geometry(angles, {True: pw, False: ph})
    out = [None] * d
    for x_major, idxs, flips, dels in groups:
        n_log = logical_hw[1] if x_major else logical_hw[0]
        for flip_val in (False, True):
            sub = [k for k, f in enumerate(flips) if bool(f) == flip_val]
            if not sub:
                continue
            sub_idxs = [idxs[k] for k in sub]
            group = imgs[np.array(sub_idxs)]
            if not x_major:
                group = jnp.swapaxes(group, 1, 2)
            n_phys = group.shape[2]
            dsub = jnp.asarray(dels[np.array(sub)])          # (G, W) sweep order
            if flip_val:
                # column c holds sweep position n_log-1-c (padding: unused)
                col = jnp.arange(n_phys)
                pidx = jnp.clip(n_log - 1 - col, 0, n_phys - 1)
                dcol = jnp.where(col[None, :] < n_log,
                                 jnp.take(dsub, pidx, axis=1), 0)
            else:
                dcol = dsub
            res = jax.vmap(partial(_sweep_scan, flip=flip_val))(group, dcol)
            if not x_major:
                res = jnp.swapaxes(res, 1, 2)
            for k, i in enumerate(sub_idxs):
                out[i] = res[k]
    return jnp.stack(out)


def line_integral_stack(imgs: jax.Array, angles, logical_hw=None) -> jax.Array:
    """Line integrals of a ``(D, PH, PW)`` stack, one static angle per slice.

    ``logical_hw``: traced ``(H, W)`` (int array or tuple); trailing physical
    padding (which must be zero-valued) stays out of the reference-exact
    index pattern.
    """
    d, ph, pw = imgs.shape
    if logical_hw is None:
        logical_hw = jnp.asarray([ph, pw], jnp.int32)
    else:
        logical_hw = jnp.asarray(logical_hw, jnp.int32)
    assert len(angles) == d
    return _line_integral_stack(imgs, logical_hw,
                                angles=tuple(float(a) for a in angles))
