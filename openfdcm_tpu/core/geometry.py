"""Line geometry primitives for Fast Directional Chamfer Matching.

Data model
----------
A *line array* is a float32 tensor of shape ``(..., 4)`` where the last axis
holds ``(x1, y1, x2, y2)``.  This is the transpose of the reference library's
column-major ``4 x N`` Eigen layout (reference ``core/math.h:57-66``): putting
the line axis first makes every op batchable with ``jax.vmap`` and keeps the
last axis small and contiguous.

All functions are pure, shape-polymorphic over leading batch axes, and safe
to ``jax.jit``.  Semantics mirror the reference implementations cited in each
docstring; where the reference relies on IEEE-754 edge cases (NaN/inf
propagation in ``normalize``/``getAngle``), those are preserved.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

PI = math.pi
HALF_PI = math.pi / 2.0


def _round_launder(v: jax.Array) -> jax.Array:
    """Force ``v`` to its rounded f32 value in a way no compiler pass can
    undo: bitcast to int32, add a runtime-opaque integer zero, bitcast
    back.

    WHY: LLVM-based XLA backends (XLA:CPU, and NVPTX on the GPU) contract
    ``mul`` feeding ``add/sub`` into FMA inside fused loops — and XLA
    strips ``optimization_barrier`` before fusion, duplicating producers
    into consumers, so the same HLO value can take different f32 values in
    different uses (observed: the ``sin`` of an alignment rotation differed
    between its returned value and the subtraction consuming it, flipping
    candidate geometry by 1 ulp and drifting a pose golden 1%).  Backends
    contract in different places, so they disagree.  Routing the
    product's bits through integer arithmetic forces the multiply to be a
    real rounded instruction on every backend: the int add cannot be
    elided because its operand ``|v|*0`` is only zero for finite ``v`` (a
    fact no compiler may assume), and FMA patterns cannot cross integer
    ops.  Cost: 4 cheap elementwise ops, no fusion break.

    Non-finite ``v`` degrades to garbage bits (|v|*0 = NaN) — every call
    site's non-finite lanes are masked out downstream, matching the
    pre-existing NaN-propagation contract."""
    z = jax.lax.bitcast_convert_type(jnp.abs(v) * jnp.float32(0.0),
                                     jnp.int32)
    return jax.lax.bitcast_convert_type(
        jax.lax.bitcast_convert_type(v, jnp.int32) + z, jnp.float32)


def _pmul(a: jax.Array, b: jax.Array) -> jax.Array:
    """f32 product forced through a rounded intermediate (see
    :func:`_round_launder`) so no backend can contract it into an FMA with
    a following add — every product on the candidate-geometry and
    probe-coordinate paths must round to f32 explicitly for cross-backend
    bit stability."""
    return _round_launder(a * b)


def _apply2x2(rot: jax.Array, v: jax.Array) -> jax.Array:
    """Exact-f32 2x2 matrix application (elementwise — keeps matrix units out
    of tiny K=2 contractions and avoids low-precision matmul defaults; each
    product rounds to f32 via :func:`_pmul` for cross-backend bit
    stability)."""
    x = _pmul(rot[..., 0, 0], v[..., 0]) + _pmul(rot[..., 0, 1], v[..., 1])
    y = _pmul(rot[..., 1, 0], v[..., 0]) + _pmul(rot[..., 1, 1], v[..., 1])
    return jnp.stack([x, y], axis=-1)


def _two_prod_err(a: jax.Array, b: jax.Array, p: jax.Array) -> jax.Array:
    """Exact rounding error of the f32 product: ``a*b == p + err`` in real
    arithmetic, computed with Dekker's split (only IEEE-exact mul/add/sub,
    so the result is bit-identical on every backend).  Valid while the
    4097-scaled splits do not overflow (|a|,|b| < ~4e34 — everything in
    this geometry domain)."""
    c = jnp.float32(4097.0)                # 2^12 + 1 for a 12/12 bit split
    ac = _round_launder(a * c)             # Veltkamp split is famously
    bc = _round_launder(b * c)             # contraction-unsafe: force the
    ah = ac - (ac - a)                     # scaled products to round
    al = a - ah
    bh = bc - (bc - b)
    bl = b - bh
    return ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _ulp_neighborhood(v: jax.Array, k: int) -> list:
    """``[v, v-1ulp, v+1ulp, ..., v-k ulp, v+k ulp]`` — the candidate set
    for the correctly-rounded pickers.  k=4 covers a backend sqrt seed off
    by 3 ulp (observed at x=852790.2 on an approximate-sqrt backend) with
    margin."""
    lo, hi, out = v, v, [v]
    for _ in range(k):
        lo = jnp.nextafter(lo, jnp.float32(-jnp.inf))
        hi = jnp.nextafter(hi, jnp.float32(jnp.inf))
        out += [lo, hi]
    return out


def _pick_min_resid(cands: jax.Array, r: jax.Array) -> jax.Array:
    """Candidate (leading axis) with the smallest non-negative residual;
    exact ties (a halfway quotient/root) resolve round-to-even, then to the
    first candidate in stack order.  Residuals compare as int32 bit
    patterns (exact for non-negative f32; NaN bits sort large)."""
    bits = lambda v: jax.lax.bitcast_convert_type(v, jnp.int32)
    br = bits(r)
    rmin = jnp.min(br, axis=0)
    is_min = br == rmin[None]
    odd = jnp.stack([bits(c) & 1 for c in cands])
    rank = jnp.where(is_min, odd, 2)       # even minima first, then odd
    best = jnp.argmin(rank, axis=0)        # first index on ties
    return jnp.take_along_axis(cands, best[None, ...], axis=0)[0]


def div_cr(a: jax.Array, b: jax.Array) -> jax.Array:
    """Correctly-rounded f32 division, bit-identical on every backend.

    WHY: an accelerator backend may lower f32 ``divide`` to reciprocal +
    Newton and ``sqrt`` similarly, 1 ulp off the correctly-rounded result
    the CPU backend produces on a large share of inputs.  FDCM's discrete
    decisions (orientation-slice classification, probe-pixel truncation,
    walk bounds) amplify a 1-ulp quotient difference into different match
    scores (a 1% golden drift, observed).  Off the CPU this computes the
    backend divide as a seed, then picks the true round-to-nearest
    quotient among the +-2-ulp neighbors by comparing EXACT residuals
    ``|a - q*b|`` (Dekker products; only IEEE-exact ops).

    The branch is chosen per compiled platform
    (``lax.platform_dependent``): XLA:CPU divides with the IEEE
    correctly-rounded instruction, which is already the value the
    correction would pick, so it skips the ~30 flops/element.

    NaN/inf propagate through the seed (residuals go NaN and argmin keeps
    the seed lane).  Quotients above 4e34 pass through uncorrected: the
    Veltkamp split of ``q * 4097`` overflows there.  Use on the small
    candidate-geometry tensors, not per-probe data.
    """
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    a, b = jnp.broadcast_arrays(a, b)
    return jax.lax.platform_dependent(a, b, cpu=jnp.divide,
                                      default=_div_corrected)


def _div_corrected(a: jax.Array, b: jax.Array) -> jax.Array:
    q0 = a / b
    cands = jnp.stack(_ulp_neighborhood(q0, 2))

    def resid(q):
        # launder: q*b must be rounded before the subtraction — a fused
        # multiply-subtract would already be exact and double-count the
        # Dekker error term
        p = _round_launder(q * b)
        return jnp.abs((a - p) - _two_prod_err(q, b, p))

    r = jnp.stack([resid(q) for q in cands])
    out = _pick_min_resid(cands, r)
    exact = (jnp.isnan(q0) | jnp.isinf(q0) | (q0 == 0)
             | (jnp.abs(q0) > jnp.float32(4e34)))
    return jnp.where(exact, q0, out)


def sqrt_cr(x: jax.Array) -> jax.Array:
    """Correctly-rounded f32 sqrt, bit-identical on every backend — same
    neighbor-residual construction and per-platform branch as
    :func:`div_cr` (XLA:CPU's sqrt is already IEEE correctly rounded)."""
    x = jnp.asarray(x, jnp.float32)
    return jax.lax.platform_dependent(x, cpu=jnp.sqrt, default=_sqrt_corrected)


def _sqrt_corrected(x: jax.Array) -> jax.Array:
    s0 = jnp.sqrt(x)
    cands = jnp.stack(_ulp_neighborhood(s0, 4))

    def resid(s):
        p = _round_launder(s * s)                 # see div_cr.resid
        return jnp.abs((x - p) - _two_prod_err(s, s, p))

    r = jnp.stack([resid(s) for s in cands])
    out = _pick_min_resid(cands, r)
    exact = jnp.isnan(s0) | jnp.isinf(s0) | (s0 == 0)
    return jnp.where(exact, s0, out)


def as_lines(lines) -> jax.Array:
    """Coerce input to a float32 ``(N, 4)`` line array.

    Accepts the reference's ``(4, N)`` layout (reference ``core/math.h:66``)
    as well as the native ``(N, 4)`` layout.  A ``(4, 4)`` array is ambiguous
    and interpreted as native ``(N, 4)``.
    """
    arr = jnp.asarray(lines, dtype=jnp.float32)
    if arr.ndim == 1:
        arr = arr.reshape(1, 4)
    if arr.ndim == 2 and arr.shape[0] == 4 and arr.shape[1] != 4:
        arr = arr.T
    if arr.shape[-1] != 4:
        raise ValueError(f"line array must have a trailing axis of 4, got {arr.shape}")
    return arr


def as_lines_np(lines) -> "np.ndarray":
    """Host (numpy) twin of :func:`as_lines` — no device round-trip.

    Orchestration code (search strategies, candidate bookkeeping) runs on
    host data; going through jnp would cost a device round trip per call.
    """
    import numpy as np
    arr = np.asarray(lines, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr.reshape(1, 4)
    if arr.ndim == 2 and arr.shape[0] == 4 and arr.shape[1] != 4:
        arr = arr.T
    if arr.shape[-1] != 4:
        raise ValueError(f"line array must have a trailing axis of 4, got {arr.shape}")
    return arr


def p1(lines: jax.Array) -> jax.Array:
    """First endpoint, ``(..., 2)``.  Reference ``core/math.h:282``."""
    return lines[..., 0:2]


def p2(lines: jax.Array) -> jax.Array:
    """Second endpoint, ``(..., 2)``.  Reference ``core/math.h:283``."""
    return lines[..., 2:4]


@jax.jit
def get_center(lines: jax.Array) -> jax.Array:
    """Midpoint of each line, ``(..., 2)``.  Reference ``core/math.h:286-288``."""
    return (p1(lines) + p2(lines)) * 0.5


@jax.jit
def get_angle(lines: jax.Array) -> jax.Array:
    """Angle of each line in ``[-pi/2, pi/2]``, shape ``(...,)``.

    Matches reference ``core/math.h:295-299``: ``atan(dy/dx)`` — NOT atan2 —
    so a vertical line maps to ``+/-pi/2`` (atan of ``+/-inf``) and a
    degenerate point line maps to NaN (atan of ``0/0``).
    """
    d = p2(lines) - p1(lines)
    return jnp.arctan(d[..., 1] / d[..., 0])


@jax.jit
def get_length(lines: jax.Array) -> jax.Array:
    """Euclidean length of each line, shape ``(...,)``.  Reference ``core/math.h:306-308``."""
    d = p2(lines) - p1(lines)
    return sqrt_cr(_pmul(d[..., 0], d[..., 0]) + _pmul(d[..., 1], d[..., 1]))


def get_template_lengths(templates) -> list:
    """Total line length per template.  Reference ``core/math.h:319-324``.

    Host-side (numpy): template metadata lives on host and this is called
    once per search; no reason to pay device dispatch per template.
    """
    import numpy as np
    out = []
    for t in templates:
        arr = np.asarray(t, dtype=np.float32)
        if arr.ndim == 2 and arr.shape[0] == 4 and arr.shape[1] != 4:
            arr = arr.T
        arr = arr.reshape(-1, 4)
        if arr.shape[0] == 0:
            out.append(0.0)
            continue
        d = arr[:, 2:4] - arr[:, 0:2]
        out.append(float(np.sum(np.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2), dtype=np.float32)))
    return out


@jax.jit
def normalize(lines: jax.Array) -> jax.Array:
    """Unit direction vector of each line, ``(..., 2)``.

    Reference ``core/math.h:331-333`` (Eigen ``colwise().normalized()``):
    a zero-length line yields ``(0, 0)`` (Eigen's normalized() of a zero
    vector returns the zero vector).  Squares round to f32 (:func:`_pmul`)
    so the norm — and everything the aligned candidates derive from it —
    is bit-identical across backends.
    """
    d = p2(lines) - p1(lines)
    n = sqrt_cr(_pmul(d[..., 0:1], d[..., 0:1]) + _pmul(d[..., 1:2], d[..., 1:2]))
    return jnp.where(n > 0, div_cr(d, jnp.where(n > 0, n, 1.0)), 0.0)


@jax.jit
def transform(lines: jax.Array, mat23: jax.Array) -> jax.Array:
    """Apply a 2x3 affine transform to a line array.  Reference ``core/math.h:341-344``.

    ``mat23`` may carry leading batch axes ``(..., 2, 3)`` broadcast against
    the lines' leading axes.
    """
    a = _apply2x2(mat23[..., :2, :2], p1(lines)) + mat23[..., :2, 2]
    b = _apply2x2(mat23[..., :2, :2], p2(lines)) + mat23[..., :2, 2]
    return jnp.concatenate([a, b], axis=-1)


@jax.jit
def translate(lines: jax.Array, translation: jax.Array) -> jax.Array:
    """Translate a line array by a 2-vector.  Reference ``core/math.h:352-354``."""
    translation = jnp.asarray(translation, dtype=lines.dtype)
    return lines + jnp.concatenate([translation, translation], axis=-1)


@jax.jit
def rotate(lines: jax.Array, rot: jax.Array, rot_point: jax.Array | None = None) -> jax.Array:
    """Rotate a line array by a 2x2 matrix, optionally about a point.

    Reference ``core/math.h:362-378``.
    """
    if rot_point is None:
        a = _apply2x2(rot, p1(lines))
        b = _apply2x2(rot, p2(lines))
        return jnp.concatenate([a, b], axis=-1)
    rot_point = jnp.asarray(rot_point, dtype=jnp.float32)
    t = rot_point - _apply2x2(rot, rot_point)
    mat = jnp.concatenate([rot, t[:, None]], axis=-1)
    return transform(lines, mat)


@jax.jit
def align(alignment_line: jax.Array, ref_line: jax.Array) -> jax.Array:
    """The two rigid transforms aligning ``alignment_line`` onto ``ref_line``.

    Returns ``(..., 2, 2, 3)``: both polarities (the aligned line may point
    either way along the reference line).  Closed form of reference
    ``core/math.h:387-406``: rotation from the two unit directions, then a
    translation matching midpoints.

    Batched: both inputs may carry identical leading axes ``(..., 4)``.
    """
    td = normalize(alignment_line)  # tmpl_d
    ad = normalize(ref_line)        # align_d
    cos = _pmul(ad[..., 0], td[..., 0]) + _pmul(ad[..., 1], td[..., 1])
    sin = _pmul(ad[..., 1], td[..., 0]) - _pmul(ad[..., 0], td[..., 1])

    def mk(c, s):
        rot = jnp.stack([jnp.stack([c, -s], axis=-1),
                         jnp.stack([s, c], axis=-1)], axis=-2)  # (...,2,2)
        center_a = get_center(alignment_line)
        rotated_center = _apply2x2(rot, center_a)
        t = get_center(ref_line) - rotated_center
        return jnp.concatenate([rot, t[..., :, None]], axis=-1)  # (...,2,3)

    m1 = mk(cos, sin)
    m2 = mk(-cos, -sin)
    return jnp.stack([m1, m2], axis=-3)


@jax.jit
def combine(a, b) -> jax.Array:
    """Compose a 2x3 transform with a translation.

    ``combine(mat23, translation)``: translation applied *before* the
    transform (reference ``core/math.h:414-419``).
    ``combine(translation, mat23)``: translation applied *after* (reference
    ``core/math.h:427-432``).  Dispatch follows trailing shape.
    """
    a = jnp.asarray(a, dtype=jnp.float32)
    b = jnp.asarray(b, dtype=jnp.float32)
    if a.shape[-1] == 3 and a.ndim >= 2 and a.shape[-2] == 2:  # (mat, translation)
        rot = a[..., :2, :2]
        t = a[..., :2, 2] + _apply2x2(rot, b)
        return jnp.concatenate([rot, t[..., :, None]], axis=-1)
    # (translation, mat)
    rot = b[..., :2, :2]
    t = b[..., :2, 2] + a
    return jnp.concatenate([rot, t[..., :, None]], axis=-1)


@jax.jit
def minmax_point(lines: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Min and max corner of the bounding box over all endpoints.

    Reference ``core/math.h:166-171``.  Returns ``(min_point, max_point)``
    each of shape ``(..., 2)`` reduced over the line axis (axis ``-2``).
    """
    pts = lines.reshape(*lines.shape[:-1], 2, 2)  # (..., N, 2 endpoints, 2)
    mn = jnp.min(pts, axis=(-3, -2))
    mx = jnp.max(pts, axis=(-3, -2))
    return mn, mx


# ----------------------------------------------------------------------------
# Angle utilities — reference core/math.h:182-272
# ----------------------------------------------------------------------------

@jax.jit
def constrain_half_angle(x: jax.Array) -> jax.Array:
    """Wrap angle(s) to ``[-pi/2, pi/2)``.  Reference ``core/math.h:218-223``."""
    x = jnp.asarray(x)
    y = jnp.fmod(x + HALF_PI, PI)
    y = y + PI * (y < 0)
    return y - HALF_PI


@jax.jit
def constrain_angle(x: jax.Array) -> jax.Array:
    """Wrap angle(s) to ``[-pi, pi)``.  Reference ``core/math.h:244-249``."""
    x = jnp.asarray(x)
    y = jnp.fmod(x + PI, 2 * PI)
    y = y + 2 * PI * (y < 0)
    return y - PI


def wrap_max(x, mx):
    """Reference ``core/math.h:264-267``."""
    return jnp.fmod(mx + jnp.fmod(x, mx), mx)


def wrap_min_max(x, mn, mx):
    """Reference ``core/math.h:269-272``."""
    return mn + wrap_max(x - mn, mx - mn)


@jax.jit
def relatively_equal(a, b, rtol=1e-10, atol=1.1920929e-07) -> jax.Array:
    """Reference ``core/math.h:183-188`` (default atol = f32 epsilon)."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    return jnp.abs(a - b) <= atol + rtol * jnp.maximum(jnp.abs(a), jnp.abs(b))


def all_close(a, b, rtol=0.0, atol=1e-5) -> bool:
    """Reference ``core/math.h:203-208``."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    return bool(jnp.all(jnp.abs(a - b) <= (atol + rtol * jnp.abs(b))))
