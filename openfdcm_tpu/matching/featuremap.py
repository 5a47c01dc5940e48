"""DT3 feature map: an orientation-indexed bank of line-integral'd distance
transforms, as one dense ``f32[depth, H, W]`` tensor.

Accelerator redesign of the reference's ``Dt3Cpu`` (``matching/featuremaps/dt3cpu.h``,
``src/featuremaps/dt3cpu.cpp``), which stores a ``std::map<angle, image>`` and
fans the per-angle DTs out on a thread pool.  Here the whole bank is a single
stacked tensor; the per-angle DTs run as one vmapped seed-min kernel, the
circular orientation propagation is a short sequential min-plus pass over the
depth axis, and the per-slice directional line integral is the shear-cumsum
from :mod:`openfdcm_tpu.core.integral`.

Build steps (reference ``dt3cpu.h:174-234``):
  1. shift the scene into a square positive canvas,
  2. depth evenly-spaced angles ``i*pi/depth - pi/2``,
  3. classify scene lines to the circularly-nearest angle; per-angle DT of
     only that angle's lines,
  4. propagate min across orientations (1.5 forward + 1.5 backward cycles of
     ``img[c] = min(img[c], img[c-1] + coeff*dtheta)``),
  5. in-place line integral of each slice along its own angle.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import geometry as geo
from ..core import draw, integral
from ..core.dt import dt_from_indicator
from ..core.types import Distance, F32_MAX


@dataclasses.dataclass(frozen=True)
class Dt3Params:
    """Reference ``Dt3CpuParameters`` (``dt3cpu.h:34-42``) + distance
    (the Python binding's ``PyDt3CpuParameters``, ``python/src/matching.cpp:51-60``)."""
    depth: int = 30
    dt3_coeff: float = 5.0
    padding: float = 2.2
    distance: Distance = Distance.L2


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Dt3Featuremap:
    """The built feature map.

    ``dt3``: ``f32[depth, H, W]`` (physical H/W may exceed the logical
    ``feature_size`` for tile alignment; the logical region is bit-exact).
    ``angles``: ``f32[depth]`` sorted ascending.
    ``scene_translation``: the shift applied to the scene (``dt3cpu.h:55-60``).
    ``feature_size``: logical ``(width, height)`` — the reference ``Size``.
    """
    dt3: jax.Array
    angles: jax.Array
    scene_translation: jax.Array
    feature_size: tuple  # (width, height) static
    params: Dt3Params = dataclasses.field(default_factory=Dt3Params)

    def tree_flatten(self):
        return (self.dt3, self.angles, self.scene_translation), (self.feature_size, self.params)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, feature_size=aux[0], params=aux[1])

    @property
    def depth(self) -> int:
        return self.dt3.shape[0]

    def get_feature_size(self):
        return self.feature_size

    def get_scene_translation(self):
        return self.scene_translation


def save_featuremap(filepath: str, fm: Dt3Featuremap) -> None:
    """Persist a built DT3 feature map (the checkpoint analogue for this
    domain — prebuilt DT3 volumes are the only expensive state; SURVEY §5)."""
    np.savez_compressed(
        filepath,
        dt3=np.asarray(fm.dt3), angles=np.asarray(fm.angles),
        scene_translation=np.asarray(fm.scene_translation),
        feature_size=np.asarray(fm.feature_size, np.int64),
        params=np.asarray([fm.params.depth, fm.params.dt3_coeff,
                           fm.params.padding, int(fm.params.distance)],
                          np.float64))


def load_featuremap(filepath: str) -> Dt3Featuremap:
    """Load a feature map written by :func:`save_featuremap`."""
    z = np.load(filepath)
    p = z["params"]
    params = Dt3Params(int(p[0]), float(p[1]), float(p[2]), Distance(int(p[3])))
    return Dt3Featuremap(
        dt3=jnp.asarray(z["dt3"]), angles=jnp.asarray(z["angles"]),
        scene_translation=jnp.asarray(z["scene_translation"]),
        feature_size=(int(z["feature_size"][0]), int(z["feature_size"][1])),
        params=params)


def empty_featuremap(params: Dt3Params = Dt3Params()) -> Dt3Featuremap:
    """The reference's empty-scene result (``dt3cpu.h:180-181``)."""
    return Dt3Featuremap(
        dt3=jnp.zeros((0, 0, 0), jnp.float32),
        angles=jnp.zeros((0,), jnp.float32),
        scene_translation=jnp.zeros((2,), jnp.float32),
        feature_size=(0, 0),
        params=params,
    )


# ---------------------------------------------------------------------------
# Scene shift — reference dt3cpu.cpp:109-116
# ---------------------------------------------------------------------------

def scene_centered_translation(scene: np.ndarray, padding: float):
    """Returns ``(translation f32(2,), (width, height))``; all math in f32."""
    pts = np.asarray(scene, np.float32).reshape(-1, 2)
    min_pt = pts.min(axis=0)
    max_pt = pts.max(axis=0)
    ratio = np.float32(max(1.0, padding))
    required_max = ratio * np.float32((max_pt - min_pt).max()) * np.ones(2, np.float32)
    translation = required_max / np.float32(2) - (max_pt + min_pt) / np.float32(2)
    size = np.ceil(required_max + np.float32(1)).astype(np.int64)
    return translation, (int(size[0]), int(size[1]))


# ---------------------------------------------------------------------------
# Orientation classification — reference dt3cpu.h:93-134
# ---------------------------------------------------------------------------

def closest_orientation_idx(angles, theta):
    """Index of the map-nearest angle for each ``theta``.

    Emulates the reference's ``std::map`` search (``dt3cpu.h:93-114``):
    interior thetas pick the closer of the two bracketing angles (ties to the
    upper); thetas beyond either end compare circular distance to the first
    and last angle (ties and NaN to the last).

    Gather-free: the angle table is tiny, so the bracketing search is a
    compare-count and the table lookups are masked sums.
    """
    angles = jnp.asarray(angles)
    theta = jnp.asarray(theta)
    d = angles.shape[0]
    le = (angles <= theta[..., None])                   # (..., d)
    u = jnp.sum(le, axis=-1).astype(jnp.int32)          # searchsorted 'right'
    interior = (u > 0) & (u < d)
    lo = jnp.clip(u - 1, 0, d - 1)
    hi = jnp.clip(u, 0, d - 1)
    ar = jnp.arange(d)
    a_lo = jnp.sum(jnp.where(ar == lo[..., None], angles, 0.0), axis=-1)
    a_hi = jnp.sum(jnp.where(ar == hi[..., None], angles, 0.0), axis=-1)
    pick_lo = jnp.abs(theta - a_lo) < jnp.abs(theta - a_hi)
    interior_idx = jnp.where(pick_lo, lo, hi)
    a1 = theta - angles[0]
    a2 = theta - angles[d - 1]
    pick_first = jnp.minimum(a1, jnp.abs(a1 - math.pi)) < jnp.minimum(a2, jnp.abs(a2 - math.pi))
    boundary_idx = jnp.where(pick_first, 0, d - 1)
    return jnp.where(interior, interior_idx, boundary_idx)


def _classify_theta_np(theta: float, angles: np.ndarray) -> int:
    """Scalar nearest-angle classification in numpy f32 — the authoritative
    host semantics (identical to ``tests/oracle.py`` / ``dt3cpu.h:93-114``)
    that :func:`orientation_ratio_splits` inverts into ratio space."""
    theta = np.float32(theta)
    d = len(angles)
    u = int(np.sum(angles <= theta))
    if 0 < u < d:
        lo, hi = u - 1, u
        return lo if abs(theta - angles[lo]) < abs(theta - angles[hi]) else hi
    a1 = theta - angles[0]
    a2 = theta - angles[d - 1]
    if min(a1, abs(a1 - np.pi)) < min(a2, abs(a2 - np.pi)):
        return 0
    return d - 1


def _f32_ord(x) -> int:
    """Total-order key of a float32 (monotone int; NaN excluded):
    positives map above 2^31, negatives mirror below (-0.0 just under
    +0.0)."""
    b = int(np.float32(x).view(np.int32))
    return (b + 0x80000000) if b >= 0 else ~b


def _f32_unord(o: int) -> np.float32:
    b = (o - 0x80000000) if o >= 0x80000000 else ~o
    return np.int32(b).view(np.float32)


@lru_cache(maxsize=None)
def orientation_ratio_splits(depth: int):
    """f32 thresholds turning nearest-angle classification into pure
    ratio (``dy/dx``) comparisons — ``(splits (depth-1,), wrap)``.

    WHY (r4 golden regression, VERDICT r5 #1): the production paths used
    to classify candidate lines via ``atan(dy/dx)`` and
    :func:`closest_orientation_idx`.  ``atan`` is a backend-dependent
    approximation — two XLA backends were observed to disagree by up to
    ~2e-5 rad — so a line whose angle sits within that window of a slice
    midpoint classifies DIFFERENTLY per backend (obj_02/scene_3 tmpl-74
    line 14: slice 20 on one, 19 on the other -> 1% score drift vs the
    committed goldens).  ``atan`` is strictly monotone on (-pi/2, pi/2), so
    nearest-angle-of-atan(r) is a step function of ``r`` itself; this
    precomputes the exact f32 step positions ONCE on the host (against
    the numpy-f32 oracle semantics) and the device then classifies with
    only IEEE-exact ops (divide + compare) — bit-identical on every
    backend, and bit-identical to ``tests/oracle.py``.

    Classification contract (``classify_lines``):
      ``r = dy / dx``  (f32 division, both endpoints' order preserved)
      ``idx = sum(r >= splits)``; ``r >= wrap -> 0``; ``NaN -> depth-1``.
    """
    angles = make_angles(depth)

    def cls(r) -> int:
        with np.errstate(all="ignore"):
            return _classify_theta_np(np.arctan(np.float32(r)), angles)

    assert cls(-np.inf) == 0 and cls(np.inf) == 0, "wrap structure"

    def bisect(lo_o, hi_o, pred):
        """Smallest ordered-f32 key in (lo_o, hi_o] whose pred is True;
        pred must be monotone (False then True) on the range."""
        while hi_o - lo_o > 1:
            mid = (lo_o + hi_o) // 2
            if pred(_f32_unord(mid)):
                hi_o = mid
            else:
                lo_o = mid
        return hi_o

    lo = _f32_ord(-np.inf)
    top = _f32_ord(np.inf)
    splits = []
    for i in range(1, depth):
        # threshold i lives between tan(angles[i-1]) and tan(angles[i]);
        # use the previous split as the left edge (classification is
        # monotone 0..depth-1 below the wrap point)
        hi = _f32_ord(np.float32(np.tan(np.float64(angles[i])
                                        + np.pi / (4 * depth))))
        while cls(_f32_unord(hi)) < i:        # widen if the guess is short
            hi = min(top, hi + (hi - lo))
        o = bisect(lo, hi, lambda r, i=i: cls(r) >= i)
        splits.append(_f32_unord(o))
        lo = o
    wrap_o = bisect(lo, top, lambda r: cls(r) == 0)
    wrap = _f32_unord(wrap_o)

    # verify the table against the scalar oracle around every threshold
    # and at the specials — the monotone-step assumption must hold exactly
    probes = [np.float32(0), np.float32(np.inf), np.float32(-np.inf)]
    for t in splits + [wrap]:
        o = _f32_ord(t)
        probes += [_f32_unord(max(_f32_ord(-np.inf), o - k)) for k in range(3)]
        probes += [_f32_unord(min(top, o + k)) for k in range(1, 3)]
    sp = np.asarray(splits, np.float32)
    for r in probes:
        table = 0 if r >= wrap else int(np.sum(r >= sp))
        want = cls(r)
        assert table == want, (float(r), table, want)
    return tuple(float(s) for s in splits), float(wrap)


def classify_lines(angles, lines: jax.Array) -> jax.Array:
    """Orientation-slice index per line (``..., 4`` lines -> ``...`` int32),
    reference nearest-angle semantics (``dt3cpu.h:93-134`` with
    ``theta = atan(dy/dx)``, ``core/math.h:295-299``) evaluated in tangent-
    ratio space so the result is bit-identical across backends — see
    :func:`orientation_ratio_splits`.

    ``angles`` must be the standard bank ``make_angles(depth)`` (always
    true in production: the reference hardcodes the same formula,
    ``dt3cpu.h:188-190``); only its static length is read here.
    """
    depth = int(jnp.shape(angles)[0])
    splits, wrap = orientation_ratio_splits(depth)
    sp = jnp.asarray(np.asarray(splits, np.float32))
    d = lines[..., 2:4] - lines[..., 0:2]
    r = geo.div_cr(d[..., 1], d[..., 0])
    base = jnp.sum((r[..., None] >= sp).astype(jnp.int32), axis=-1)
    idx = jnp.where(r >= jnp.float32(wrap), 0, base)
    return jnp.where(jnp.isnan(r), depth - 1, idx)


def make_angles(depth: int) -> np.ndarray:
    """``i*pi/depth - pi/2`` in f32, ascending.  Reference ``dt3cpu.h:188-190``."""
    i = np.arange(depth, dtype=np.float32)
    return (i * np.float32(math.pi) / np.float32(depth) - np.float32(math.pi / 2)).astype(np.float32)


# ---------------------------------------------------------------------------
# Orientation propagation — reference dt3cpu.cpp:77-107
# ---------------------------------------------------------------------------

def propagation_weights(angles: np.ndarray, coeff: float) -> np.ndarray:
    """Closed-form circular propagation weights ``Wmat[src, dst]``.

    The reference's 1.5-cycle forward + backward relaxation
    (``dt3cpu.cpp:77-107``) computes, exactly, the min-plus closure over the
    cyclic slice graph with adjacent weights
    ``coeff * min(|da|, |da - pi|)``.  ``Wmat[src, dst]`` is the cheaper of
    the clockwise / counter-clockwise cumulative step sums (f32, sequential
    accumulation like the reference's repeated adds — equal to within f32
    rounding of the step order).
    """
    m = len(angles)
    a = np.asarray(angles, np.float32)
    step_fwd = np.empty(m, np.float32)  # weight of edge j -> (j+1) % m
    for j in range(m):
        h = np.abs(np.float32(a[j]) - np.float32(a[(j + 1) % m]))
        step_fwd[j] = np.float32(coeff) * np.minimum(h, np.abs(h - np.float32(math.pi)))
    wmat = np.zeros((m, m), np.float32)
    for src in range(m):
        cw = np.float32(0)
        cws = np.zeros(m, np.float32)
        for k in range(1, m):
            cw = np.float32(cw + step_fwd[(src + k - 1) % m])
            cws[(src + k) % m] = cw
        ccw = np.float32(0)
        ccws = np.zeros(m, np.float32)
        for k in range(1, m):
            ccw = np.float32(ccw + step_fwd[(src - k) % m])
            ccws[(src - k) % m] = ccw
        full = np.minimum(cws, ccws)
        full[src] = 0.0
        wmat[src] = full
    return wmat


@jax.jit
def propagate_orientation(dt3: jax.Array, wmat: jax.Array) -> jax.Array:
    """Min-plus propagation across the orientation axis:
    ``out[s] = min_src dt3[src] + wmat[src, s]`` — a scan over sources with a
    running elementwise min (memory-bound, no sequential slice updates)."""
    def step(carry, inp):
        src_img, w_row = inp  # (H, W), (m,)
        return jnp.minimum(carry, src_img[None] + w_row[:, None, None]), None
    init = jnp.full_like(dt3, jnp.inf)
    out, _ = jax.lax.scan(step, init, (dt3, wmat))
    return out


def propagation_steps(angles, coeff: float):
    """The reference's relaxation schedule (``dt3cpu.cpp:86-107``): 1.5
    forward + 1.5 backward cycles of ``(src, dst, weight)`` edges with
    ``weight = coeff * min(|da|, |da - pi|)`` in f32."""
    m = len(angles)
    a = np.asarray(angles, np.float32)
    out = []

    def add(c, step):
        c1 = (m + ((c - step) % m)) % m
        c2 = (m + (c % m)) % m
        h = np.float32(abs(np.float32(a[c1]) - np.float32(a[c2])))
        w = np.float32(coeff) * np.minimum(h, np.abs(h - np.float32(math.pi)))
        out.append((c1, c2, float(w)))

    for c in range(0, int(math.ceil(1.5 * m))):
        add(c, 1)
    c = m
    end = -int(math.floor(1.5 * m))
    while c != end:
        add(c, -1)
        c -= 1
    return tuple(out)


def propagate_orientation_relax(dt3: jax.Array, steps) -> jax.Array:
    """Reference-order sequential relaxation across the orientation axis
    (``dt3cpu.cpp:77-107``): the 3·depth min-add steps unrolled in order
    (bit-faithful update order; XLA fuses the elementwise chain).

    ``dt3``: ``(..., D, H, W)``; ``steps`` from :func:`propagation_steps`.
    """
    d = dt3.shape[-3]
    sl = [dt3[..., i, :, :] for i in range(d)]
    for c1, c2, w in steps:
        sl[c2] = jnp.minimum(sl[c2], sl[c1] + jnp.float32(w))
    return jnp.stack(sl, axis=-3)


# ---------------------------------------------------------------------------
# Featuremap build
# ---------------------------------------------------------------------------

def build_featuremap(scene, params: Dt3Params = Dt3Params(),
                     pad_to: int | None = 128) -> Dt3Featuremap:
    """Build the DT3 feature map of a scene.  Reference ``dt3cpu.h:174-234``.

    ``scene`` is host data (``(N, 4)`` or the reference's ``(4, N)``).
    ``pad_to``: optionally round the *physical* canvas up to a multiple for
    tile alignment / compilation-cache friendliness; the logical region and
    all lookups are unaffected (padding lives on the trailing side of every
    sweep).  With the default (128) scenes of similar size share compiled
    programs.
    """
    scene = geo.as_lines_np(scene)
    if scene.shape[0] == 0:
        return empty_featuremap(params)

    translation, (w, h) = scene_centered_translation(scene, params.padding)
    translated = scene + np.concatenate([translation, translation]).astype(np.float32)

    angles = make_angles(params.depth)

    ph = pw = None
    if pad_to:
        ph = -(-h // pad_to) * pad_to
        pw = -(-w // pad_to) * pad_to
    else:
        ph, pw = h, w

    # Pad the line count to a bucket; everything else is one device dispatch.
    n_real = translated.shape[0]
    n_bucket = -(-n_real // 128) * 128
    tpad = np.concatenate(
        [translated, np.zeros((n_bucket - n_real, 4), np.float32)])
    real_mask = np.zeros(n_bucket, bool)
    real_mask[:n_real] = True

    dt3 = _featuremap_device(
        jnp.asarray(tpad), jnp.asarray(real_mask),
        jnp.asarray([h, w], jnp.int32),
        depth=params.depth, phys_h=ph, phys_w=pw, metric=params.distance,
        angles=tuple(float(a) for a in angles), coeff=float(params.dt3_coeff))

    return Dt3Featuremap(
        dt3=dt3,
        angles=jnp.asarray(angles),
        scene_translation=jnp.asarray(translation),
        feature_size=(w, h),
        params=params,
    )


def _indicator(lines, line_mask, logical_hw, *, depth, phys_h, phys_w,
               max_points):
    """Orientation classify + clip/rasterize + seed scatter: the DT3 seed
    indicator stack ``(depth, PH, PW)`` for one scene."""
    angle_arr = jnp.asarray(make_angles(depth))
    slice_of_line = classify_lines(angle_arr, lines)

    lhw = logical_hw.astype(jnp.float32)
    box = jnp.stack([jnp.zeros((), jnp.float32), lhw[1] - 1.0,
                     jnp.zeros((), jnp.float32), lhw[0] - 1.0])
    pts, pmask = draw.seed_points_box(lines, box, max_points)   # (N,P,2),(N,P)
    pmask = pmask & line_mask[:, None]

    s = jnp.broadcast_to(slice_of_line[:, None], pmask.shape)
    flat_idx = (s.astype(jnp.int32) * (phys_h * phys_w)
                + pts[..., 1] * phys_w + pts[..., 0])
    flat_idx = jnp.where(pmask, flat_idx, depth * phys_h * phys_w)
    ind = jnp.full((depth * phys_h * phys_w,), F32_MAX, jnp.float32)
    ind = ind.at[flat_idx.reshape(-1)].set(0.0, mode="drop")
    return ind.reshape(depth, phys_h, phys_w)


def _indicator_batch(lines, line_mask, logical_hw, *, depth, phys_h, phys_w,
                     max_points, points_cap=None):
    """Batched :func:`_indicator` over a scene axis with COMPACTED scatter.

    Scatter cost scales with the number of indices, and the padded
    ``(S, N, P)`` point grid is mostly masked slots (lines are far shorter
    than the canvas-diagonal ``max_points`` bound), about 10x the real
    seeds.  Sorting the flat
    index stream (masked slots carry an out-of-range key that sorts last)
    and truncating at ``points_cap`` (a static host-computed upper bound on
    the REAL point count: clipping only shrinks spans) keeps the scatter at
    the real seed count.  Bit-exact: the dropped slots never scattered
    anything, and the scatter value is a constant 0.0 so reordering is
    immaterial.

    ``lines``/``line_mask``/``logical_hw``: ``(S, N, 4)/(S, N)/(S, 2)``.
    Returns ``(S, depth, phys_h, phys_w)``.
    """
    s = lines.shape[0]
    angle_arr = jnp.asarray(make_angles(depth))

    def one(lines_i, mask_i, lhw_i):
        slice_of_line = classify_lines(angle_arr, lines_i)
        lhw = lhw_i.astype(jnp.float32)
        box = jnp.stack([jnp.zeros((), jnp.float32), lhw[1] - 1.0,
                         jnp.zeros((), jnp.float32), lhw[0] - 1.0])
        pts, pmask = draw.seed_points_box(lines_i, box, max_points)
        pmask = pmask & mask_i[:, None]
        sl = jnp.broadcast_to(slice_of_line[:, None], pmask.shape)
        flat = (sl.astype(jnp.int32) * (phys_h * phys_w)
                + pts[..., 1] * phys_w + pts[..., 0])
        return flat, pmask

    flat, pmask = jax.vmap(one)(lines, line_mask, logical_hw)   # (S, N, P)
    per_scene = depth * phys_h * phys_w
    oob = s * per_scene
    offs = (jnp.arange(s, dtype=jnp.int32) * per_scene)[:, None, None]
    flat = jnp.where(pmask, flat + offs, oob).reshape(-1)
    if points_cap is not None and points_cap < flat.shape[0]:
        flat = jax.lax.sort(flat)[:points_cap]
    ind = jnp.full((oob,), F32_MAX, jnp.float32)
    ind = ind.at[flat].set(0.0, mode="drop")
    return ind.reshape(s, depth, phys_h, phys_w)


def _logical_mask(logical_hw, phys_h, phys_w):
    ys = jnp.arange(phys_h)[:, None]
    xs = jnp.arange(phys_w)[None, :]
    return (ys < logical_hw[0]) & (xs < logical_hw[1])


@partial(jax.jit, static_argnames=("depth", "phys_h", "phys_w", "metric",
                                   "angles", "coeff"))
def _featuremap_device(lines, line_mask, logical_hw, *,
                       depth, phys_h, phys_w, metric, angles, coeff):
    """The whole DT3 build as ONE device dispatch: orientation classify ->
    seed scatter -> separable exact DT -> orientation propagation ->
    directional line integral."""
    ind = _indicator(lines, line_mask, logical_hw, depth=depth,
                     phys_h=phys_h, phys_w=phys_w,
                     max_points=max(phys_h, phys_w))
    dt3 = dt_from_indicator(ind, metric=metric)
    dt3 = jnp.where(_logical_mask(logical_hw, phys_h, phys_w)[None], dt3, 0.0)
    dt3 = propagate_orientation_relax(dt3, propagation_steps(angles, coeff))
    return integral.line_integral_stack(dt3, list(angles), logical_hw=logical_hw)


# ---------------------------------------------------------------------------
# minmaxTranslation — reference dt3cpu.cpp:30-75
# ---------------------------------------------------------------------------

def minmax_translation(featuremap: Dt3Featuremap, tmpl: jax.Array, align_vec: jax.Array,
                       line_mask: jax.Array | None = None):
    """Legal ``[min_mul, max_mul]`` step multipliers along ``align_vec``.

    Vectorizable closed form of the reference: intersect the template bbox's
    movement ray with the four image borders.  Returns ``(neg, pos)`` floats;
    ``(inf, inf)`` for a null align vector, ``(nan, nan)`` if the template
    already exceeds bounds.
    """
    w, h = featuremap.feature_size
    return minmax_translation_raw(tmpl, align_vec, (float(w), float(h)),
                                  featuremap.scene_translation, line_mask)


def minmax_translation_raw(tmpl: jax.Array, align_vec: jax.Array, size_wh,
                           extra_translation, line_mask: jax.Array | None = None):
    """Core formula; ``tmpl``: ``(..., L, 4)``, ``align_vec``: ``(..., 2)``."""
    size = jnp.asarray(size_wh, jnp.float32)
    pts = tmpl.reshape(*tmpl.shape[:-1], 2, 2)
    if line_mask is not None:
        big = jnp.where(line_mask[..., None, None], pts, jnp.inf)
        small = jnp.where(line_mask[..., None, None], pts, -jnp.inf)
        min_pt = jnp.min(big, axis=(-3, -2))
        max_pt = jnp.max(small, axis=(-3, -2))
    else:
        min_pt = jnp.min(pts, axis=(-3, -2))
        max_pt = jnp.max(pts, axis=(-3, -2))
    min_pt = min_pt + extra_translation
    max_pt = max_pt + extra_translation

    oob = jnp.any((size - 1 - max_pt) < 0, axis=-1) | jnp.any(min_pt < 0, axis=-1)

    # (..., 2 axes, 4 candidates)
    mult = jnp.stack([-max_pt, -min_pt, size - max_pt - 1.0, size - min_pt - 1.0], axis=-1)
    mult = geo.div_cr(mult, align_vec[..., None])   # walk bounds: trunc() flips on 1-ulp backend divide skew
    negative = jnp.signbit(mult)
    pos_c = jnp.where(negative, jnp.inf, mult)
    neg_c = jnp.where(negative, mult, -jnp.inf)

    def nanmax(x, axis):
        return jnp.where(jnp.any(jnp.isnan(x), axis=axis), jnp.nan, jnp.max(x, axis=axis))

    def nanmin(x, axis):
        return jnp.where(jnp.any(jnp.isnan(x), axis=axis), jnp.nan, jnp.min(x, axis=axis))

    neg_ax = nanmax(neg_c, -1)   # (..., 2) per-axis negative bound
    pos_ax = nanmin(pos_c, -1)   # (..., 2) per-axis positive bound

    both_finite = jnp.isfinite(neg_ax).all(axis=-1) & jnp.isfinite(pos_ax).all(axis=-1)
    x_finite = jnp.isfinite(neg_ax[..., 0]) & jnp.isfinite(pos_ax[..., 0])

    neg = jnp.where(both_finite, jnp.max(neg_ax, axis=-1),
                    jnp.where(x_finite, neg_ax[..., 0], neg_ax[..., 1]))
    pos = jnp.where(both_finite, jnp.min(pos_ax, axis=-1),
                    jnp.where(x_finite, pos_ax[..., 0], pos_ax[..., 1]))

    null_vec = jnp.all(jnp.abs(align_vec) <= 1e-5, axis=-1)
    neg = jnp.where(null_vec, jnp.inf, jnp.where(oob, jnp.nan, neg))
    pos = jnp.where(null_vec, jnp.inf, jnp.where(oob, jnp.nan, pos))
    return neg, pos


# ---------------------------------------------------------------------------
# evaluate — reference dt3cpu.cpp:126-179
# ---------------------------------------------------------------------------

def evaluate_batched(dt3_flat: jax.Array, hw: tuple, slice_idx: jax.Array,
                     endpoints: jax.Array, line_mask: jax.Array,
                     translations: jax.Array, take_fn=None) -> jax.Array:
    """Batched FDCM scoring.

    ``dt3_flat``: ``f32[D*H*W]`` flattened feature bank (physical H/W).
    ``slice_idx``: ``(..., L)`` orientation slice per line.
    ``endpoints``: ``(..., L, 2, 2)`` float endpoints (pre scene-translation).
    ``translations``: ``(..., K, 2)`` translations to score (these already
    include the scene translation).
    Returns scores ``(..., K)``: per translation, sum over lines of
    ``|dt3[o, y2, x2] - dt3[o, y1, x1]|`` with int-truncated coordinates.

    Layout note: all big intermediates are arranged ``(2, L, B*K)`` so the
    *large* flattened candidate-x-step axis fills whole 128-lane vregs — a
    trailing axis of K (e.g. 11 steps) would waste 11/128 of every vector op
    and gather issue, and a trailing size-2 axis would pad 64x in memory.
    """
    h, w = hw
    lead = endpoints.shape[:-3]
    l = endpoints.shape[-3]
    k = translations.shape[-2]
    b = int(np.prod(lead)) if lead else 1
    ep = endpoints.reshape(b, l, 2, 2)
    tr = translations.reshape(b * k, 2)
    si = slice_idx.reshape(b, l)
    lm = line_mask.reshape(b, l)

    ex = jnp.repeat(jnp.transpose(ep[..., 0], (2, 1, 0)), k, axis=-1)  # (2,L,B*K)
    ey = jnp.repeat(jnp.transpose(ep[..., 1], (2, 1, 0)), k, axis=-1)
    xi = (ex + tr[:, 0][None, None]).astype(jnp.int32)                 # (2,L,B*K)
    yi = (ey + tr[:, 1][None, None]).astype(jnp.int32)
    base = jnp.repeat(jnp.transpose(si, (1, 0)), k, axis=-1)[None] * (h * w)
    # take_fn: pluggable probe gather (the spatially sharded search swaps
    # in an own-rows gather + psum; must replicate mode="clip" semantics)
    idx = base + yi * w + xi
    vals = (jnp.take(dt3_flat, idx, mode="clip") if take_fn is None
            else take_fn(dt3_flat, idx))                               # (2,L,B*K)
    per_line = jnp.abs(vals[0] - vals[1])                              # (L,B*K)
    lmr = jnp.repeat(jnp.transpose(lm, (1, 0)), k, axis=-1)
    scores = jnp.sum(per_line * lmr, axis=0)                           # (B*K,)
    return scores.reshape(*lead, k)


def evaluate(featuremap: Dt3Featuremap, templates, translations):
    """Reference-shaped entry: list of templates, list of per-template
    translation lists -> list of per-template score lists.
    (``featuremap.h:159`` / ``dt3cpu.cpp:126-179``.)

    All templates are padded to a shared (line, translation) bucket and
    scored in ONE device dispatch — the per-template loop the reference
    runs would pay a device round trip per template here."""
    if not templates:
        return []
    d, ph, pw = featuremap.dt3.shape
    flat = featuremap.dt3.reshape(-1)
    # zip semantics like the original per-template loop: extra templates
    # (or extra translation lists) beyond the shorter input are dropped.
    pairs = list(zip(templates, translations))
    tmpls = [geo.as_lines_np(t) for t, _ in pairs]
    trs_np = [np.asarray(tr, np.float32).reshape(-1, 2) for _, tr in pairs]
    n = len(tmpls)
    if n == 0:
        return []
    lmax = -(-max(max((t.shape[0] for t in tmpls), default=1), 1) // 4) * 4
    kmax = -(-max(max((t.shape[0] for t in trs_np), default=1), 1) // 4) * 4
    lines = np.zeros((n, lmax, 4), np.float32)
    mask = np.zeros((n, lmax), np.float32)
    trs = np.zeros((n, kmax, 2), np.float32)
    for i, (t, tr) in enumerate(zip(tmpls, trs_np)):
        lines[i, : t.shape[0]] = t
        mask[i, : t.shape[0]] = 1.0
        trs[i, : tr.shape[0]] = tr
    lines_d = jnp.asarray(lines)
    o = classify_lines(featuremap.angles, lines_d)        # (n, lmax)
    eps = lines_d.reshape(n, lmax, 2, 2)
    tr_d = jnp.asarray(trs) + featuremap.scene_translation
    scores = np.asarray(evaluate_batched(flat, (ph, pw), o, eps,
                                         jnp.asarray(mask), tr_d))
    return [[float(s) for s in scores[i, : trs_np[i].shape[0]]]
            for i in range(n)]
