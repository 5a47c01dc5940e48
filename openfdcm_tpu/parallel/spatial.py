"""Spatial (tile) sharding of a single DT3 volume across a device mesh.

SURVEY §2.4's tensor-parallel row: one scene whose ``[D, H, W]`` DT3 exceeds
a single device's memory is built with the **rows axis H sharded** across a
mesh axis.  The reference has no analogue — its whole DT3 lives in one
process's RAM (``matching/featuremaps/dt3cpu.h:44``); this is the
accelerator scale-out of the same container.

Exactness strategy (validated bit-equal against the unsharded build in
``tests/test_spatial.py``):

* **seed scatter / masks / orientation propagation** — elementwise or
  row-local: each device computes its row block with global row indices.
* **EDT column pass** (vertical ``cummin`` along the *sharded* axis) — min is
  associative, so each device computes its local cummin and combines it with
  a carry of per-block minima obtained by one ``all_gather`` of ``(D, W)``
  block aggregates + a masked prefix/suffix min.  All values are exact f32
  integers, so any association is bit-identical.
* **EDT row pass** — per-row math only; reuses ``core.dt.row_pass`` verbatim.
* **directional line integral** — an f32 *sum* scan whose nesting cannot be
  re-associated without bit drift, so block carries propagate through a
  sequential **wavefront**: device ``b`` runs its block scan only after
  receiving the physical carry from the sweep-previous block via
  ``ppermute`` (one hop per block, ``lax.cond``-gated so each device scans
  once).  x-major sweeps (scan along the unsharded W axis, carry shifting
  along sharded H) are resharded to W via ``all_to_all``, swept, and
  resharded back.

The result is the global ``[D, H, W]`` array sharded ``P(None, axis, None)``
— downstream scoring can keep it resident or gather it.
"""
from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..core import draw
from ..core import geometry as geo
from ..core.dt import row_pass
from ..core.integral import _group_geometry
from ..core.types import Distance, F32_MAX
from ..matching.featuremap import (
    Dt3Featuremap, Dt3Params, classify_lines, empty_featuremap,
    make_angles, propagation_steps, propagate_orientation_relax,
    scene_centered_translation,
)

__all__ = ["build_featuremap_spatial", "search_spatial"]


# ---------------------------------------------------------------------------
# Search against an H-sharded DT3 (no gather of the volume)
# ---------------------------------------------------------------------------

def _spatial_take(axis: str, h_loc: int, depth: int, phys_h: int,
                  phys_w: int):
    """Probe gather for a ``(D, h_loc, W)`` row block: replicate
    ``jnp.take(flat, idx, mode="clip")`` on the GLOBAL flat index, fetch
    owned rows locally, and ``psum`` so every device sees every value
    (0 + value + 0 ... sums exactly — scores stay bit-faithful)."""
    hw_full = phys_h * phys_w

    def take(dt3_local_flat, idx):
        p = jax.lax.axis_index(axis)
        y0 = p * h_loc
        idxc = jnp.clip(idx, 0, depth * hw_full - 1)
        s = idxc // hw_full
        rem = idxc - s * hw_full
        y = rem // phys_w
        x = rem - y * phys_w
        owned = (y >= y0) & (y < y0 + h_loc)
        lidx = s * (h_loc * phys_w) + (y - y0) * phys_w + x
        vals = jnp.take(dt3_local_flat, jnp.where(owned, lidx, 0),
                        mode="clip")
        vals = jnp.where(owned, vals, 0.0)
        return jax.lax.psum(vals, axis)

    return take


def search_spatial(searcher, optimizer, featuremap: Dt3Featuremap,
                   templates, scene, *, mesh: Mesh, axis: str = "rows"):
    """``matching.search`` against a DT3 whose H axis is sharded over
    ``mesh[axis]`` (e.g. from :func:`build_featuremap_spatial`) — the
    volume is never gathered; each device probes its own row block and one
    ``psum`` per window shares the values.  The walk state is replicated,
    so all devices run the lockstep chain algebra identically.

    Returns an UNSORTED ``list[Match]`` equal to the single-device
    ``search`` (scores from identical f32 ops on identical values).
    """
    from ..matching.match import Match, prepare_templates, _bucket, \
        _make_candidates
    from ..matching import optimize as opt
    from ..matching.pipeline import _bank_pairs_for_scene

    bank = templates if hasattr(templates, "lmax") else prepare_templates(templates)
    scene_arr = geo.as_lines_np(scene)
    if not bank.host or scene_arr.shape[0] == 0 or \
            featuremap.feature_size == (0, 0):
        return []
    pairs = _bank_pairs_for_scene(searcher, bank, scene_arr)
    if pairs.shape[0] == 0:
        return []
    p_real = pairs.shape[0]
    pb = _bucket(p_real, 64)
    pairs_padded = np.concatenate(
        [pairs, np.zeros((pb - p_real, 3), np.int32)])
    sb = _bucket(scene_arr.shape[0], 128)
    scene_padded = np.concatenate(
        [scene_arr, np.zeros((sb - scene_arr.shape[0], 4), np.float32)])

    mode, window = opt.optimizer_mode(optimizer)
    w, h = featuremap.feature_size
    dense_steps = opt.dense_step_count(optimizer, max(w, h))
    depth, ph, pw = featuremap.dt3.shape
    nblk = int(mesh.shape[axis])
    h_loc = ph // nblk
    feature_size = jnp.asarray([float(w), float(h)], jnp.float32)
    lmax = bank.lmax

    fn = _search_spatial_cached(
        mesh, axis, (("lmax", lmax), ("depth", depth), ("ph", ph),
                     ("pw", pw), ("h_loc", h_loc), ("mode", mode),
                     ("window", max(window, 1)),
                     ("dense_steps", dense_steps)))
    scores, mats, valid = fn(
        featuremap.dt3, bank.lines, bank.mask,
        jnp.asarray(pairs_padded[:, 0]), jnp.asarray(pairs_padded[:, 1]),
        jnp.asarray(pairs_padded[:, 2]), jnp.asarray(scene_padded),
        featuremap.angles, featuremap.scene_translation, feature_size)
    scores, valid, mats = (np.asarray(x) for x in (scores, valid, mats))
    matches = []
    for i in range(2 * p_real):
        if not valid[i]:
            continue
        matches.append(Match(int(pairs[i // 2, 0]), float(scores[i]),
                             mats[i].copy()))
    return matches


# ---------------------------------------------------------------------------
# Column pass with all-gathered block carries
# ---------------------------------------------------------------------------

def _column_pass_sharded(ind, y0, *, axis: str, nblk: int):
    """Vertical nearest-seed distance with H sharded.

    ``ind``: local ``(D, h_loc, W)`` seed indicator; ``y0``: first global row
    of this block.  Bit-equal to ``_nearest_1d_l1`` along the full column:
    the global cummin is the min of the local cummin and the min over all
    previous blocks' aggregates (min is associative; values are exact).
    """
    h_loc = ind.shape[1]
    y = (jnp.float32(y0) + jnp.arange(h_loc, dtype=jnp.float32))[None, :, None]
    a = ind - y
    b = ind + y
    fwd_loc = jax.lax.cummin(a, axis=1)
    bwd_loc = jax.lax.cummin(b, axis=1, reverse=True)

    gf = jax.lax.all_gather(fwd_loc[:, -1, :], axis)   # (P, D, W)
    gb = jax.lax.all_gather(bwd_loc[:, 0, :], axis)
    p = jax.lax.axis_index(axis)
    blk = jnp.arange(nblk)
    carry_f = jnp.min(jnp.where((blk < p)[:, None, None], gf, jnp.inf), axis=0)
    carry_b = jnp.min(jnp.where((blk > p)[:, None, None], gb, jnp.inf), axis=0)

    fwd = y + jnp.minimum(fwd_loc, carry_f[:, None, :])
    bwd = -y + jnp.minimum(bwd_loc, carry_b[:, None, :])
    return jnp.minimum(fwd, bwd)


# ---------------------------------------------------------------------------
# Line integral: wavefront block scans
# ---------------------------------------------------------------------------

def _scan_block(cols, dloc, init, *, flip: bool):
    """One device's sweep over its block, continuing from carry ``init``.

    ``cols``: ``(G, n_loc, M)`` sweep-position-major columns;
    ``dloc``: ``(G, n_loc)`` per-position deltas; ``init``: ``(G, M)``.
    Returns ``(final_carry (G, M), out (G, n_loc, M))`` — the same step
    algebra as ``core.integral._sweep_scan``, so chaining blocks in sweep
    order reproduces the unsharded scan bit-for-bit.
    """
    def one(cols1, d1, init1):
        def step(carry, inp):
            col, dd = inp
            down = jnp.concatenate([jnp.zeros_like(carry[:1]), carry[:-1]])
            up = jnp.concatenate([carry[1:], jnp.zeros_like(carry[:1])])
            shifted = jnp.where(dd == 1, down, jnp.where(dd == -1, up, carry))
            new = col + shifted
            return new, new
        return jax.lax.scan(step, init1, (cols1, d1), reverse=flip)
    return jax.vmap(one)(cols, dloc, init)


def _wavefront(cols, dloc, *, flip: bool, axis: str, nblk: int):
    """Chain ``_scan_block`` across devices in sweep order.

    Non-flip sweeps start at block 0; flipped sweeps are reverse scans, so
    they start at the last block.  Each round the active device scans
    (``lax.cond``-gated) and ships its final carry one hop via ``ppermute``.
    """
    g, n_loc, m = cols.shape
    p = jax.lax.axis_index(axis)
    order = list(range(nblk))[::-1] if flip else list(range(nblk))
    carry = jnp.zeros((g, m), jnp.float32)
    out = jnp.zeros_like(cols)
    for r, dev in enumerate(order):
        active = p == dev
        fc, ob = jax.lax.cond(
            active,
            lambda c: _scan_block(cols, dloc, c, flip=flip),
            lambda c: (c, jnp.zeros_like(cols)),
            carry)
        out = jnp.where(active, ob, out)
        if r + 1 < nblk:
            carry = jax.lax.ppermute(fc, axis, perm=[(dev, order[r + 1])])
    return out


def _dcol_global(dels_sub, flips_sub, flip_val: bool, n_log, n_phys: int):
    """Per-physical-position deltas, identical to the unsharded mapping in
    ``core.integral._line_integral_stack`` (flipped sweeps index position
    ``n_log-1-c``; padding positions get delta 0)."""
    dsub = jnp.asarray(dels_sub)
    if not flip_val:
        return dsub
    col = jnp.arange(n_phys)
    pidx = jnp.clip(n_log - 1 - col, 0, n_phys - 1)
    return jnp.where(col[None, :] < n_log, jnp.take(dsub, pidx, axis=1), 0)


def _line_integral_sharded(imgs, logical_hw, *, angles, axis: str, nblk: int):
    """Directional line integral of a local ``(D, h_loc, W)`` block stack.

    y-major sweeps scan the sharded H axis directly (wavefront); x-major
    sweeps reshard to W via tiled ``all_to_all``, sweep, and reshard back.
    """
    d, h_loc, w_loc_in = imgs.shape
    phys_h = h_loc * nblk
    phys_w = w_loc_in
    p = jax.lax.axis_index(axis)
    groups = _group_geometry(angles, {True: phys_w, False: phys_h})
    out = [None] * d
    for x_major, idxs, flips, dels in groups:
        n_log = logical_hw[1] if x_major else logical_hw[0]
        for flip_val in (False, True):
            sub = [k for k, f in enumerate(flips) if bool(f) == flip_val]
            if not sub:
                continue
            sub_idxs = [idxs[k] for k in sub]
            group = imgs[np.array(sub_idxs)]          # (G, h_loc, W) local
            if x_major:
                # reshard H-sharded -> W-sharded: (G, H, w_loc)
                grp = jax.lax.all_to_all(group, axis, split_axis=2,
                                         concat_axis=1, tiled=True)
                n_loc = phys_w // nblk
                dcol = _dcol_global(dels[np.array(sub)], flips, flip_val,
                                    n_log, phys_w)
                dloc = jax.lax.dynamic_slice_in_dim(dcol, p * n_loc, n_loc, 1)
                cols = jnp.swapaxes(grp, 1, 2)        # (G, w_loc, H)
                swept = _wavefront(cols, dloc, flip=flip_val, axis=axis,
                                   nblk=nblk)
                swept = jnp.swapaxes(swept, 1, 2)     # (G, H, w_loc)
                res = jax.lax.all_to_all(swept, axis, split_axis=1,
                                         concat_axis=2, tiled=True)
            else:
                # sweep along sharded H; carry (W,) shifts along local W
                n_loc = h_loc
                dcol = _dcol_global(dels[np.array(sub)], flips, flip_val,
                                    n_log, phys_h)
                dloc = jax.lax.dynamic_slice_in_dim(dcol, p * n_loc, n_loc, 1)
                res = _wavefront(group, dloc, flip=flip_val, axis=axis,
                                 nblk=nblk)
            for k, i in enumerate(sub_idxs):
                out[i] = res[k]
    return jnp.stack(out)


# ---------------------------------------------------------------------------
# The sharded build
# ---------------------------------------------------------------------------

def _local_build(lines, line_mask, logical_hw, *, depth, phys_h, phys_w,
                 metric, angles, coeff, axis, nblk):
    """Per-device program: all five build steps on one H block."""
    h_loc = phys_h // nblk
    p = jax.lax.axis_index(axis)
    y0 = p * h_loc

    # 1. classify + clip/rasterize (replicated inputs), scatter my rows
    angle_arr = jnp.asarray(np.asarray(angles, np.float32))
    slice_of_line = classify_lines(angle_arr, lines)
    lhw = logical_hw.astype(jnp.float32)
    box = jnp.stack([jnp.zeros((), jnp.float32), lhw[1] - 1.0,
                     jnp.zeros((), jnp.float32), lhw[0] - 1.0])
    pts, pmask = draw.seed_points_box(lines, box, max(phys_h, phys_w))
    pmask = pmask & line_mask[:, None]
    yg = pts[..., 1]
    inblk = pmask & (yg >= y0) & (yg < y0 + h_loc)
    s = jnp.broadcast_to(slice_of_line[:, None], pmask.shape)
    flat_idx = (s.astype(jnp.int32) * (h_loc * phys_w)
                + (yg - y0) * phys_w + pts[..., 0])
    flat_idx = jnp.where(inblk, flat_idx, depth * h_loc * phys_w)
    ind = jnp.full((depth * h_loc * phys_w,), F32_MAX, jnp.float32)
    ind = ind.at[flat_idx.reshape(-1)].set(0.0, mode="drop")
    ind = ind.reshape(depth, h_loc, phys_w)

    # 2-3. exact DT: sharded column pass, local row pass
    g = _column_pass_sharded(ind, y0, axis=axis, nblk=nblk)
    dt3 = row_pass(g, metric=metric)

    # 4. zero outside the logical region (global row indices)
    ys = (y0 + jnp.arange(h_loc))[:, None]
    xs = jnp.arange(phys_w)[None, :]
    dt3 = jnp.where(((ys < logical_hw[0]) & (xs < logical_hw[1]))[None], dt3, 0.0)

    # 5. orientation propagation (elementwise across depth — local)
    dt3 = propagate_orientation_relax(dt3, propagation_steps(angles, coeff))

    # 6. directional line integral (wavefront / resharded sweeps)
    return _line_integral_sharded(dt3, logical_hw, angles=angles,
                                  axis=axis, nblk=nblk)


def build_featuremap_spatial(scene, params: Dt3Params = Dt3Params(), *,
                             mesh: Mesh, axis: str = "rows",
                             pad_to: int | None = 128) -> Dt3Featuremap:
    """Build a DT3 feature map with its H axis sharded over ``mesh[axis]``.

    Logical values are bit-equal to :func:`matching.featuremap.build_featuremap`
    (pinned by ``tests/test_spatial.py``); the returned ``dt3`` is a global
    ``[D, H, W]`` array sharded ``P(None, axis, None)``, so a volume that
    exceeds one device's memory can be built and kept resident across the mesh.
    Physical H/W are rounded up so both divide the mesh axis size.
    """
    scene = geo.as_lines_np(scene)
    if scene.shape[0] == 0:
        return empty_featuremap(params)
    nblk = int(mesh.shape[axis])

    translation, (w, h) = scene_centered_translation(scene, params.padding)
    translated = scene + np.concatenate([translation, translation]).astype(np.float32)
    angles = make_angles(params.depth)

    unit = int(pad_to) if pad_to else 1
    if unit % nblk:
        unit *= nblk // np.gcd(unit, nblk)
    ph = -(-h // unit) * unit
    pw = -(-w // unit) * unit

    n_real = translated.shape[0]
    n_bucket = -(-n_real // 128) * 128
    tpad = np.concatenate(
        [translated, np.zeros((n_bucket - n_real, 4), np.float32)])
    real_mask = np.zeros(n_bucket, bool)
    real_mask[:n_real] = True

    local = partial(_local_build, depth=params.depth, phys_h=ph, phys_w=pw,
                    metric=params.distance,
                    angles=tuple(float(a) for a in angles),
                    coeff=float(params.dt3_coeff), axis=axis, nblk=nblk)
    fn = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(None, axis, None),
        check_vma=False,
    ))
    dt3 = fn(jnp.asarray(tpad), jnp.asarray(real_mask),
             jnp.asarray([h, w], jnp.int32))

    return Dt3Featuremap(
        dt3=dt3,
        angles=jnp.asarray(angles),
        scene_translation=jnp.asarray(translation),
        feature_size=(w, h),
        params=params,
    )


@functools.lru_cache(maxsize=64)
def _search_spatial_cached(mesh, axis, statics):
    """Cached jitted shard_map for :func:`search_spatial` (fresh closures
    per call would re-trace)."""
    from ..matching.match import _make_candidates
    from ..matching import optimize as opt
    kw = dict(statics)
    lmax, depth = kw["lmax"], kw["depth"]
    ph, pw, h_loc = kw["ph"], kw["pw"], kw["h_loc"]

    def local(dt3_block, tl, tm, pt, ptl, psl, sc, ang, tr, fsz):
        aligned, transforms, align_vecs = _make_candidates(
            tl, tm, pt, ptl, psl, sc, lmax)
        c = 2 * pt.shape[0]
        cand_lines = aligned.reshape(c, lmax, 4)
        cand_mask = jnp.repeat(tm[pt], 2, axis=0)
        cand_align = jnp.repeat(align_vecs, 2, axis=0)
        take = _spatial_take(axis, h_loc, depth, ph, pw)
        scores, translations, valid = opt.optimize_candidates(
            dt3_block.reshape(-1), ang, tr, (ph, pw), fsz,
            cand_lines, cand_mask, cand_align, mode=kw["mode"],
            window=kw["window"], dense_steps=kw["dense_steps"],
            take_fn=take)
        mats = transforms.reshape(c, 2, 3)
        mats = mats.at[:, :, 2].add(translations)
        return scores, mats, valid

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(None, axis, None),) + (P(),) * 9,
        out_specs=(P(),) * 3,
        check_vma=False))
