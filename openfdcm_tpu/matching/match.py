"""Match orchestration: the main ``search`` entry point.

Reference ``src/matchstrategies/defaultmatch.cpp``: for every template and
every (template line, scene line) combination from the search strategy,
generate both aligning transforms, then run ONE batched optimize over all
candidates and turn finite results into matches.

Accelerator redesign: candidate generation is closed-form and fully batched — the
aligned-template tensor ``(C, Lmax, 4)`` is built on device in one shot, and
the optimizer scores every candidate in lockstep.  Candidate counts are
padded to buckets so repeated searches hit the jit cache.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import geometry as geo
from . import featuremap as fm
from . import optimize as opt


@dataclasses.dataclass
class Match:
    """Reference ``matchstrategy.h:35-45``."""
    tmpl_idx: int
    score: float
    transform: np.ndarray  # 2x3

    def __lt__(self, other):
        return self.score < other.score


@dataclasses.dataclass(frozen=True)
class DefaultMatch:
    """The (only) reference match strategy (``defaultmatch.h:31-36``)."""


def sort_matches(matches, max_num_candidates: int | None = None):
    """Sort matches ascending by score (best first).

    Reference ``matchstrategy.h:48-55``: with ``max_num_candidates`` the
    reference partial-sorts — the best k lead in order, the tail stays in
    unspecified order.  Mirrored here with an O(n) selection instead of a
    full sort (matters for 10k+ template banks)."""
    if max_num_candidates is None or max_num_candidates >= len(matches):
        return sorted(matches, key=lambda m: m.score)
    k = max(int(max_num_candidates), 0)
    scores = np.asarray([m.score for m in matches], np.float64)
    part = np.argpartition(scores, k)
    head = part[:k][np.argsort(scores[part[:k]], kind="stable")]
    return [matches[i] for i in head] + [matches[i] for i in part[k:]]


def _bucket(n: int, quantum: int = 64) -> int:
    return max(quantum, -(-n // quantum) * quantum)


@partial(jax.jit, static_argnames=("lmax",))
def _make_candidates(tmpl_lines, tmpl_mask, tmpl_of_cand, cand_tmpl_line,
                     cand_scene_line, scene, lmax):
    """Build aligned-template candidates on device.

    Inputs: padded template bank ``(T, lmax, 4)`` + mask; per *pair* indices
    (template id, template line idx, scene line idx).  Each pair yields two
    candidates (both alignment polarities).  Returns
    ``(aligned (P,2,lmax,4), transforms (P,2,2,3), align_vecs (P,2))``.
    """
    t_line = tmpl_lines[tmpl_of_cand, cand_tmpl_line]   # (P, 4)
    s_line = scene[cand_scene_line]                     # (P, 4)
    align_vecs = geo.normalize(s_line)                  # (P, 2)
    transforms = geo.align(t_line, s_line)              # (P, 2, 2, 3)
    tl = tmpl_lines[tmpl_of_cand]                       # (P, lmax, 4)
    aligned = geo.transform(tl[:, None, :, :], transforms[:, :, None, :, :])
    return aligned, transforms, align_vecs


@dataclasses.dataclass(frozen=True)
class TemplateBank:
    """Device-resident padded template bank (upload once, search many)."""
    lines: jax.Array       # (T, lmax, 4)
    mask: jax.Array        # (T, lmax)
    host: tuple            # per-template host (N_i, 4) arrays (search strategies)
    lengths_np: np.ndarray = None   # (T, lmax) f32 per-line lengths (padded 0)
    counts_np: np.ndarray = None    # (T,) int64 real line counts

    @property
    def lmax(self) -> int:
        return self.lines.shape[1]


def prepare_templates(templates, lmax_to: int | None = None,
                      count_to: int | None = None) -> TemplateBank:
    """Pad templates to a common line count and upload to device.

    ``lmax_to``/``count_to``: optionally pad the line axis / template count
    up to these values (ignored when smaller than the real maxima).  Banks
    padded to shared buckets compile to the SAME device programs, so e.g.
    the four pose objects (lmax 23-33, 91-122 templates) share one
    executable instead of four (bench.py).  Padded templates have zero
    lines; their candidates are masked out of scoring and never produce
    matches.
    """
    tmpls = [geo.as_lines_np(t) if np.asarray(t).size else np.zeros((0, 4), np.float32)
             for t in templates]
    if count_to is not None and count_to > len(tmpls):
        tmpls += [np.zeros((0, 4), np.float32)] * (count_to - len(tmpls))
    lmax = max(1, max((t.shape[0] for t in tmpls), default=1), lmax_to or 1)
    tbank = np.zeros((len(tmpls), lmax, 4), np.float32)
    tmask = np.zeros((len(tmpls), lmax), bool)
    for i, t in enumerate(tmpls):
        tbank[i, : t.shape[0]] = t
        tmask[i, : t.shape[0]] = True
    d = tbank[:, :, 2:4] - tbank[:, :, 0:2]
    lengths = np.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2).astype(np.float32)
    counts = tmask.sum(axis=1).astype(np.int64)
    return TemplateBank(jnp.asarray(tbank), jnp.asarray(tmask), tuple(tmpls),
                        lengths, counts)


def _search_core(tmpl_lines, tmpl_mask, tmpl_of_cand, cand_tmpl_line,
                 cand_scene_line, scene, dt3_flat, angles, scene_tr,
                 feature_size, *, lmax, hw, mode, window, dense_steps):
    """Candidate generation + batched optimize + transform combine.
    Returns ``(scores (C,), transforms (C,2,3), valid (C,))`` with
    ``C = 2 * P`` (both alignment polarities, reference emplace order
    ``defaultmatch.cpp:62-70``)."""
    with jax.named_scope("candidates"):
        aligned, transforms, align_vecs = _make_candidates(
            tmpl_lines, tmpl_mask, tmpl_of_cand, cand_tmpl_line,
            cand_scene_line, scene, lmax)
        p = tmpl_of_cand.shape[0]
        c = 2 * p
        cand_lines = aligned.reshape(c, lmax, 4)
        cand_mask = jnp.repeat(tmpl_mask[tmpl_of_cand], 2, axis=0)
        cand_align = jnp.repeat(align_vecs, 2, axis=0)

    with jax.named_scope("walk"):
        scores, translations, valid = opt.optimize_candidates(
            dt3_flat, angles, scene_tr, hw, feature_size,
            cand_lines, cand_mask, cand_align,
            mode=mode, window=window, dense_steps=dense_steps)

    # combine(translation, transform): translation applied after
    # (defaultmatch.cpp:83-84).
    mats = transforms.reshape(c, 2, 3)
    mats = mats.at[:, :, 2].add(translations)
    return scores, mats, valid


_search_device = partial(jax.jit, static_argnames=(
    "lmax", "hw", "mode", "window", "dense_steps"))(_search_core)


@partial(jax.jit, static_argnames=("lmax", "hw", "mode", "window",
                                   "dense_steps"))
def _search_device_batch(tmpl_lines, tmpl_mask, pair_t, pair_tl, pair_sl,
                         scenes, dt3_flat, angles, scene_tr, feature_size,
                         *, lmax, hw, mode, window, dense_steps):
    """Scene-batched search: one dispatch scores a whole scene batch.
    Leading axis S on ``pair_*``, ``scenes``, ``dt3_flat``, ``scene_tr``,
    ``feature_size``; the template bank and angles are shared."""
    def one(pt, ptl, psl, sc, dt, tr, fs):
        return _search_core(tmpl_lines, tmpl_mask, pt, ptl, psl, sc, dt,
                            angles, tr, fs, lmax=lmax, hw=hw, mode=mode,
                            window=window, dense_steps=dense_steps)
    return jax.vmap(one)(pair_t, pair_tl, pair_sl, scenes, dt3_flat,
                         scene_tr, feature_size)


@partial(jax.jit, static_argnames=("lmax", "hw", "mode", "window",
                                   "dense_steps", "k"))
def _search_device_batch_topk(tmpl_lines, tmpl_mask, pair_t, pair_tl, pair_sl,
                              scenes, dt3_flat, angles, scene_tr, feature_size,
                              lengths, tau, pair_valid, *, lmax, hw, mode,
                              window, dense_steps, k):
    """Batched search + device-side penalize + per-scene top-k.

    Returns ``(scores_k (S,k), mats_k (S,k,2,3), cand_idx_k (S,k),
    valid_k (S,k))`` — scores penalized by ``score / max(len, 1e-6)^tau``
    (reference ``exponentialpenalty.cpp:39-45``; ``tau=1`` is
    DefaultPenalty); ties break on candidate index like the host path.
    """
    scores, mats, valid = _search_device_batch(
        tmpl_lines, tmpl_mask, pair_t, pair_tl, pair_sl, scenes, dt3_flat,
        angles, scene_tr, feature_size, lmax=lmax, hw=hw, mode=mode,
        window=window, dense_steps=dense_steps)
    tmpl_of_cand = jnp.repeat(pair_t, 2, axis=1)          # (S, 2P)
    pen = jnp.where(jnp.isnan(tau), 1.0,
                    jnp.power(jnp.maximum(lengths[tmpl_of_cand], 1e-6), tau))
    pscores = scores / pen
    masked = jnp.where(valid & jnp.repeat(pair_valid, 2, axis=1),
                       pscores, jnp.inf)
    neg_top, idx = jax.lax.top_k(-masked, k)              # ties -> lowest idx
    take = lambda a, i: jnp.take_along_axis(a, i, axis=1)
    return (-neg_top, jnp.take_along_axis(mats, idx[..., None, None], axis=1),
            idx, take(valid, idx))


@partial(jax.jit, static_argnames=("lmax", "hw", "mode", "window",
                                   "dense_steps", "k", "ms"))
def _search_device_batch_topk_genpairs(tmpl_lines, tmpl_mask, top_vals, ord_t,
                                       rank_ok, scenes, slen, svalid,
                                       dt3_flat, angles, scene_tr,
                                       feature_size, lengths, tau, *, lmax,
                                       hw, mode, window, dense_steps, k, ms):
    """Top-k search with pair generation ON DEVICE: scene lines plus their
    host-computed lengths/validity are uploaded, and the
    (template, scene-line) windows are computed where the data lives
    (:func:`openfdcm_tpu.matching.search.device_pairs`), removing the
    per-chunk ``(S, P, 3)`` pair upload of the host path.  Lengths come
    from the host (``search.scene_length_mask``) so their f32 values are
    bit-identical to ``bank_pairs`` — an on-device ``sqrt(dx²+dy²)`` can
    FMA-contract differently and flip length ties (fuzz seed 41).

    Candidate order is the same emplace order on a ``(T, mt, ms)`` grid
    with invalid slots masked (the host path packs them out), so
    tie-breaks can differ from the host path only between equal scores.
    Returns ``(scores_k (S,k), mats_k (S,k,2,3), tmpl_k (S,k),
    valid_k (S,k))`` — template indices come back from the device, no
    host pair table needed.
    """
    from .search import device_pairs

    t_count, mt = ord_t.shape
    s_count = scenes.shape[0]
    p = t_count * mt * ms

    def pairs_one(ln, va):
        sl, wok = device_pairs(ln, va, top_vals, rank_ok, ms)
        return sl.reshape(-1), wok.reshape(-1)

    with jax.named_scope("pairs"):
        sl, wok = jax.vmap(pairs_one)(slen, svalid)          # (S, P)
    pair_t = jnp.broadcast_to(
        jnp.repeat(jnp.arange(t_count, dtype=jnp.int32), mt * ms)[None],
        (s_count, p))
    pair_tl = jnp.broadcast_to(
        jnp.repeat(ord_t.reshape(-1).astype(jnp.int32), ms)[None],
        (s_count, p))

    # Invalid windows (rank_ok false / beyond the valid scene lines) are
    # masked at top-k.
    scores, mats, valid = _search_device_batch(
        tmpl_lines, tmpl_mask, pair_t, pair_tl, sl, scenes, dt3_flat,
        angles, scene_tr, feature_size, lmax=lmax, hw=hw, mode=mode,
        window=window, dense_steps=dense_steps)
    with jax.named_scope("penalize_topk"):
        tof = jnp.repeat(pair_t, 2, axis=1)
        pen = jnp.where(jnp.isnan(tau), 1.0,
                        jnp.power(jnp.maximum(lengths[tof], 1e-6), tau))
        masked = jnp.where(valid & jnp.repeat(wok, 2, axis=1),
                           scores / pen, jnp.inf)
        neg_top, idx = jax.lax.top_k(-masked, k)             # ties -> low idx
    return (-neg_top,
            jnp.take_along_axis(mats, idx[..., None, None], axis=1),
            jnp.take_along_axis(tof, idx, axis=1),
            jnp.take_along_axis(valid, idx, axis=1))


import functools


def _gather_rerank(axis: str, k: int, vals, gidx, *extras):
    """all_gather per-shard top-k rows over ``axis`` and deterministically
    re-rank by (score, global candidate index) — the cross-shard merge used
    by both the cand-sharded and bank-sharded top-k paths.

    ``vals``/``gidx``: ``(S, kk)`` per-shard scores and global indices;
    ``extras``: additional ``(S, kk, ...)`` arrays reordered the same way.
    Returns ``(vals_k, gidx_k, *extras_k)`` of width ``k``.
    """
    av = jax.lax.all_gather(vals, axis, axis=1)      # (S, n, kk)
    ai = jax.lax.all_gather(gidx, axis, axis=1)
    s_loc = av.shape[0]
    fv, fi = av.reshape(s_loc, -1), ai.reshape(s_loc, -1)
    order = jnp.lexsort((fi, fv))[:, :k]

    def take(a):
        g = jax.lax.all_gather(a, axis, axis=1)
        flat = g.reshape((s_loc, -1) + g.shape[3:])
        idx = order.reshape(order.shape + (1,) * (flat.ndim - 2))
        return jnp.take_along_axis(flat, idx, axis=1)

    return (jnp.take_along_axis(fv, order, axis=1),
            jnp.take_along_axis(fi, order, axis=1),
            *[take(e) for e in extras])



@functools.lru_cache(maxsize=128)
def _genpairs_sharded_cached(mesh, axis, statics):
    """Cached jitted shard_map for :func:`_genpairs_topk_sharded` — built
    once per (mesh, static config); all arrays are explicit args so the
    jit cache hits across chunk dispatches (a fresh closure per call would
    re-trace every chunk)."""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    kw = dict(statics)

    def local(tl, tm, tv, ot, ro, sc, ln, va, dt, ang, tr, fsz, lng, tau):
        return _search_device_batch_topk_genpairs(
            tl, tm, tv, ot, ro, sc, ln, va, dt, ang, tr, fsz, lng, tau,
            **kw)

    pa = P(axis)
    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(), P(), P(), P(), P(), pa, pa, pa, pa, P(),
                             pa, pa, P(), P()),
                   out_specs=(pa,) * 4, check_vma=False)
    return jax.jit(fn)


def _genpairs_topk_sharded(mesh, tmpl_lines, tmpl_mask, top_vals, ord_t,
                           rank_ok, scenes, slen, svalid, dt3_flat, angles,
                           scene_tr, feature_size, lengths, tau,
                           *, axis="scene", **static):
    """Scene-data-parallel :func:`_search_device_batch_topk_genpairs`: each
    device generates pairs for and scores its own scene shard; the bank
    tables are replicated.  No cross-device collectives."""
    fn = _genpairs_sharded_cached(mesh, axis, tuple(sorted(static.items())))
    return fn(tmpl_lines, tmpl_mask, top_vals, ord_t, rank_ok, scenes,
              slen, svalid, dt3_flat, angles, scene_tr, feature_size,
              lengths, jnp.float32(tau))


def _search_device_batch_topk_sharded(mesh, tmpl_lines, tmpl_mask, pair_t,
                                      pair_tl, pair_sl, scenes, dt3_flat,
                                      angles, scene_tr, feature_size, lengths,
                                      tau, pair_valid, *, lmax, hw, mode,
                                      window, dense_steps, k,
                                      scene_axis="scene", cand_axis="cand"):
    """Mesh-sharded search + device-side penalize + per-scene top-k.

    Scenes shard along ``scene_axis``; the pair axis optionally shards along
    ``cand_axis``.  Each device reduces its local candidates to a top-k, and
    (when candidates span devices) an ``all_gather`` over ``cand_axis`` plus
    a deterministic (score, global-index) re-rank yields the global per-scene
    top-k — the integrated form of :func:`openfdcm_tpu.parallel.global_topk`.
    Only ``(S, k)``-sized results ever leave the device mesh.
    """
    fn = _topk_sharded_cached(
        mesh, scene_axis, cand_axis,
        (("lmax", lmax), ("hw", hw), ("mode", mode), ("window", window),
         ("dense_steps", dense_steps), ("k", k)))
    return fn(tmpl_lines, tmpl_mask, pair_t, pair_tl, pair_sl, scenes,
              dt3_flat, angles, scene_tr, feature_size, lengths,
              jnp.float32(tau), pair_valid)


@functools.lru_cache(maxsize=128)
def _topk_sharded_cached(mesh, scene_axis, cand_axis, statics):
    """Cached jitted shard_map for :func:`_search_device_batch_topk_sharded`
    (fresh closures would re-trace every chunk dispatch)."""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    kw = dict(statics)
    k = kw.pop("k")
    n_cand = mesh.shape.get(cand_axis, 1) if cand_axis in mesh.axis_names else 1

    def local(tl, tm, pt, ptl, psl, sc, dt, ang, tr, fs, ln, tau, pv):
        scores, mats, valid = _search_device_batch(
            tl, tm, pt, ptl, psl, sc, dt, ang, tr, fs, **kw)
        tmpl_of_cand = jnp.repeat(pt, 2, axis=1)
        pen = jnp.where(jnp.isnan(tau), 1.0,
                        jnp.power(jnp.maximum(ln[tmpl_of_cand], 1e-6),
                                  tau))
        pscores = scores / pen
        masked = jnp.where(valid & jnp.repeat(pv, 2, axis=1), pscores,
                           jnp.inf)
        c_local = masked.shape[1]
        kk = min(k, c_local)
        neg_top, idx = jax.lax.top_k(-masked, kk)     # ties -> lowest idx
        mats_k = jnp.take_along_axis(mats, idx[..., None, None], axis=1)
        valid_k = jnp.take_along_axis(valid, idx, axis=1)
        if n_cand == 1:
            return -neg_top, mats_k, idx, valid_k
        shard = jax.lax.axis_index(cand_axis)
        gidx = idx + shard * c_local
        # after the gather the device holds n_cand*kk candidates — return
        # min(k, n_cand*kk) of them, not the per-device kk
        fv, fi, mk2, vk2 = _gather_rerank(
            cand_axis, min(k, n_cand * kk), -neg_top, gidx, mats_k, valid_k)
        return fv, mk2, fi, vk2

    sa = scene_axis if scene_axis in mesh.axis_names else None
    pair_spec = P(sa, cand_axis) if n_cand > 1 else P(sa)
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), pair_spec, pair_spec, pair_spec, P(sa), P(sa),
                  P(), P(sa), P(sa), P(), P(), pair_spec),
        out_specs=(P(sa),) * 4,
        check_vma=False)
    return jax.jit(fn)


def _search_device_batch_sharded(mesh, tmpl_lines, tmpl_mask, pair_t, pair_tl,
                                 pair_sl, scenes, dt3_flat, angles, scene_tr,
                                 feature_size, *, lmax, hw, mode, window,
                                 dense_steps, axis="scene"):
    """Scene-data-parallel batched search: the scene axis is sharded over a
    mesh; the template bank and angles are replicated.  Per-scene work is
    independent, so there is no cross-device traffic inside the search."""
    fn = _batch_sharded_cached(
        mesh, axis,
        (("lmax", lmax), ("hw", hw), ("mode", mode), ("window", window),
         ("dense_steps", dense_steps)))
    return fn(tmpl_lines, tmpl_mask, pair_t, pair_tl, pair_sl, scenes,
              dt3_flat, angles, scene_tr, feature_size)


@functools.lru_cache(maxsize=128)
def _batch_sharded_cached(mesh, axis, statics):
    """Cached jitted shard_map for :func:`_search_device_batch_sharded`."""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    kw = dict(statics)

    def local(tl, tm, pt, ptl, psl, sc, dt, ang, tr, fs):
        def one(pt1, ptl1, psl1, sc1, dt1, tr1, fs1):
            return _search_core(tl, tm, pt1, ptl1, psl1, sc1, dt1, ang,
                                tr1, fs1, lmax=kw["lmax"], hw=kw["hw"],
                                mode=kw["mode"], window=kw["window"],
                                dense_steps=kw["dense_steps"])
        return jax.vmap(one)(pt, ptl, psl, sc, dt, tr, fs)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(), P()) + (P(axis),) * 5 + (P(),)
                   + (P(axis),) * 2,
                   out_specs=(P(axis),) * 3,
                   check_vma=False)
    return jax.jit(fn)


def search(matcher, searcher, optimizer, featuremap: fm.Dt3Featuremap,
           templates, scene, mesh=None) -> list:
    """Find matches of ``templates`` in ``scene``.  Reference
    ``defaultmatch.cpp:32-89``.  Returns an UNSORTED list of ``Match``.

    ``mesh``: optional ``jax.sharding.Mesh`` with a ``"cand"`` axis — shards
    the candidate tensor across devices (each device walks its own
    candidates against a replicated DT3; no per-step collectives)."""
    del matcher  # single strategy, kept for API parity
    bank = templates if isinstance(templates, TemplateBank) else prepare_templates(templates)
    scene_arr = geo.as_lines_np(scene) if np.asarray(scene).size else np.zeros((0, 4), np.float32)
    if not bank.host or scene_arr.shape[0] == 0 or featuremap.feature_size == (0, 0):
        return []

    # --- host: combinations per template -------------------------------
    from .pipeline import _bank_pairs_for_scene
    pairs = _bank_pairs_for_scene(searcher, bank, scene_arr)
    if pairs.shape[0] == 0:
        return []
    p = pairs.shape[0]
    lmax = bank.lmax

    # Pad pair count and the scene array to buckets to stabilize jit shapes.
    quantum = 64
    if mesh is not None:
        quantum = int(np.lcm(quantum, mesh.shape.get("cand", 1)))
    pb = _bucket(p, quantum)
    pad = pb - p
    pairs_padded = np.concatenate([pairs, np.zeros((pad, 3), np.int32)])
    sb = _bucket(scene_arr.shape[0], 128)
    scene_padded = np.concatenate(
        [scene_arr, np.zeros((sb - scene_arr.shape[0], 4), np.float32)])

    mode, window = opt.optimizer_mode(optimizer)
    w, h = featuremap.feature_size
    dense_steps = opt.dense_step_count(optimizer, max(w, h))
    d, ph, pw = featuremap.dt3.shape
    feature_size = jnp.asarray([float(w), float(h)], jnp.float32)
    c = 2 * pb

    if mesh is not None:
        from ..parallel import optimize_candidates_sharded
        aligned, transforms, align_vecs = _make_candidates(
            bank.lines, bank.mask,
            jnp.asarray(pairs_padded[:, 0]), jnp.asarray(pairs_padded[:, 1]),
            jnp.asarray(pairs_padded[:, 2]), jnp.asarray(scene_padded), lmax)
        cand_lines = aligned.reshape(c, lmax, 4)
        cand_mask = jnp.repeat(bank.mask[jnp.asarray(pairs_padded[:, 0])], 2, axis=0)
        cand_align = jnp.repeat(align_vecs, 2, axis=0)
        scores, translations, valid = optimize_candidates_sharded(
            mesh, featuremap.dt3.reshape(-1), featuremap.angles,
            featuremap.scene_translation, (ph, pw), feature_size,
            cand_lines, cand_mask, cand_align,
            mode=mode, window=max(window, 1), dense_steps=dense_steps)
        mats = np.asarray(transforms).reshape(c, 2, 3).copy()
        mats[:, :, 2] += np.asarray(translations)
        mats = jnp.asarray(mats)
    else:
        scores, mats, valid = _search_device(
            bank.lines, bank.mask,
            jnp.asarray(pairs_padded[:, 0]), jnp.asarray(pairs_padded[:, 1]),
            jnp.asarray(pairs_padded[:, 2]), jnp.asarray(scene_padded),
            featuremap.dt3.reshape(-1), featuremap.angles,
            featuremap.scene_translation, feature_size,
            lmax=lmax, hw=(ph, pw), mode=mode, window=max(window, 1),
            dense_steps=dense_steps)

    scores = np.asarray(scores)
    valid = np.asarray(valid)
    mats_np = np.asarray(mats)

    matches = []
    for i in range(2 * p):
        if not valid[i]:
            continue
        pair = pairs[i // 2]
        matches.append(Match(int(pair[0]), float(scores[i]), mats_np[i].copy()))
    return matches
