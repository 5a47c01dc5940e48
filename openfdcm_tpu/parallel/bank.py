"""Template-bank-axis sharding ("long-context" axis, SURVEY §2.4).

The reference holds the whole template bank in one process and loops over it
(``defaultmatch.cpp:32-89``).  At 10k-1M templates the bank's candidate
tensor (and at 1M, the bank line tensor itself: ``(T, lmax, 4)`` f32 is
~0.5 GB at T=1M, lmax=32) no longer fits one device, so this module shards
the *bank* dimension across a ``"bank"`` mesh axis:

* the padded template tensors (lines, mask, per-template lengths) are
  sharded along T — each device stores only ``T / n_bank`` templates;
* (template, scene-line) pairs are generated per shard with *shard-local*
  template ids and sharded along the same axis, so every candidate is
  scored on the device that owns its template;
* each device penalizes + top-k's its local candidates, then one
  ``all_gather`` over the bank axis and a deterministic
  (score, global-candidate-index) re-rank produce the global per-scene
  top-k.  Only ``(S, k)``-sized tensors cross the interconnect.

Composes with the ``"scene"`` data-parallel axis: a 2D
``Mesh(..., ("scene", "bank"))`` shards scenes along rows and the bank
along columns.  Results match the unsharded ``match_many(..., top_k=k)``
(scores bit-equal; tie order fixed by global candidate index).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..core import geometry as geo
from ..matching import optimize as opt
from ..matching.match import Match, _bucket, _search_device_batch
from ..matching.search import establish_search_strategy, bank_pairs, \
    DefaultSearch, ConcentricRangeStrategy

__all__ = ["prepare_bank_shards", "match_many_bank_sharded"]


def prepare_bank_shards(templates, n_bank: int):
    """Pad templates to ``n_bank`` equal shards of host arrays.

    Returns a dict of numpy arrays: ``lines (T_pad, lmax, 4)``,
    ``mask (T_pad, lmax)``, ``line_lengths (T_pad, lmax)``,
    ``counts (T_pad,)``, ``tmpl_lengths (T_pad,)`` plus ``t_shard`` and the
    real template count ``t_real``.  Shard ``b`` owns rows
    ``[b*t_shard, (b+1)*t_shard)``; padding templates are empty (count 0)
    and generate no pairs.

    Deliberately does NOT reuse :func:`matching.match.prepare_templates`:
    that uploads the full bank to ONE device, which is exactly what bank
    sharding exists to avoid (a 1M-template bank's line tensor is ~0.5 GB)
    — these stay host numpy until the sharded ``device_put``.
    """
    tmpls = [geo.as_lines_np(t) if np.asarray(t).size else
             np.zeros((0, 4), np.float32) for t in templates]
    t_real = len(tmpls)
    t_shard = max(1, -(-t_real // n_bank))
    t_pad = t_shard * n_bank
    lmax = max(1, max((t.shape[0] for t in tmpls), default=1))
    lines = np.zeros((t_pad, lmax, 4), np.float32)
    mask = np.zeros((t_pad, lmax), bool)
    for i, t in enumerate(tmpls):
        lines[i, : t.shape[0]] = t
        mask[i, : t.shape[0]] = True
    d = lines[:, :, 2:4] - lines[:, :, 0:2]
    line_lengths = np.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2).astype(np.float32)
    line_lengths[~mask] = 0.0
    return dict(lines=lines, mask=mask, line_lengths=line_lengths,
                counts=mask.sum(axis=1).astype(np.int64),
                tmpl_lengths=line_lengths.sum(axis=1).astype(np.float32),
                t_shard=t_shard, t_real=t_real, host=tmpls, lmax=lmax)


def _shard_pairs(searcher, shards, scene_arr, b: int) -> np.ndarray:
    """Pairs of bank shard ``b`` vs one scene, template ids LOCAL to the
    shard, reference emplace order within the shard."""
    t_shard = shards["t_shard"]
    lo, hi = b * t_shard, (b + 1) * t_shard
    if isinstance(searcher, (DefaultSearch, ConcentricRangeStrategy)):
        return bank_pairs(searcher, shards["line_lengths"][lo:hi],
                          shards["counts"][lo:hi], scene_arr)
    pairs = []
    for ti in range(lo, min(hi, shards["t_real"])):
        t = shards["host"][ti]
        if t.shape[0] == 0:
            continue
        for tl, sl in establish_search_strategy(searcher, t, scene_arr):
            pairs.append((ti - lo, tl, sl))
    return np.asarray(pairs, np.int32).reshape(-1, 3)


def match_many_bank_sharded(scenes, templates, params, searcher, optimizer,
                            *, mesh, top_k: int, penalty=None,
                            template_lengths=None, pad_to: int = 128,
                            scene_chunk: int | None = None,
                            scene_axis: str = "scene",
                            bank_axis: str = "bank") -> list:
    """``match_many(..., top_k=k)`` with the template bank sharded along a
    ``"bank"`` mesh axis (see module docstring).  Returns
    ``list[list[Match]]`` per scene, k best, ascending score.
    """
    from ..matching.pipeline import build_featuremap_batch

    n_bank = mesh.shape[bank_axis]
    n_sc = mesh.shape.get(scene_axis, 1)
    shards = prepare_bank_shards(templates, n_bank)
    lmax, t_shard = shards["lmax"], shards["t_shard"]
    if template_lengths is not None:
        tl = np.zeros((t_shard * n_bank,), np.float32)
        tl[: len(template_lengths)] = np.asarray(template_lengths, np.float32)
        shards = dict(shards, tmpl_lengths=tl)
    if penalty is None:
        tau = np.float32(np.nan)
    else:
        from ..matching.penalty import DefaultPenalty, ExponentialPenalty
        if type(penalty) is DefaultPenalty:
            tau = np.float32(1.0)
        elif type(penalty) is ExponentialPenalty:
            tau = np.float32(penalty.tau)
        else:
            raise ValueError("bank-sharded path needs a power-form penalty")

    lines_dev = jax.device_put(
        shards["lines"], jax.sharding.NamedSharding(mesh, P(bank_axis)))
    mask_dev = jax.device_put(
        shards["mask"], jax.sharding.NamedSharding(mesh, P(bank_axis)))
    tlen_dev = jax.device_put(
        shards["tmpl_lengths"], jax.sharding.NamedSharding(mesh, P(bank_axis)))

    arrs = [geo.as_lines_np(s) for s in scenes]
    s_total = len(scenes)
    if scene_chunk is None:
        scene_chunk = 8 * n_sc
    scene_chunk = max(n_sc, (scene_chunk // n_sc) * n_sc)

    # zero-line scenes produce no matches (same contract as match_many)
    out = [[] for _ in scenes]
    live = [i for i, a in enumerate(arrs) if a.shape[0] > 0]
    for lo in range(0, len(live), scene_chunk):
        idx = live[lo: lo + scene_chunk]
        pad_idx = idx + [idx[0]] * (-len(idx) % n_sc)
        res = _dispatch_chunk(
            [scenes[i] for i in pad_idx], [arrs[i] for i in pad_idx],
            searcher, optimizer, params, mesh, shards, lines_dev, mask_dev,
            tlen_dev, tau, top_k, pad_to, build_featuremap_batch,
            scene_axis, bank_axis, lmax, t_shard)
        for i, matches in zip(idx, res):
            out[i] = matches
    return out


def _dispatch_chunk(group, arrs, searcher, optimizer, params, mesh, shards,
                    lines_dev, mask_dev, tlen_dev, tau, top_k, pad_to,
                    build_featuremap_batch, scene_axis, bank_axis, lmax,
                    t_shard):
    s_count = len(group)
    n_bank = mesh.shape[bank_axis]
    fms = build_featuremap_batch(group, params, pad_to=pad_to)
    ph, pw = fms.dt3.shape[2], fms.dt3.shape[3]
    fs = np.asarray([[float(w), float(h)] for (w, h) in fms.feature_sizes],
                    np.float32)

    per = [[_shard_pairs(searcher, shards, a, b) for b in range(n_bank)]
           for a in arrs]
    pb = _bucket(max((p.shape[0] for row in per for p in row), default=1), 64)
    pair_arr = np.zeros((s_count, n_bank * pb, 3), np.int32)
    pair_valid = np.zeros((s_count, n_bank * pb), bool)
    for i, row in enumerate(per):
        for b, p in enumerate(row):
            pair_arr[i, b * pb: b * pb + p.shape[0]] = p
            pair_valid[i, b * pb: b * pb + p.shape[0]] = True

    nb = _bucket(max(a.shape[0] for a in arrs), 128)
    scene_arr = np.zeros((s_count, nb, 4), np.float32)
    for i, a in enumerate(arrs):
        scene_arr[i, : a.shape[0]] = a

    mode, window = opt.optimizer_mode(optimizer)
    dense_steps = opt.dense_step_count(optimizer, int(fs.max()))

    fn = _bank_sharded_cached(
        mesh, scene_axis if scene_axis in mesh.axis_names else None,
        bank_axis,
        (("lmax", lmax), ("hw", (ph, pw)), ("mode", mode),
         ("window", max(window, 1)), ("dense_steps", dense_steps),
         ("top_k", top_k), ("t_shard", t_shard), ("pb", pb)))
    sk, mk, tk, gk = fn(
        lines_dev, mask_dev, jnp.asarray(pair_arr[:, :, 0]),
        jnp.asarray(pair_arr[:, :, 1]), jnp.asarray(pair_arr[:, :, 2]),
        jnp.asarray(scene_arr), fms.dt3.reshape(s_count, -1), fms.angles,
        fms.scene_translations, jnp.asarray(fs), jnp.asarray(pair_valid),
        tlen_dev, jnp.float32(tau))
    sk, mk, tk = np.asarray(sk), np.asarray(mk), np.asarray(tk)

    out = []
    for i in range(s_count):
        matches = []
        for j in range(sk.shape[1]):
            if not np.isfinite(sk[i, j]):
                continue
            matches.append(Match(int(tk[i, j]), float(sk[i, j]),
                                 mk[i, j].copy()))
        out.append(matches[:top_k])
    return out


import functools


@functools.lru_cache(maxsize=64)
def _bank_sharded_cached(mesh, sa, ba, statics):
    """Cached jitted shard_map for the bank-sharded search (a fresh closure
    per chunk would re-trace every dispatch)."""
    kw = dict(statics)
    top_k, t_shard, pb = kw.pop("top_k"), kw.pop("t_shard"), kw.pop("pb")
    n_bank = mesh.shape[ba]
    kk = min(top_k, 2 * pb)

    def local(lines_l, mask_l, pt, ptl, psl, sc, dt, ang, tr, fsz, pv, tln,
              tau):
        scores, mats, valid = _search_device_batch(
            lines_l, mask_l, pt, ptl, psl, sc, dt, ang, tr, fsz, **kw)
        tof = jnp.repeat(pt, 2, axis=1)                    # local tmpl ids
        pen = jnp.where(jnp.isnan(tau), 1.0,
                        jnp.power(jnp.maximum(tln[tof], 1e-6), tau))
        masked = jnp.where(valid & jnp.repeat(pv, 2, axis=1),
                           scores / pen, jnp.inf)
        neg_top, idx = jax.lax.top_k(-masked, kk)          # ties -> low idx
        mats_k = jnp.take_along_axis(mats, idx[..., None, None], axis=1)
        b = jax.lax.axis_index(ba)
        tmpl_k = jnp.take_along_axis(tof, idx, axis=1) + b * t_shard
        gidx = idx + b * (2 * pb)
        if n_bank == 1:
            return -neg_top, mats_k, tmpl_k, gidx
        from ..matching.match import _gather_rerank
        # after the gather the device holds n_bank*kk candidates — return
        # min(top_k, n_bank*kk) of them, not the per-device kk
        fv, fi, mk2, tk2 = _gather_rerank(
            ba, min(top_k, n_bank * kk), -neg_top, gidx, mats_k, tmpl_k)
        return fv, mk2, tk2, fi

    psa, psb = P(sa), P(sa, ba)
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(ba), P(ba), psb, psb, psb, psa,
                  psa, P(), psa, psa, psb, P(ba), P()),
        out_specs=(psa,) * 4,
        check_vma=False)
    return jax.jit(fn)
