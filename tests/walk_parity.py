"""Candidate-by-candidate comparison of the device walk with the numpy
oracle (``tests/oracle.py``), shared by the CPU tests and ``chip_smoke.py``.

The candidates are the ones ``search`` scores: the search strategy's
(template line, scene line) pairs of the whole bank, both alignment
polarities, aligned on the device.  The device walk runs on the default
device; the oracle walks the same aligned lines over a host copy of the
feature map.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from openfdcm_tpu.matching import optimize as opt
from openfdcm_tpu.matching.match import _make_candidates, prepare_templates
from openfdcm_tpu.matching.search import bank_pairs

from . import oracle

SCORE_RTOL, SCORE_ATOL, TRANSLATION_ATOL = 1e-4, 1e-5, 1e-4


def _oracle_walk(optimizer):
    mode, window = opt.optimizer_mode(optimizer)
    if mode == "batch":
        return lambda *a: oracle.batch_optimize(*a, window)
    return lambda *a: oracle.default_optimize(
        *a, restart_negative=mode == "indulgent")


def compare_walks(fmap, templates, scene, searcher, optimizer,
                  n_sample: int | None = None, seed: int = 0) -> dict:
    """Walk ``n_sample`` candidates (all when ``None``) of ``scene`` on the
    device and in the oracle: both polarities of ``n_sample // 2`` sampled
    pairs.  Returns counts and the worst differences:
    ``{"checked", "valid", "validity_mismatches", "score_mismatches",
    "translation_mismatches", "max_score_diff", "max_translation_diff"}``.
    """
    bank = prepare_templates(templates)
    pairs = bank_pairs(searcher, bank.lengths_np, bank.counts_np,
                       np.asarray(scene, np.float32))
    n_pairs = pairs.shape[0]
    if n_sample is not None and n_sample // 2 < n_pairs:
        rng = np.random.default_rng(seed)
        pairs = pairs[np.sort(rng.choice(n_pairs, n_sample // 2,
                                         replace=False))]
    sel = pairs
    aligned, _, align_vecs = _make_candidates(
        bank.lines, bank.mask, jnp.asarray(sel[:, 0]), jnp.asarray(sel[:, 1]),
        jnp.asarray(sel[:, 2]), jnp.asarray(scene, jnp.float32), bank.lmax)
    lines = aligned.reshape(-1, bank.lmax, 4)
    mask = jnp.repeat(bank.mask[jnp.asarray(sel[:, 0])], 2, axis=0)
    avec = jnp.repeat(align_vecs, 2, axis=0)

    mode, window = opt.optimizer_mode(optimizer)
    w, h = fmap.feature_size
    _, ph, pw = fmap.dt3.shape
    scores, trans, valid = opt.optimize_candidates(
        fmap.dt3.reshape(-1), fmap.angles, fmap.scene_translation, (ph, pw),
        jnp.asarray([float(w), float(h)], jnp.float32), lines, mask, avec,
        mode=mode, window=max(window, 1),
        dense_steps=opt.dense_step_count(optimizer, max(w, h)))
    scores, trans, valid = (np.asarray(x) for x in (scores, trans, valid))

    dt3 = np.asarray(fmap.dt3)[:, :h, :w]
    angles = np.asarray(fmap.angles)
    scene_tr = np.asarray(fmap.scene_translation)
    lines_np, mask_np, avec_np = (np.asarray(x) for x in (lines, mask, avec))
    walk = _oracle_walk(optimizer)
    out = dict(checked=0, valid=0, validity_mismatches=0, score_mismatches=0,
               translation_mismatches=0, max_score_diff=0.0,
               max_translation_diff=0.0)
    for c in range(lines_np.shape[0]):
        r = walk(dt3, angles, scene_tr, (float(w), float(h)),
                 lines_np[c][mask_np[c]], avec_np[c])
        out["checked"] += 1
        if (r is None) == bool(valid[c]):
            out["validity_mismatches"] += 1
            continue
        if r is None:
            continue
        out["valid"] += 1
        ds = abs(float(r[0]) - float(scores[c]))
        out["max_score_diff"] = max(out["max_score_diff"], ds)
        if ds > SCORE_ATOL + SCORE_RTOL * abs(float(r[0])):
            out["score_mismatches"] += 1
        dt_ = float(np.max(np.abs(np.asarray(r[1], np.float32) - trans[c])))
        out["max_translation_diff"] = max(out["max_translation_diff"], dt_)
        out["translation_mismatches"] += dt_ > TRANSLATION_ATOL
    return out
