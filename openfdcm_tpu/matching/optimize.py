"""1D translation optimizers.

The reference ships three sequential greedy line-searches
(``src/optimizestrategies/{default,batch,indulgent}optimize.cpp``): walk away
from the aligned position in unit steps of the rasterized alignment vector,
break on the first worsening score, keep the best visited.

Accelerator redesign: all candidates advance in lockstep through *windows* of steps
evaluated as one batched gather; the per-candidate break/keep logic becomes
vectorized mask algebra on the window scores (the visited set of the greedy
walk is a computable prefix — see ``_chain_prefix``).  This reproduces the
reference's visited sets, scores, and first-minimum tie-breaking exactly,
while evaluating thousands of candidates per step instead of one.

A fourth strategy, ``DenseOptimize``, evaluates the *entire* legal range and
takes the global argmin — a strict superset of the greedy walks (scores can
only improve); use it when reference-identical rankings are not required.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import geometry as geo
from ..core import rasterize as ras
from . import featuremap as fm

# np scalar, not jnp: a module-level jnp constant would initialize the
# accelerator backend at import time (importing must not touch a device);
# np.float32 promotes identically inside jnp ops.
_BIG = np.float32(3.0e38)


# ---------------------------------------------------------------------------
# Strategy configs (API parity with the reference constructors)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DefaultOptimize:
    """Greedy unit-step walk, break on first worsening score
    (``defaultoptimize.cpp:15-69``).  The thread pool of the reference is
    replaced by batched lockstep evaluation; ``window`` steps are scored per
    device round-trip."""
    window: int = 32


@dataclasses.dataclass(frozen=True)
class IndulgentOptimize:
    """Reference ``indulgentoptimize.cpp``.  Its passthrough counter never
    advances the step, so observable behavior equals DefaultOptimize except
    that the negative walk's break chain restarts from the initial score
    (the reference re-seeds scores with ``(0,0)`` before the negative loop,
    ``indulgentoptimize.cpp:56-58``)."""
    indulgent_number_of_passthroughs: int = 0
    window: int = 32

    def get_number_of_passthroughs(self) -> int:
        return self.indulgent_number_of_passthroughs


@dataclasses.dataclass(frozen=True)
class BatchOptimize:
    """Greedy walk over batches of ``batch_size`` steps; keeps each batch's
    argmin; breaks when a batch min worsens the last kept score or rises
    within the batch (``batchoptimize.cpp:48-94``)."""
    batch_size: int = 10

    def get_batch_size(self) -> int:
        return self.batch_size


@dataclasses.dataclass(frozen=True)
class DenseOptimize:
    """Global argmin over the full legal translation range (not part of the
    reference's surface)."""
    max_steps: int | None = None  # None: bound by the canvas extent


OptimizerLike = (DefaultOptimize, IndulgentOptimize, BatchOptimize, DenseOptimize)


# ---------------------------------------------------------------------------
# Core batched scoring
# ---------------------------------------------------------------------------

def _window_scores(dt3_flat, hw, slice_idx, endpoints, line_mask, scene_tr,
                   rast, t0, sign, count, take_fn=None):
    """Scores of each candidate at multipliers ``sign*(t0 + i)``, i<count.

    ``endpoints``: ``(C, L, 2, 2)`` aligned-template endpoints (no scene
    translation).  Translation per step is computed as
    ``scene_tr + m*rast`` *before* adding to endpoints, replicating the
    reference's float op order (``dt3cpu.cpp:153``)."""
    mult = (t0[:, None] + jnp.arange(count, dtype=jnp.float32)[None, :]) * sign  # (C,K)
    # launder: the m*rast product must round before the add (geometry
    # _round_launder) or the backend FMA-contracts it, skewing probe
    # pixels by 1 ulp between backends
    trans = scene_tr + geo._pmul(mult[..., None], rast[:, None, :])              # (C,K,2)
    return fm.evaluate_batched(dt3_flat, hw, slice_idx, endpoints, line_mask,
                               trans, take_fn=take_fn)


def _chain_prefix(scores, prev_kept, valid):
    """Greedy-walk window logic, vectorized.

    Given window ``scores (C,K)``, the previous kept score ``prev_kept (C,)``
    and per-step validity, compute for each candidate:
      - ``k``: number of kept steps (prefix before the first ascent/invalid),
      - ``wmin, wmin_idx``: first minimum over the kept prefix,
      - ``new_prev``: last kept score (carry),
      - ``ended``: whether the walk stopped inside this window.
    """
    c, k_win = scores.shape
    prev = jnp.concatenate([prev_kept[:, None], scores[:, :-1]], axis=1)
    ascent = scores > prev
    stop = ascent | ~valid
    any_stop = jnp.any(stop, axis=1)
    k = jnp.where(any_stop, jnp.argmax(stop, axis=1), k_win)  # kept count

    idx = jnp.arange(k_win)[None, :]
    kept_mask = idx < k[:, None]
    masked = jnp.where(kept_mask, scores, _BIG)
    wmin = jnp.min(masked, axis=1)
    wmin_idx = jnp.argmin(masked, axis=1)  # first occurrence
    new_prev = jnp.where(k > 0, jnp.take_along_axis(
        masked, jnp.maximum(k - 1, 0)[:, None], axis=1)[:, 0], prev_kept)
    has_kept = k > 0
    new_prev = jnp.where(has_kept, new_prev, prev_kept)
    return k, wmin, wmin_idx, new_prev, any_stop


def _greedy_walk(eval_window, t_limit, state, sign, window):
    """Lockstep greedy walk (Default/Indulgent semantics) for all candidates.

    ``eval_window(t0) -> (C, window)`` scores at multipliers sign*(t0+i).
    ``t_limit``: number of legal steps in this direction (trunc(|bound|)).
    ``state`` = ``(prev, best, bmul, done, t_next)`` with per-candidate
    resume multipliers ``t_next``.
    """
    def cond(st):
        return jnp.any(~st[3])

    def body(st):
        prev, best, bmul, done, t0 = st
        scores = eval_window(t0)
        idx = t0[:, None] + jnp.arange(window, dtype=jnp.float32)[None, :]
        valid = (idx <= t_limit[:, None]) & ~done[:, None]
        k, wmin, wmin_idx, new_prev, ended = _chain_prefix(scores, prev, valid)
        improve = wmin < best
        best = jnp.where(improve, wmin, best)
        bmul = jnp.where(improve, sign * (t0 + wmin_idx.astype(jnp.float32)), bmul)
        done = done | ended
        return new_prev, best, bmul, done, t0 + window

    return jax.lax.while_loop(cond, body, state)


def _greedy_chain(scores, t_limit, state, sign):
    """One vectorized greedy-walk window over precomputed dense ``scores
    (C, H)`` starting at each candidate's ``t_next`` — exactly one
    :func:`_greedy_walk` iteration with ``window=H``, minus the eval."""
    prev, best, bmul, done, t0 = state
    h = scores.shape[1]
    idx = t0[:, None] + jnp.arange(h, dtype=jnp.float32)[None, :]
    valid = (idx <= t_limit[:, None]) & ~done[:, None]
    k, wmin, wmin_idx, new_prev, ended = _chain_prefix(scores, prev, valid)
    improve = wmin < best
    best = jnp.where(improve, wmin, best)
    bmul = jnp.where(improve, sign * (t0 + wmin_idx.astype(jnp.float32)), bmul)
    return new_prev, best, bmul, done | ended, t0 + h


def _batch_step(carry, inp, *, sign, batch, t_limit):
    """One BatchOptimize batch decision (``batchoptimize.cpp:60-93``)."""
    prev, best, bmul, done = carry
    bmin, barg, last, t0b = inp
    active = ~done
    keep = active & ~(bmin > prev)          # break *before* keeping
    improve = keep & (bmin < best)
    best = jnp.where(improve, bmin, best)
    bmul = jnp.where(improve, sign * (t0b + barg), bmul)
    prev = jnp.where(keep, bmin, prev)
    interior = keep & (bmin < last)         # break *after* keeping
    exhausted = (t0b + batch) > t_limit
    done = done | ~keep | interior | exhausted
    return (prev, best, bmul, done)


def _batch_stats(scores, t_limit, t0, batch):
    """Per-batch (min, argmin, last-valid, per-batch t0) over dense scores
    ``(C, H)`` starting at per-candidate multiplier ``t0``."""
    c, h = scores.shape
    nb = h // batch
    idx = t0[:, None] + jnp.arange(h, dtype=jnp.float32)[None, :]
    vv = idx <= t_limit[:, None]
    masked = jnp.where(vv, scores, _BIG).reshape(c, nb, batch)
    bmin = jnp.min(masked, axis=2)
    barg = jnp.argmin(masked, axis=2).astype(jnp.float32)
    n_valid = jnp.sum(vv.reshape(c, nb, batch), axis=2)
    last = jnp.take_along_axis(
        masked, jnp.maximum(n_valid - 1, 0)[..., None], axis=2)[..., 0]
    t0s = t0[None, :] + (jnp.arange(nb, dtype=jnp.float32) * batch)[:, None]  # (nb, C)
    return bmin, barg, last, t0s


def _batch_chain(scores, t_limit, state, sign, batch):
    """Vectorized BatchOptimize chain over dense ``scores (C, H)``
    (H a multiple of ``batch``): the per-batch decisions are a cheap scan on
    ``(C,)`` vectors; all evaluation already happened in one fused gather."""
    prev, best, bmul, done, t0 = state
    h = scores.shape[1]
    bmin, barg, last, t0s = _batch_stats(scores, t_limit, t0, batch)

    def step(carry, inp):
        return _batch_step(carry, inp, sign=sign, batch=batch,
                           t_limit=t_limit), None

    (prev, best, bmul, done), _ = jax.lax.scan(
        step, (prev, best, bmul, done), (bmin.T, barg.T, last.T, t0s))
    return prev, best, bmul, done, t0 + h


def _batch_walk(eval_window, t_limit, state, sign, batch):
    """Lockstep BatchOptimize walk (``batchoptimize.cpp:48-94``) continuing
    from ``state = (prev, best, bmul, done, t_next)``."""
    def cond(st):
        return jnp.any(~st[3])

    def body(st):
        prev, best, bmul, done, t0 = st
        scores = eval_window(t0)
        bmin, barg, last, t0s = _batch_stats(scores, t_limit, t0, batch)
        prev, best, bmul, done = _batch_step(
            (prev, best, bmul, done),
            (bmin[:, 0], barg[:, 0], last[:, 0], t0),
            sign=sign, batch=batch, t_limit=t_limit)
        return prev, best, bmul, done, t0 + batch

    return jax.lax.while_loop(cond, body, state)


# ---------------------------------------------------------------------------
# Entry: optimize a batch of aligned candidates
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("hw", "mode", "window", "dense_steps",
                                   "take_fn"))
def optimize_candidates(dt3_flat, angles, scene_tr, hw, feature_size,
                        tmpl_lines, line_mask, align_vecs, *,
                        mode: str, window: int, dense_steps: int,
                        take_fn=None):
    """Optimize all candidates at once.

    ``tmpl_lines``: ``(C, L, 4)`` aligned templates; ``line_mask``: ``(C, L)``;
    ``align_vecs``: ``(C, 2)`` raw (unnormalized-step) alignment vectors.
    ``feature_size``: traced ``(w, h)`` float array (logical canvas), so
    scenes of different sizes share one compilation per physical bucket.
    Returns ``(scores, translations, valid)``.
    """
    c, l = line_mask.shape
    # Null alignment vectors bail out before rasterization
    # (defaultoptimize.cpp:20-24: relativelyEqual(|align|.sum(), 0)).
    null_align = geo.relatively_equal(jnp.sum(jnp.abs(align_vecs), axis=-1), 0.0)
    rast = ras.rasterize_vector(align_vecs)
    neg, pos = fm.minmax_translation_raw(
        tmpl_lines, rast, feature_size, scene_tr, line_mask)
    valid = jnp.isfinite(neg) & jnp.isfinite(pos) & ~null_align

    slice_idx = fm.classify_lines(angles, tmpl_lines)                # (C, L)
    endpoints = tmpl_lines.reshape(c, l, 2, 2)
    lm = line_mask.astype(jnp.float32)

    # For invalid candidates run a 0-length walk.
    t_pos = jnp.where(valid, jnp.trunc(jnp.where(valid, pos, 0.0)), 0.0)
    t_neg = jnp.where(valid, jnp.trunc(jnp.where(valid, -neg, 0.0)), 0.0)
    safe_rast = jnp.where(valid[:, None], rast, 0.0)

    def eval_win(sign, count):
        def f(t0):
            return _window_scores(dt3_flat, hw, slice_idx, endpoints, lm,
                                  scene_tr, safe_rast, t0, sign, count,
                                  take_fn=take_fn)
        return f

    if mode == "dense":
        s0 = _window_scores(dt3_flat, hw, slice_idx, endpoints, lm, scene_tr,
                            safe_rast, jnp.zeros(c, jnp.float32), 1.0, 1,
                            take_fn=take_fn)[:, 0]
        win = 64
        best, mul = s0, jnp.zeros(c, jnp.float32)
        for sign, t_lim in ((1.0, t_pos), (-1.0, t_neg)):
            ew = eval_win(sign, win)

            def body(i, state, ew=ew, sign=sign, t_lim=t_lim):
                best, mul = state
                t0 = 1.0 + i.astype(jnp.float32) * win
                scores = ew(jnp.full((c,), t0, jnp.float32))
                steps = t0 + jnp.arange(win, dtype=jnp.float32)[None, :]
                scores = jnp.where(steps <= t_lim[:, None], scores, _BIG)
                wmin = jnp.min(scores, axis=1)
                warg = jnp.argmin(scores, axis=1).astype(jnp.float32)
                better = wmin < best
                best = jnp.where(better, wmin, best)
                mul = jnp.where(better, sign * (t0 + warg), mul)
                return best, mul

            n_win = -(-dense_steps // win)
            best, mul = jax.lax.fori_loop(0, n_win, body, (best, mul))
    elif mode in ("default", "indulgent", "batch"):
        # Dense-window evaluation with COMPACTION ROUNDS.  Measured on the
        # pose assets, >=75% of candidates stop their greedy walk within the
        # first window and p99.9 by step ~31 — so after one full-width round,
        # each further round compacts the not-done candidates (cumsum slots,
        # no sort) and evaluates a wider window for the shrinking subset
        # (per-candidate resume step keeps overflow exact).  A final lockstep
        # while_loop finishes any stragglers.  All rounds are one fused
        # device dispatch; the expensive part (the probe gather) only ever
        # runs on still-active candidates.
        walk = _batch_walk if mode == "batch" else _greedy_walk

        def chain_call(scores, t_lim, state, sign):
            if mode == "batch":
                return _batch_chain(scores, t_lim, state, sign, window)
            return _greedy_chain(scores, t_lim, state, sign)

        def eval_at(sign, count, sel=None):
            si = slice_idx if sel is None else slice_idx[sel]
            ep = endpoints if sel is None else endpoints[sel]
            lmm = lm if sel is None else lm[sel]
            sr = safe_rast if sel is None else safe_rast[sel]

            def f(t0):
                return _window_scores(dt3_flat, hw, si, ep, lmm, scene_tr,
                                      sr, t0, sign, count, take_fn=take_fn)
            return f

        # Round schedule: (subset size, window multiplier).  Window widths
        # are multiples of the user batch size so batch-argmin boundaries
        # stay reference-exact.
        rounds = [(c, 1)] + [(max(64, c // s), m)
                             for s, m in ((4, 1), (8, 2), (16, 4))]

        def compact_sel(done, b):
            """Indices of (up to b) active candidates — cumsum compaction,
            no sort.  Unfilled slots default to candidate 0: processing a
            done candidate is a no-op and duplicate slots write identical
            state back, so correctness is unaffected."""
            active = ~done
            slot = jnp.where(active, jnp.cumsum(active.astype(jnp.int32)) - 1, b)
            return jnp.zeros(b, jnp.int32).at[slot].set(
                jnp.arange(c, dtype=jnp.int32), mode="drop")

        def direction(sign, t_lim, prev0, best, mul, dense0=None):
            state = (prev0, best, mul, t_lim < 1, jnp.ones(c, jnp.float32))
            for i, (b, m) in enumerate(rounds):
                h = window * m
                if b == c:
                    dense = dense0 if (i == 0 and dense0 is not None) \
                        else eval_at(sign, h)(state[4])
                    state = chain_call(dense, t_lim, state, sign)
                else:
                    sel = compact_sel(state[3], b)
                    sub = tuple(x[sel] for x in state)
                    dense = eval_at(sign, h, sel)(sub[4])
                    sub = chain_call(dense, t_lim[sel], sub, sign)
                    state = tuple(x.at[sel].set(s) for x, s in zip(state, sub))
            # Straggler tail: walk a COMPACTED subset (full-C lockstep here
            # would cost C*window*L*2 gathers per iteration for a handful of
            # active candidates); the final full-C walk only iterates in the
            # overflow case (more than c//8 stragglers — essentially never).
            b_tail = max(64, c // 8)
            sel = compact_sel(state[3], b_tail)
            sub = tuple(x[sel] for x in state)
            sub = walk(eval_at(sign, window, sel), t_lim[sel], sub, sign, window)
            state = tuple(x.at[sel].set(s) for x, s in zip(state, sub))
            state = walk(eval_at(sign, window), t_lim, state, sign, window)
            return state

        # Fused step-0 + first window: one gather covers the aligned score
        # and the whole first round.
        first = eval_at(1.0, window + 1)(jnp.zeros(c, jnp.float32))
        s0 = first[:, 0]
        prev, best, mul, _, _ = direction(
            1.0, t_pos, s0, s0, jnp.zeros(c, jnp.float32), dense0=first[:, 1:])
        neg_prev0 = s0 if mode == "indulgent" else prev
        _, best, mul, _, _ = direction(-1.0, t_neg, neg_prev0, best, mul)
    else:
        raise ValueError(f"unknown mode {mode}")

    translation = mul[:, None] * safe_rast
    return best, translation, valid


def optimizer_mode(optimizer) -> tuple[str, int]:
    """(mode, window) for a strategy config."""
    if isinstance(optimizer, DenseOptimize):
        return "dense", 0
    if isinstance(optimizer, BatchOptimize):
        return "batch", optimizer.batch_size
    if isinstance(optimizer, IndulgentOptimize):
        return "indulgent", optimizer.window
    if isinstance(optimizer, DefaultOptimize):
        return "default", optimizer.window
    raise TypeError(f"unknown optimizer {optimizer!r}")


def dense_step_count(optimizer, max_wh: int) -> int:
    """Step count per direction for the dense optimizer: the canvas extent
    (every legal translation), or ``DenseOptimize.max_steps`` when the user
    bounds the sweep; bucketed to 64 for jit-cache reuse."""
    mode, _ = optimizer_mode(optimizer)
    if mode != "dense":
        return 1
    steps = int(max_wh)
    if getattr(optimizer, "max_steps", None) is not None:
        steps = min(steps, int(optimizer.max_steps))
    return -(-max(steps, 1) // 64) * 64


def optimize(optimizer, templates, alignments, featuremap: fm.Dt3Featuremap):
    """Reference-shaped entry (``optimizestrategy.h:132``): list of aligned
    templates + alignment vectors -> list of ``None | (score, translation)``."""
    import numpy as np
    if not templates:
        return []
    if featuremap.feature_size == (0, 0):
        return [None] * len(templates)
    lmax = max(max(geo.as_lines_np(t).shape[0] for t in templates), 1)
    lmax = -(-lmax // 4) * 4           # bucket shapes for jit-cache reuse
    c = len(templates)
    cb = -(-c // 8) * 8
    lines = np.zeros((cb, lmax, 4), np.float32)
    mask = np.zeros((cb, lmax), bool)
    for i, t in enumerate(templates):
        arr = geo.as_lines_np(t)
        lines[i, :arr.shape[0]] = arr
        mask[i, :arr.shape[0]] = True
    av = np.zeros((cb, 2), np.float32)
    av[:c] = np.asarray(alignments, np.float32).reshape(c, 2)

    mode, window = optimizer_mode(optimizer)
    w, h = featuremap.feature_size
    dense_steps = dense_step_count(optimizer, max(w, h))
    d, ph, pw = featuremap.dt3.shape
    scores, trans, valid = optimize_candidates(
        featuremap.dt3.reshape(-1), featuremap.angles, featuremap.scene_translation,
        (ph, pw), jnp.asarray([float(w), float(h)], jnp.float32),
        jnp.asarray(lines), jnp.asarray(mask), jnp.asarray(av),
        mode=mode, window=max(window, 1), dense_steps=dense_steps)
    scores = np.asarray(scores); trans = np.asarray(trans); valid = np.asarray(valid)
    return [
        (float(scores[i]), trans[i].copy()) if valid[i] else None
        for i in range(c)
    ]
