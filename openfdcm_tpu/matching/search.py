"""Search strategies: which (template line, scene line) pairs to try.

Host-side candidate generation (cheap integer/sort work on host data),
mirroring reference ``src/searchstrategies/{defaultsearch,concentricrange}.cpp``.
Returns numpy index arrays consumed by the batched device pipeline.
"""
from __future__ import annotations

import dataclasses

import numpy as np

try:  # native pair generation — see native/openfdcm_native.cpp
    from .. import _native
except ImportError:  # pragma: no cover
    _native = None

_F32_EPS = np.float32(1.1920929e-07)


@dataclasses.dataclass(frozen=True)
class DefaultSearch:
    """Each of the N longest template lines is paired with a window of the
    M closest-in-length scene lines (``defaultsearch.cpp:29-49``)."""
    max_tmpl_lines: int
    max_scene_lines: int

    def get_max_tmpl_lines(self): return self.max_tmpl_lines
    def get_max_scene_lines(self): return self.max_scene_lines


@dataclasses.dataclass(frozen=True)
class ConcentricRangeStrategy:
    """DefaultSearch restricted to scene lines whose centers fall in a
    radius annulus around ``center_position`` (``concentricrange.cpp:29-60``)."""
    max_tmpl_lines: int
    max_scene_lines: int
    center_position: tuple
    low_boundary: float
    high_boundary: float

    def get_max_tmpl_lines(self): return self.max_tmpl_lines
    def get_max_scene_lines(self): return self.max_scene_lines
    def get_center_position(self): return self.center_position
    def get_low_radius_boundary(self): return self.low_boundary
    def get_high_radius_boundary(self): return self.high_boundary


def get_centered_range(center_idx: int, vec_size: int, max_length: int):
    """Reference ``defaultsearch.h:40-47``."""
    begin = max(0, int(center_idx) - int(max_length // 2))
    end = min(begin + max_length, vec_size)
    begin = max(0, end - max_length)
    return begin, end


def _lengths(lines: np.ndarray) -> np.ndarray:
    d = lines[:, 2:4] - lines[:, 0:2]
    return np.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2).astype(np.float32)


def _closest_desc(sorted_desc: np.ndarray, value: float) -> int:
    """binarySearch on a descending array with std::greater
    (reference ``core/math.h:137-146``): lower_bound = first elem <= value,
    then pick the closer of it and its predecessor (ties to predecessor)."""
    n = len(sorted_desc)
    i = int(np.searchsorted(-sorted_desc, -np.float32(value), side="left"))
    if i == 0:
        return 0
    if i == n:
        return n - 1
    return i if abs(value - sorted_desc[i]) < abs(value - sorted_desc[i - 1]) else i - 1


def _pair_by_length(tmpl_lengths, scene_lengths, scene_ids, max_tmpl, max_scene):
    """Shared core of both strategies.  ``scene_ids`` maps the filtered/sorted
    scene order back to original indices."""
    if _native is not None:
        raw = _native.default_search_pairs(
            np.ascontiguousarray(tmpl_lengths, np.float32).tobytes(),
            np.ascontiguousarray(scene_lengths, np.float32).tobytes(),
            int(max_tmpl), int(max_scene))
        pairs = np.frombuffer(raw, np.int32).reshape(-1, 2).astype(np.int64)
        if pairs.size:
            pairs[:, 1] = np.asarray(scene_ids)[pairs[:, 1]]
        return pairs
    order_t = np.argsort(-tmpl_lengths, kind="stable")
    order_s = np.argsort(-scene_lengths, kind="stable")
    sorted_scene_len = scene_lengths[order_s]
    out = []
    for t in order_t[: min(len(tmpl_lengths), max_tmpl)]:
        c = _closest_desc(sorted_scene_len, tmpl_lengths[t])
        b, e = get_centered_range(c, len(sorted_scene_len), max_scene)
        for i in range(b, e):
            out.append((int(t), int(scene_ids[order_s[i]])))
    return np.array(out, np.int64).reshape(-1, 2)


def bank_pairs(strategy, tmpl_lengths_padded: np.ndarray, counts: np.ndarray,
               scene_lines: np.ndarray) -> np.ndarray:
    """All (tmpl_id, tmpl_line, scene_line) pairs for a whole template bank
    against one scene, in reference emplace order — one vectorized pass
    instead of a per-template loop.

    ``tmpl_lengths_padded``: ``(T, Lmax)`` per-template line lengths (any
    value beyond ``counts[t]`` is ignored); ``counts``: ``(T,)`` real line
    counts.  Only DefaultSearch / ConcentricRangeStrategy are supported;
    other strategies fall back to :func:`establish_search_strategy`.
    """
    from ..core import geometry as geo
    scene = geo.as_lines_np(scene_lines)
    t_count, lmax = tmpl_lengths_padded.shape
    if scene.shape[0] == 0 or t_count == 0:
        return np.zeros((0, 3), np.int32)

    if isinstance(strategy, ConcentricRangeStrategy):
        centers = (scene[:, 0:2] + scene[:, 2:4]) / 2
        cp = np.asarray(strategy.center_position, np.float32)
        radius = np.sqrt(((centers - cp) ** 2).sum(axis=1)).astype(np.float32)
        keep = (radius > (np.float32(strategy.low_boundary) - _F32_EPS)) & \
               (radius < np.float32(strategy.high_boundary))
        scene_ids = np.nonzero(keep)[0]
    elif isinstance(strategy, DefaultSearch):
        scene_ids = np.arange(scene.shape[0])
    else:
        raise TypeError(f"unknown search strategy {strategy!r}")
    if len(scene_ids) == 0:
        return np.zeros((0, 3), np.int32)

    mt = min(strategy.max_tmpl_lines, lmax)
    ms = strategy.max_scene_lines
    if mt == 0:
        return np.zeros((0, 3), np.int32)
    scene_len = _lengths(scene[scene_ids])
    order_s = np.argsort(-scene_len, kind="stable")
    ssl = scene_len[order_s]
    n = len(ssl)
    w = min(ms, n)

    # per-template top-mt lines by length (stable desc, padding last)
    lens = np.where(np.arange(lmax)[None, :] < counts[:, None],
                    tmpl_lengths_padded, -np.inf)
    ord_t = np.argsort(-lens, axis=1, kind="stable")[:, :mt]    # (T, mt)
    k_t = np.minimum(counts, mt)                                # (T,)
    rank_ok = np.arange(mt)[None, :] < k_t[:, None]             # (T, mt)
    vals = np.take_along_axis(lens, ord_t, axis=1)              # (T, mt)

    # vectorized _closest_desc on the descending ssl
    v = vals.reshape(-1).astype(np.float32)
    i = np.searchsorted(-ssl, -v, side="left")
    ic = np.clip(i, 1, n - 1)
    closer = np.abs(v - ssl[np.clip(i, 0, n - 1)]) < np.abs(v - ssl[ic - 1])
    c = np.where(i == 0, 0,
                 np.where(i >= n, n - 1, np.where(closer, np.clip(i, 0, n - 1),
                                                  ic - 1)))
    # get_centered_range, width always min(ms, n)
    begin = np.maximum(0, c - ms // 2)
    end = np.minimum(begin + ms, n)
    begin = np.maximum(0, end - ms)                             # (T*mt,)

    sl_sorted = begin[:, None] + np.arange(w)[None, :]          # (T*mt, w)
    sl = np.asarray(scene_ids)[order_s[sl_sorted]].reshape(t_count, mt, w)
    tl = np.broadcast_to(ord_t[:, :, None], (t_count, mt, w))
    ti = np.broadcast_to(np.arange(t_count)[:, None, None], (t_count, mt, w))
    out = np.stack([ti, tl, sl], axis=-1).reshape(-1, 3)
    mask = np.broadcast_to(rank_ok[:, :, None], (t_count, mt, w)).reshape(-1)
    return np.ascontiguousarray(out[mask]).astype(np.int32)


def bank_line_table(lengths_padded: np.ndarray, counts: np.ndarray,
                    max_tmpl: int):
    """Bank-static part of pair generation: per-template top-``max_tmpl``
    line indices by length (stable desc) and per-template valid-rank counts.
    Host numpy, computed once per (bank, strategy) and uploaded once.
    Returns ``(ord_t (T, mt) int32, k_t (T,) int32)``."""
    t_count, lmax = lengths_padded.shape
    mt = min(max_tmpl, lmax)
    lens = np.where(np.arange(lmax)[None, :] < counts[:, None],
                    lengths_padded, -np.inf)
    ord_t = np.argsort(-lens, axis=1, kind="stable")[:, :mt].astype(np.int32)
    k_t = np.minimum(counts, mt).astype(np.int32)
    return ord_t, k_t


def scene_length_mask(scene_arr: np.ndarray, n_pad: int,
                      annulus=None):
    """Host-side scene line lengths + validity for :func:`device_pairs`.

    Computed in numpy so the values are BIT-identical to the host
    ``bank_pairs`` path: XLA may contract ``dx*dx + dy*dy`` into an FMA,
    which changes last-ulp length values and therefore which scene line
    wins a window when lengths tie (found by the parity fuzz, seed 41).
    ``annulus``: optional ``(cx, cy, lo, hi)`` concentric filter, also
    folded in here with the reference's f32 epsilon rule.
    Returns ``(slen (n_pad,) f32, valid (n_pad,) bool)``.
    """
    n = scene_arr.shape[0]
    slen = np.zeros((n_pad,), np.float32)
    valid = np.zeros((n_pad,), bool)
    slen[:n] = _lengths(scene_arr)
    valid[:n] = True
    if annulus is not None:
        cx, cy, lo, hi = (np.float32(a) for a in annulus)
        centers = (scene_arr[:, 0:2] + scene_arr[:, 2:4]) / 2
        radius = np.sqrt(((centers - np.asarray([cx, cy], np.float32)) ** 2)
                         .sum(axis=1)).astype(np.float32)
        valid[:n] &= (radius > lo - _F32_EPS) & (radius < hi)
    return slen, valid


def device_pairs(slen, valid_s, top_vals, rank_ok, ms: int):
    """Scene-dependent pair generation ON DEVICE (DefaultSearch /
    ConcentricRangeStrategy semantics, ``defaultsearch.cpp:29-49``).

    The host path uploads ``(S, P, 3)`` pair arrays every chunk — dead
    weight on the interconnect; here only per-line lengths + validity go
    up (computed host-side by :func:`scene_length_mask` so the f32 values
    are bit-identical to ``bank_pairs``) and the windows are computed
    where the data lives.  Table lookups are plain gathers: a
    matmul-expressed gather would run at the backend's default matmul
    precision (TF32 on a GPU), rounding the lengths ``closer`` compares and
    the indices above 2048.

    ``slen (N,)`` f32 line lengths; ``valid_s (N,)`` bool (padding and
    annulus-filtered lines False); ``top_vals (T, mt)`` f32 lengths of
    each template's top lines (``-inf`` beyond ``k_t``);
    ``rank_ok (T, mt)``.  Returns ``(sl (T, mt, ms) int32,
    win_ok (T, mt, ms) bool)`` — combined with ``ord_t``/``rank_ok`` this
    is the full pair grid in reference emplace order (template-major,
    rank-major, window-minor), bit-exact vs the host packing including
    the f32 tie rules of ``_closest_desc``.
    """
    import jax
    import jax.numpy as jnp

    n = slen.shape[0]
    t_count, mt = top_vals.shape
    pos = jnp.arange(n)
    n_eff = valid_s.sum()

    # stable desc sort, filtered-out lines last (-inf keys sort to the end)
    keys = jnp.where(valid_s, slen, -jnp.inf)
    order_s = jnp.argsort(-keys, stable=True)
    ssl = keys[order_s]

    v = top_vals.reshape(-1)                              # (T*mt,)
    i = jnp.sum((ssl[None, :] > v[:, None]) & (pos < n_eff)[None, :],
                axis=1)                                   # count > v

    ssl_f = jnp.where(jnp.isfinite(ssl), ssl, 0.0)
    at_i = ssl_f[jnp.clip(i, 0, n - 1)]
    at_p = ssl_f[jnp.clip(i - 1, 0, n - 1)]
    closer = jnp.abs(v - at_i) < jnp.abs(v - at_p)
    c = jnp.where(i == 0, 0,
                  jnp.where(i >= n_eff, n_eff - 1,
                            jnp.where(closer, i, i - 1)))

    begin = jnp.maximum(0, c - ms // 2)
    end = jnp.minimum(begin + ms, n_eff)
    begin = jnp.maximum(0, end - ms)

    # windows of order_s: sl[p, j] = order_s[begin[p] + j] (wrapping like
    # the slots beyond ``end``, which win_ok masks)
    slot = (begin[:, None] + jnp.arange(ms)[None, :]) % n
    sl = order_s[slot].astype(jnp.int32)                  # (T*mt, ms)
    win_ok = (begin[:, None] + jnp.arange(ms)[None, :]) < end[:, None]
    win_ok &= rank_ok.reshape(-1)[:, None] & (n_eff > 0)
    return (sl.reshape(t_count, mt, ms),
            win_ok.reshape(t_count, mt, ms))


def establish_search_strategy(strategy, tmpl_lines, scene_lines) -> np.ndarray:
    """Returns ``(M, 2)`` array of (tmpl_line_idx, scene_line_idx)."""
    from ..core import geometry as geo
    tmpl = geo.as_lines_np(tmpl_lines)
    scene = geo.as_lines_np(scene_lines)
    if tmpl.shape[0] == 0 or scene.shape[0] == 0:
        return np.zeros((0, 2), np.int64)

    if isinstance(strategy, ConcentricRangeStrategy):
        centers = (scene[:, 0:2] + scene[:, 2:4]) / 2
        cp = np.asarray(strategy.center_position, np.float32)
        radius = np.sqrt(((centers - cp) ** 2).sum(axis=1)).astype(np.float32)
        keep = (radius > (np.float32(strategy.low_boundary) - _F32_EPS)) & \
               (radius < np.float32(strategy.high_boundary))
        ids = np.nonzero(keep)[0]
        if len(ids) == 0:
            return np.zeros((0, 2), np.int64)
        return _pair_by_length(_lengths(tmpl), _lengths(scene[ids]), ids,
                               strategy.max_tmpl_lines, strategy.max_scene_lines)

    if isinstance(strategy, DefaultSearch):
        n = scene.shape[0]
        return _pair_by_length(_lengths(tmpl), _lengths(scene), np.arange(n),
                               strategy.max_tmpl_lines, strategy.max_scene_lines)

    raise TypeError(f"unknown search strategy {strategy!r}")


def filter_in_range(lines, center_position, min_radius, max_radius):
    """Reference ``concentricrange.h:73-84``: indices of lines whose centers
    fall in ``(min_radius - eps, max_radius)``."""
    from ..core import geometry as geo
    arr = geo.as_lines_np(lines)
    centers = (arr[:, 0:2] + arr[:, 2:4]) / 2
    cp = np.asarray(center_position, np.float32)
    radius = np.sqrt(((centers - cp) ** 2).sum(axis=1)).astype(np.float32)
    keep = (radius > (np.float32(min_radius) - _F32_EPS)) & (radius < np.float32(max_radius))
    return list(np.nonzero(keep)[0])
