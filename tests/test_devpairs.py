"""On-device pair generation (``search.device_pairs``) parity vs the host
path: the pair grid must be BIT-EXACT (same windows, same f32 tie rules as
``_closest_desc``), and ``match_many(top_k=...)`` must return the same
matches with pair upload removed."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import openfdcm_tpu as of
from openfdcm_tpu.matching.search import (
    bank_pairs, bank_line_table, device_pairs, scene_length_mask,
    DefaultSearch, ConcentricRangeStrategy)
from tests.utils import create_lines, make_rotation, apply_transform


def _grid_to_packed(sl, wok, ord_t, ms):
    rows = []
    t_count, mt = ord_t.shape
    for t in range(t_count):
        for r in range(mt):
            for j in range(ms):
                if wok[t, r, j]:
                    rows.append((t, ord_t[t, r], sl[t, r, j]))
    return np.asarray(rows, np.int32).reshape(-1, 3)


def _tables(lens, counts, mt):
    ord_t, k_t = bank_line_table(lens, counts, mt)
    lens_m = np.where(np.arange(lens.shape[1])[None, :] < counts[:, None],
                      lens, -np.inf)
    top_vals = np.take_along_axis(
        lens_m, ord_t.astype(np.int64), axis=1).astype(np.float32)
    rank_ok = np.arange(ord_t.shape[1])[None, :] < k_t[:, None]
    return ord_t, top_vals, rank_ok


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_pairs_bitexact(seed):
    rng = np.random.default_rng(seed)
    t_count, lmax, n = int(rng.integers(3, 25)), int(rng.integers(2, 10)), \
        int(rng.integers(3, 40))
    counts = rng.integers(1, lmax + 1, t_count)
    lens = rng.uniform(1, 50, (t_count, lmax)).astype(np.float32)
    lens[lens < 12] = np.float32(7.5)          # force length ties
    scene = rng.uniform(0, 100, (n, 4)).astype(np.float32)
    strat = DefaultSearch(4, 7)

    host = bank_pairs(strat, lens, counts.astype(np.int64), scene)
    ord_t, top_vals, rank_ok = _tables(lens, counts, strat.max_tmpl_lines)
    slen, valid = scene_length_mask(scene, n + 5)
    sl, wok = jax.jit(device_pairs, static_argnums=(4,))(
        jnp.asarray(slen), jnp.asarray(valid), jnp.asarray(top_vals),
        jnp.asarray(rank_ok), 7)
    dev = _grid_to_packed(np.asarray(sl), np.asarray(wok), ord_t, 7)
    np.testing.assert_array_equal(dev, host)


def test_device_pairs_annulus_bitexact():
    rng = np.random.default_rng(3)
    counts = rng.integers(1, 9, 12)
    lens = rng.uniform(1, 50, (12, 8)).astype(np.float32)
    scene = rng.uniform(0, 100, (25, 4)).astype(np.float32)
    strat = ConcentricRangeStrategy(3, 5, (50.0, 50.0), 10.0, 60.0)

    host = bank_pairs(strat, lens, counts.astype(np.int64), scene)
    ord_t, top_vals, rank_ok = _tables(lens, counts, 3)
    slen, valid = scene_length_mask(scene, 32, (50.0, 50.0, 10.0, 60.0))
    sl, wok = jax.jit(device_pairs, static_argnums=(4,))(
        jnp.asarray(slen), jnp.asarray(valid), jnp.asarray(top_vals),
        jnp.asarray(rank_ok), 5)
    dev = _grid_to_packed(np.asarray(sl), np.asarray(wok), ord_t, 5)
    np.testing.assert_array_equal(dev, host)


def test_match_many_devpairs_equals_host():
    templates = [np.asarray(create_lines(4 + (i % 5), 40.0 + 10.0 * (i % 3)))
                 for i in range(8)]
    scenes = []
    for j in range(3):
        mat = np.concatenate([make_rotation(0.3 * j),
                              np.full((2, 1), 5.0 + j, np.float32)], axis=1)
        scenes.append(apply_transform(templates[j], mat))
    params = of.Dt3Params(4, 5.0, 2.2, of.Distance.L2)
    lengths = of.get_template_lengths(templates)
    kw = dict(penalty=of.ExponentialPenalty(1.5), template_lengths=lengths,
              top_k=5)

    old = os.environ.get("OPENFDCM_TPU_DEVPAIRS")
    try:
        os.environ["OPENFDCM_TPU_DEVPAIRS"] = "0"
        host = of.match_many(scenes, templates, params,
                             of.DefaultSearch(4, 10), of.BatchOptimize(10),
                             **kw)
        os.environ["OPENFDCM_TPU_DEVPAIRS"] = "1"
        dev = of.match_many(scenes, templates, params,
                            of.DefaultSearch(4, 10), of.BatchOptimize(10),
                            **kw)
    finally:
        if old is None:
            os.environ.pop("OPENFDCM_TPU_DEVPAIRS", None)
        else:
            os.environ["OPENFDCM_TPU_DEVPAIRS"] = old
    for h, d in zip(host, dev):
        assert len(h) == len(d) > 0
        np.testing.assert_allclose(
            sorted(m.score for m in h), sorted(m.score for m in d),
            rtol=1e-6, atol=1e-8)
        assert sorted((round(m.score, 6), m.tmpl_idx) for m in h) == \
            sorted((round(m.score, 6), m.tmpl_idx) for m in d)


@pytest.mark.skipif(os.environ.get("OPENFDCM_SLOW_TESTS") != "1",
                    reason="slow integration lane (OPENFDCM_SLOW_TESTS=1); "
                           "core behavior covered by sibling tests")
def test_match_many_devpairs_scene_mesh():
    from openfdcm_tpu.parallel import make_mesh
    templates = [np.asarray(create_lines(4 + (i % 5), 40.0 + 10.0 * (i % 3)))
                 for i in range(8)]
    scenes = []
    for j in range(6):
        mat = np.concatenate([make_rotation(0.3 * j),
                              np.full((2, 1), 5.0 + j, np.float32)], axis=1)
        scenes.append(apply_transform(templates[j % 8], mat))
    params = of.Dt3Params(4, 5.0, 2.2, of.Distance.L2)
    lengths = of.get_template_lengths(templates)
    kw = dict(penalty=of.ExponentialPenalty(1.5), template_lengths=lengths,
              top_k=5)
    single = of.match_many(scenes, templates, params, of.DefaultSearch(4, 10),
                           of.BatchOptimize(10), **kw)
    mesh = make_mesh(shape=(2,), axis_names=("scene",))
    meshed = of.match_many(scenes, templates, params, of.DefaultSearch(4, 10),
                           of.BatchOptimize(10), mesh=mesh, **kw)
    for h, d in zip(single, meshed):
        assert len(h) == len(d) > 0
        np.testing.assert_allclose(
            sorted(m.score for m in h), sorted(m.score for m in d),
            rtol=1e-5, atol=1e-7)
        assert sorted((round(m.score, 5), m.tmpl_idx) for m in h) == \
            sorted((round(m.score, 5), m.tmpl_idx) for m in d)


def test_match_many_empty_scene():
    templates = [np.asarray(create_lines(5, 40.0))]
    scenes = [np.zeros((0, 4), np.float32), templates[0] + np.float32(3.0)]
    for flag in ("1", "0"):
        os.environ["OPENFDCM_TPU_DEVPAIRS"] = flag
        try:
            res = of.match_many(scenes, templates,
                                of.Dt3Params(4, 5.0, 2.2, of.Distance.L2),
                                of.DefaultSearch(4, 10), of.BatchOptimize(10),
                                top_k=3)
        finally:
            os.environ.pop("OPENFDCM_TPU_DEVPAIRS", None)
        assert res[0] == [] and len(res[1]) > 0


def test_match_many_devpairs_scene_mesh_small():
    """Default-lane variant of the devpairs scene-mesh parity test
    (ADVICE r3 #1): 2 scenes on a 2-device mesh, small depth."""
    from openfdcm_tpu.parallel import make_mesh
    templates = [np.asarray(create_lines(4 + i, 40.0 + 10.0 * i))
                 for i in range(3)]
    scenes = []
    for j in range(2):
        mat = np.concatenate([make_rotation(0.3 * j),
                              np.full((2, 1), 5.0 + j, np.float32)], axis=1)
        scenes.append(apply_transform(templates[j], mat))
    params = of.Dt3Params(3, 5.0, 2.2, of.Distance.L2)
    lengths = of.get_template_lengths(templates)
    kw = dict(penalty=of.ExponentialPenalty(1.5), template_lengths=lengths,
              top_k=4)
    single = of.match_many(scenes, templates, params, of.DefaultSearch(3, 6),
                           of.BatchOptimize(5), **kw)
    mesh = make_mesh(shape=(2,), axis_names=("scene",))
    meshed = of.match_many(scenes, templates, params, of.DefaultSearch(3, 6),
                           of.BatchOptimize(5), mesh=mesh, **kw)
    for h, d in zip(single, meshed):
        assert len(h) == len(d) > 0
        np.testing.assert_allclose(
            sorted(m.score for m in h), sorted(m.score for m in d),
            rtol=1e-5, atol=1e-7)
        assert sorted((round(m.score, 5), m.tmpl_idx) for m in h) == \
            sorted((round(m.score, 5), m.tmpl_idx) for m in d)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_pairs_bitexact_large_scene_near_ties(seed):
    """More than 2048 scene lines (indices a matmul-expressed gather could
    round) and lengths one ulp apart (what a rounded ``closer`` compare
    would confuse): the device grid must still equal ``bank_pairs``."""
    rng = np.random.default_rng(100 + seed)
    n = 2500
    base = rng.choice(np.float32([10.0, 17.5, 24.25, 31.0]), n)
    ulps = rng.integers(-2, 3, n)
    slen = np.nextafter(base, np.where(ulps < 0, -np.inf, np.inf)
                        ).astype(np.float32)
    slen = np.where(ulps == 0, base, slen).astype(np.float32)
    ang = rng.uniform(0, np.pi, n)
    scene = np.zeros((n, 4), np.float32)
    scene[:, 2] = slen * np.cos(ang)
    scene[:, 3] = slen * np.sin(ang)
    t_count, lmax = 20, 6
    counts = rng.integers(1, lmax + 1, t_count)
    lens = rng.choice(np.float32([10.0, 17.5, 24.25, 31.0, 5.0]),
                      (t_count, lmax)).astype(np.float32)
    strat = DefaultSearch(4, 10)

    host = bank_pairs(strat, lens, counts.astype(np.int64), scene)
    ord_t, top_vals, rank_ok = _tables(lens, counts, strat.max_tmpl_lines)
    slen_h, valid = scene_length_mask(scene, 2560)
    sl, wok = jax.jit(device_pairs, static_argnums=(4,))(
        jnp.asarray(slen_h), jnp.asarray(valid), jnp.asarray(top_vals),
        jnp.asarray(rank_ok), 10)
    dev = _grid_to_packed(np.asarray(sl), np.asarray(wok), ord_t, 10)
    assert host.shape[0] > 0 and host[:, 2].max() > 2048
    np.testing.assert_array_equal(dev, host)
