"""Scene-batched pipeline must reproduce the one-at-a-time API per scene."""
import os
import numpy as np
import jax.numpy as jnp
import pytest

import openfdcm_tpu as of
from tests.utils import create_lines, make_rotation


def _make_scene(tmpl, angle, shift):
    rot = make_rotation(angle)
    scene = np.array(of.geometry.transform(jnp.asarray(tmpl), jnp.asarray(rot)))
    return scene + np.float32(shift)


def test_batch_matches_single():
    tmpl = np.asarray(create_lines(10, 80))
    scenes = [_make_scene(tmpl, np.pi, 3.0), _make_scene(tmpl, np.pi / 3, 7.0)]
    params = of.Dt3Params(4, 5.0, 2.2, of.Distance.L2)
    bank = of.prepare_templates([tmpl])
    searcher = of.DefaultSearch(4, 10)
    optimizer = of.BatchOptimize(10)

    batch = of.build_featuremap_batch(scenes, params, pad_to=64)
    batched = of.search_batch(of.DefaultMatch(), searcher, optimizer,
                              batch, bank, scenes)

    for i, scene in enumerate(scenes):
        # Single-scene path on the SAME physical canvas/buckets for bit parity.
        fmap = batch.featuremap(i)
        single = of.search(of.DefaultMatch(), searcher, optimizer, fmap,
                           bank, scene)
        assert len(single) == len(batched[i]) > 0
        for a, b in zip(single, batched[i]):
            assert a.tmpl_idx == b.tmpl_idx
            assert a.score == b.score
            np.testing.assert_allclose(a.transform, b.transform,
                                       rtol=1e-6, atol=1e-5)


def test_batch_featuremap_matches_single_build():
    tmpl = np.asarray(create_lines(8, 60))
    scenes = [_make_scene(tmpl, 0.7, 4.0), _make_scene(tmpl, -0.4, 9.0)]
    params = of.Dt3Params(4, 5.0, 1.5, of.Distance.L2)
    batch = of.build_featuremap_batch(scenes, params, pad_to=64)
    for i, scene in enumerate(scenes):
        w, h = batch.feature_sizes[i]
        single = of.build_featuremap(scene, params, pad_to=None)
        np.testing.assert_array_equal(
            np.asarray(batch.dt3[i])[:, :h, :w],
            np.asarray(single.dt3)[:, :h, :w])
        np.testing.assert_array_equal(np.asarray(batch.scene_translations[i]),
                                      np.asarray(single.scene_translation))


def test_match_many_scene_mesh_matches_single_device():
    from openfdcm_tpu.parallel import make_mesh
    tmpl = np.asarray(create_lines(10, 80))
    scenes = [_make_scene(tmpl, np.pi, 3.0), _make_scene(tmpl, np.pi / 3, 7.0),
              _make_scene(tmpl, -0.5, 11.0)]
    params = of.Dt3Params(4, 5.0, 2.2, of.Distance.L2)
    bank = of.prepare_templates([tmpl])
    searcher = of.DefaultSearch(4, 10)
    optimizer = of.BatchOptimize(10)
    mesh = make_mesh(shape=(2,), axis_names=("scene",))

    plain = of.match_many(scenes, bank, params, searcher, optimizer)
    sharded = of.match_many(scenes, bank, params, searcher, optimizer, mesh=mesh)
    assert len(plain) == len(sharded) == 3
    for a_list, b_list in zip(plain, sharded):
        assert len(a_list) == len(b_list) > 0
        for a, b in zip(a_list, b_list):
            assert a.tmpl_idx == b.tmpl_idx
            assert a.score == b.score
            np.testing.assert_allclose(a.transform, b.transform,
                                       rtol=1e-6, atol=1e-5)


def test_match_many_device_topk_matches_host_ranking():
    tmpl = np.asarray(create_lines(10, 80))
    scenes = [_make_scene(tmpl, np.pi, 3.0), _make_scene(tmpl, 0.9, 6.0)]
    params = of.Dt3Params(4, 5.0, 2.2, of.Distance.L2)
    bank = of.prepare_templates([tmpl, tmpl * 0.7])
    searcher = of.DefaultSearch(4, 10)
    optimizer = of.BatchOptimize(10)
    pen = of.ExponentialPenalty(1.5)
    lengths = of.get_template_lengths([tmpl, tmpl * 0.7])

    topk = of.match_many(scenes, bank, params, searcher, optimizer,
                         penalty=pen, template_lengths=lengths, top_k=5)
    full = of.match_many(scenes, bank, params, searcher, optimizer,
                         penalty=pen, template_lengths=lengths)
    for t_list, f_list in zip(topk, full):
        ranked = of.sort_matches(f_list)[:5]
        assert len(t_list) == len(ranked) > 0
        for a, b in zip(t_list, ranked):
            assert a.tmpl_idx == b.tmpl_idx
            # device pow vs numpy pow may differ in the last ulp
            assert np.isclose(a.score, b.score, rtol=1e-6)
            np.testing.assert_allclose(a.transform, b.transform,
                                       rtol=1e-6, atol=1e-5)


@pytest.mark.skipif(os.environ.get("OPENFDCM_SLOW_TESTS") != "1",
                    reason="slow integration lane (OPENFDCM_SLOW_TESTS=1); "
                           "core behavior covered by sibling tests")
def test_device_topk_with_pair_chunking(monkeypatch):
    """Top-k must stay exact when the pair axis splits into multiple
    dispatches and templates span several lmax buckets."""
    from openfdcm_tpu.matching import pipeline as P
    monkeypatch.setattr(P, "_PAIR_CHUNK", 16)   # force many pair chunks

    rng = np.random.default_rng(7)
    templates = []
    for i in range(6):
        n = int(rng.integers(4, 20))            # spans lmax buckets 8/16/24
        t = np.zeros((n, 4), np.float32)
        t[:, 0:2] = rng.uniform(0, 30, (n, 2))
        t[:, 2:4] = t[:, 0:2] + rng.uniform(2, 12, (n, 2))
        templates.append(t)
    scenes = [templates[0] + np.float32(4.0), templates[3] + np.float32(6.0)]

    params = of.Dt3Params(4, 5.0, 2.0, of.Distance.L2)
    bank = of.prepare_templates(templates)
    searcher = of.DefaultSearch(3, 6)
    optimizer = of.BatchOptimize(5)
    pen = of.ExponentialPenalty(1.5)
    lengths = of.get_template_lengths(templates)

    topk = of.match_many(scenes, bank, params, searcher, optimizer,
                         penalty=pen, template_lengths=lengths, top_k=7)
    full = of.match_many(scenes, bank, params, searcher, optimizer,
                         penalty=pen, template_lengths=lengths)
    for t_list, f_list in zip(topk, full):
        ranked = of.sort_matches(f_list)[:7]
        assert len(t_list) == len(ranked) > 0
        for a, b in zip(t_list, ranked):
            assert a.tmpl_idx == b.tmpl_idx
            assert np.isclose(a.score, b.score, rtol=1e-6)


def test_device_topk_with_pair_chunking_small(monkeypatch):
    """Default-lane variant of the pair-chunking parity test (ADVICE r3 #1):
    a small bank that still spans two lmax buckets and forces >1 pair chunk
    per dispatch."""
    from openfdcm_tpu.matching import pipeline as P
    monkeypatch.setattr(P, "_PAIR_CHUNK", 8)

    rng = np.random.default_rng(11)
    templates = []
    for n in (4, 6, 12):                      # two lmax buckets (8 / 16)
        t = np.zeros((n, 4), np.float32)
        t[:, 0:2] = rng.uniform(0, 25, (n, 2))
        t[:, 2:4] = t[:, 0:2] + rng.uniform(2, 10, (n, 2))
        templates.append(t)
    scenes = [templates[0] + np.float32(4.0)]

    params = of.Dt3Params(3, 5.0, 2.0, of.Distance.L2)
    bank = of.prepare_templates(templates)
    searcher = of.DefaultSearch(3, 4)
    optimizer = of.BatchOptimize(5)
    pen = of.ExponentialPenalty(1.5)
    lengths = of.get_template_lengths(templates)

    topk = of.match_many(scenes, bank, params, searcher, optimizer,
                         penalty=pen, template_lengths=lengths, top_k=5)
    full = of.match_many(scenes, bank, params, searcher, optimizer,
                         penalty=pen, template_lengths=lengths)
    for t_list, f_list in zip(topk, full):
        ranked = of.sort_matches(f_list)[:5]
        assert len(t_list) == len(ranked) > 0
        for a, b in zip(t_list, ranked):
            assert a.tmpl_idx == b.tmpl_idx
            assert np.isclose(a.score, b.score, rtol=1e-6)
            np.testing.assert_allclose(a.transform, b.transform,
                                       rtol=1e-6, atol=1e-5)


def test_match_many_async_equals_sync():
    """match_many_async must dispatch everything up front and produce
    byte-identical results to match_many (same args)."""
    rng = np.random.default_rng(3)
    templates = []
    for n in (4, 7):
        t = np.zeros((n, 4), np.float32)
        t[:, 0:2] = rng.uniform(0, 28, (n, 2))
        t[:, 2:4] = t[:, 0:2] + rng.uniform(2, 10, (n, 2))
        templates.append(t)
    scenes = [templates[0] + np.float32(3.0), templates[1] + np.float32(6.0)]
    params = of.Dt3Params(3, 5.0, 2.0, of.Distance.L2)
    bank = of.prepare_templates(templates)
    lengths = of.get_template_lengths(templates)
    kw = dict(penalty=of.ExponentialPenalty(1.5), template_lengths=lengths,
              top_k=5)
    sync = of.match_many(scenes, bank, params, of.DefaultSearch(3, 4),
                         of.BatchOptimize(5), **kw)
    collect = of.match_many_async(scenes, bank, params, of.DefaultSearch(3, 4),
                                  of.BatchOptimize(5), **kw)
    got = collect()
    assert len(got) == len(sync)
    for a_list, b_list in zip(got, sync):
        assert len(a_list) == len(b_list) > 0
        for a, b in zip(a_list, b_list):
            assert a.tmpl_idx == b.tmpl_idx and a.score == b.score
            np.testing.assert_array_equal(a.transform, b.transform)
