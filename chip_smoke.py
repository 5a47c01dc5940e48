"""Smoke run of the matching engine's main path on an NVIDIA GPU.

Drives ``build_featuremap_batch`` -> ``match_many`` / ``match_many_async``
-> ``MatcherService`` at the upstream pose notebook's shapes (4 objects,
421 templates, 40 scenes on the 640 canvas; seeded synthetic data from
``tests/synthetic.py``) with the notebook's configuration, and checks the
results against plain references: the CPU backend, the numpy walk oracle
(``tests/oracle.py``) and the host pair generator.

    python chip_smoke.py [--seed 0]        # one card, phases 1-7
    python chip_smoke.py --chips 4         # the multi-device paths only

Every phase prints its walls (cold = first call with compilation, warm =
a second call) on its own line; the last line is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``.  Any failed
check exits non-zero without that line.  Without a GPU, or run outside a
checkout of the repository, it exits non-zero before doing any work.
"""
import argparse
import functools
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# golden tolerance (tests/test_goldens.py): score and transform
SCORE_ATOL, SCORE_RTOL, TRANSFORM_ATOL = 1e-5, 1e-4, 1e-4


class SmokeFailure(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _import_repo():
    """The repository's package and test helpers, from this checkout only."""
    sys.path.insert(0, REPO)
    try:
        import openfdcm_tpu as of
        from tests import oracle, synthetic, walk_parity
    except ImportError as e:
        raise SmokeFailure(f"not a checkout of the repository: {e}") from e
    for mod in (of, oracle):
        check(os.path.abspath(mod.__file__).startswith(REPO + os.sep),
              f"{mod.__name__} imported from outside the checkout")
    return of, synthetic, walk_parity


def _matches_close(a, b) -> bool:
    import numpy as np
    return (a.tmpl_idx == b.tmpl_idx
            and abs(a.score - b.score) <= SCORE_ATOL + SCORE_RTOL * abs(b.score)
            and np.allclose(a.transform, b.transform, rtol=0,
                            atol=TRANSFORM_ATOL))


def _same(a_lists, b_lists) -> bool:
    import numpy as np
    return all(len(a) == len(b) and all(
        x.tmpl_idx == y.tmpl_idx and x.score == y.score
        and np.array_equal(x.transform, y.transform) for x, y in zip(a, b))
        for a, b in zip(a_lists, b_lists))


def _ulp_diff(a, b) -> int:
    import numpy as np
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.max(np.abs(ia - ib))) if ia.size else 0


class Workload:
    """The pose data set and the notebook's configuration."""

    def __init__(self, of, synthetic, seed: int):
        import numpy as np
        self.of = of
        self.objects = synthetic.make_pose_dataset(seed)
        self.params = of.Dt3Params(30, 5.0, 1.0, of.Distance.L2)
        self.searcher = of.DefaultSearch(4, 10)
        self.optimizer = of.BatchOptimize(10)
        self.penalty = of.ExponentialPenalty(1.5)
        self.top_k = 10
        # one (template count, line count) bucket for all four banks, so
        # every object runs the same compiled programs
        self.lmax_to = -(-max(max(len(t) for t in o.templates)
                              for o in self.objects) // 8) * 8
        self.count_to = -(-max(len(o.templates) for o in self.objects)
                          // 32) * 32
        self.lengths = []
        for o in self.objects:
            ln = np.zeros(self.count_to, np.float32)
            ln[: len(o.templates)] = of.get_template_lengths(o.templates)
            self.lengths.append(ln)

    def bank(self, i):
        return self.of.prepare_templates(self.objects[i].templates,
                                         lmax_to=self.lmax_to,
                                         count_to=self.count_to)

    def kwargs(self, i):
        return dict(penalty=self.penalty, template_lengths=self.lengths[i],
                    top_k=self.top_k)

    def match(self, i, scenes, bank=None, mesh=None):
        return self.of.match_many(scenes, bank or self.bank(i), self.params,
                                  self.searcher, self.optimizer, mesh=mesh,
                                  **self.kwargs(i))


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _stages(static: tuple):
    """Jitted column pass, L2² row pass (before the sqrt) and L2 distance
    of a seed batch, for the build's static arguments ``static``."""
    import jax
    from openfdcm_tpu.core import dt
    from openfdcm_tpu.core.types import Distance
    from openfdcm_tpu.matching.featuremap import _indicator_batch

    @jax.jit
    def run(lines, mask, lhw):
        ind = _indicator_batch(lines, mask, lhw, **dict(static))
        g = dt.column_pass(ind)
        return (g, dt.row_pass(g, metric=Distance.L2_SQUARED),
                dt.row_pass(g, metric=Distance.L2))
    return run


def phase_build(w, cpu):
    import jax
    import numpy as np
    from openfdcm_tpu.matching.pipeline import _batch_inputs
    of = w.of
    scenes0 = w.objects[0].scenes
    b0, cold = timed(lambda: jax.block_until_ready(
        of.build_featuremap_batch(scenes0, w.params).dt3))
    _, warm = timed(lambda: jax.block_until_ready(
        of.build_featuremap_batch(scenes0, w.params).dt3))
    gpu = [b0] + [of.build_featuremap_batch(o.scenes, w.params).dt3
                  for o in w.objects[1:]]
    shape = tuple(b0.shape)
    check(shape == (10, 30, 640, 640), f"build shape {shape}")
    check(all(bool(np.isfinite(np.asarray(b)).all()) for b in gpu),
          "non-finite DT3 values")

    def stages(scene):
        """Integer-exact column pass and L2² row pass before the sqrt."""
        lines, mask, lhw, _, _, st = _batch_inputs([scene], w.params, 128)
        return _stages(tuple((k, st[k]) for k in (
            "depth", "phys_h", "phys_w", "max_points", "points_cap")))(
            lines, mask, lhw)

    worst_ulp = sqrt_ulp = 0
    max_abs = 0.0
    for i, o in enumerate(w.objects):
        scene = o.scenes[0]
        g_gpu, r_gpu, l2_gpu = (np.asarray(x) for x in stages(scene))
        with jax.default_device(cpu):
            g_cpu, r_cpu, l2_cpu = (np.asarray(x) for x in stages(scene))
            ref = np.asarray(of.build_featuremap_batch([scene], w.params).dt3[0])
        check(np.array_equal(g_gpu, g_cpu), f"object {i}: column pass differs")
        check(np.array_equal(r_gpu, r_cpu), f"object {i}: L2² row pass differs")
        sqrt_ulp = max(sqrt_ulp, _ulp_diff(l2_gpu, l2_cpu))
        got = np.asarray(gpu[i][0])
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-3,
                                   err_msg=f"object {i}: DT3 vs CPU")
        worst_ulp = max(worst_ulp, _ulp_diff(got, ref))
        max_abs = max(max_abs, float(np.max(np.abs(got - ref))))
    log("build", ok=True, shape=shape, cold_s=round(cold, 3),
        warm_s=round(warm, 4), column_pass="bit-equal",
        row_pass_l2sq="bit-equal", l2_sqrt_max_ulp_diff=sqrt_ulp,
        dt3_max_abs_diff=max_abs, dt3_max_ulp_diff=worst_ulp)


def phase_match(w, cpu):
    import jax
    banks = [w.bank(i) for i in range(4)]
    sync = []

    def run_all():
        return [w.match(i, o.scenes, banks[i])
                for i, o in enumerate(w.objects)]

    sync, cold = timed(run_all)
    _, warm_sync = timed(run_all)

    def run_async():
        collects = [w.of.match_many_async(
            o.scenes, banks[i], w.params, w.searcher, w.optimizer,
            **w.kwargs(i)) for i, o in enumerate(w.objects)]
        return [c() for c in collects]

    piped, warm = timed(run_async)
    check(all(_same(a, b) for a, b in zip(piped, sync)),
          "match_many_async differs from match_many")
    n_scenes = sum(len(o.scenes) for o in w.objects)
    planted_first = sum(
        bool(r) and r[0].tmpl_idx == int(t)
        for o, res in zip(w.objects, sync) for r, t in zip(res, o.planted))
    check(planted_first >= 0.9 * n_scenes,
          f"planted template first in {planted_first}/{n_scenes} scenes")
    for i, o in enumerate(w.objects):
        with jax.default_device(cpu):
            ref = w.match(i, o.scenes[:1])[0]
        got = sync[i][0]
        check(len(got) >= 3 and len(ref) >= 3, f"object {i}: < 3 matches")
        for a, b in zip(got[:3], ref[:3]):
            check(_matches_close(a, b),
                  f"object {i} top-3 vs CPU: ({a.tmpl_idx}, {a.score}) vs "
                  f"({b.tmpl_idx}, {b.score})")
    log("match", ok=True, scenes=n_scenes, cold_s=round(cold, 3),
        warm_sync_s=round(warm_sync, 4), warm_async_s=round(warm, 4),
        scenes_per_s_warm_async=round(n_scenes / warm, 3),
        async_equals_sync=True, planted_first=f"{planted_first}/{n_scenes}",
        top3_vs_cpu="4/4 objects")
    return sync


def _specials(of):
    """The failure values the reference's walks rely on: NaN and ±inf
    through min/max/argmin and the walk bounds (out of bounds -> NaN, null
    alignment -> inf)."""
    import jax.numpy as jnp
    from openfdcm_tpu.matching.featuremap import minmax_translation_raw
    x = jnp.asarray([jnp.nan, 1.0, -jnp.inf, jnp.inf, 0.0], jnp.float32)
    tmpl = jnp.asarray([[[2.0, 2.0, 9.0, 4.0]], [[-3.0, 1.0, 5.0, 5.0]]],
                       jnp.float32)
    align = jnp.asarray([[0.0, 0.0], [1.0, 0.0]], jnp.float32)
    neg, pos = minmax_translation_raw(tmpl, align, (20.0, 20.0),
                                      jnp.zeros(2, jnp.float32))
    return [jnp.minimum(x, 0.5), jnp.maximum(x, 0.5), jnp.min(x),
            jnp.max(x[1:]), jnp.argmin(x[1:]), jnp.argmax(x), neg, pos]


def phase_walk(w, walk_parity, cpu):
    import jax
    import numpy as np
    of = w.of
    got = [np.asarray(v) for v in _specials(of)]
    with jax.default_device(cpu):
        want = [np.asarray(v) for v in _specials(of)]
    check(all(np.array_equal(a, b, equal_nan=True) for a, b in zip(got, want)),
          f"NaN/inf failure values differ from the CPU: {got} vs {want}")
    check(np.isinf(got[6][0]) and np.isnan(got[6][1]),
          f"walk-bound failure values {got[6]}")
    res = []
    t0 = time.perf_counter()
    for i in (0, 1):
        scene = w.objects[i].scenes[0]
        fmap = of.build_featuremap(scene, w.params)
        res.append(walk_parity.compare_walks(
            fmap, w.objects[i].templates, scene, w.searcher, w.optimizer,
            n_sample=256, seed=i))
    wall = time.perf_counter() - t0
    total = {k: sum(r[k] for r in res) for k in
             ("checked", "valid", "validity_mismatches", "score_mismatches",
              "translation_mismatches")}
    check(total["checked"] == 512 and total["valid"] > 0, f"walks {total}")
    for k in ("validity_mismatches", "score_mismatches",
              "translation_mismatches"):
        check(total[k] == 0, f"walk vs oracle: {total}")
    log("walk_vs_oracle", ok=True, wall_s=round(wall, 3), **total,
        nan_inf_specials="equal to CPU",
        max_score_diff=max(r["max_score_diff"] for r in res),
        max_translation_diff=max(r["max_translation_diff"] for r in res))


def phase_pairs(w):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from openfdcm_tpu.matching import search
    ms = w.searcher.max_scene_lines
    dev = jax.jit(search.device_pairs, static_argnums=(4,))
    n_pairs = 0
    t0 = time.perf_counter()
    for o in w.objects:
        bank = w.of.prepare_templates(o.templates)
        lens, counts = bank.lengths_np, bank.counts_np
        ord_t, k_t = search.bank_line_table(lens, counts,
                                            w.searcher.max_tmpl_lines)
        lens_m = np.where(np.arange(lens.shape[1])[None, :] < counts[:, None],
                          lens, -np.inf)
        top = np.take_along_axis(lens_m, ord_t.astype(np.int64), axis=1)
        rank_ok = np.arange(ord_t.shape[1])[None, :] < k_t[:, None]
        for scene in o.scenes:
            host = search.bank_pairs(w.searcher, lens, counts, scene)
            slen, valid = search.scene_length_mask(
                scene, -(-scene.shape[0] // 128) * 128)
            sl, wok = (np.asarray(x) for x in dev(
                jnp.asarray(slen), jnp.asarray(valid),
                jnp.asarray(top.astype(np.float32)), jnp.asarray(rank_ok),
                ms))
            t, r, j = np.nonzero(wok)
            got = np.stack([t, ord_t[t, r], sl[t, r, j]], axis=1)
            check(np.array_equal(got.astype(np.int32), host),
                  "device_pairs differs from bank_pairs")
            n_pairs += host.shape[0]
    log("pairs", ok=True, scenes=sum(len(o.scenes) for o in w.objects),
        pairs=n_pairs, exact=True, wall_s=round(time.perf_counter() - t0, 3))


def phase_served(w, sync):
    scenes = w.objects[0].scenes[:8]
    svc = w.of.MatcherService(w.bank(0), w.params, w.searcher, w.optimizer,
                              max_batch=8, **w.kwargs(0))
    try:
        _, warm_s = timed(lambda: svc.warmup(scenes[:2]))
        t0 = time.perf_counter()
        futs = [svc.submit(s) for s in scenes]
        got = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
    finally:
        svc.close()
    check(len(got) == 8, "served answers")
    bitequal = _same(got, sync[0][:8])
    for a_list, b_list in zip(got, sync[0][:8]):
        check(len(a_list) == len(b_list) and all(
            _matches_close(a, b) for a, b in zip(a_list, b_list)),
            "MatcherService differs from match_many")
    log("served", ok=True, requests=8, warmup_s=round(warm_s, 3),
        wall_s=round(wall, 4), equals_match_many=True,
        bit_equal=bitequal)


def phase_kernel(w):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import bench_rowpass
    rec = bench_rowpass.measure(w.objects[0].scenes, w.params,
                                ["xla_dense", "triton_banded"], reps=5)
    k, x = rec["forms"]["triton_banded"], rec["forms"]["xla_dense"]
    check(k["exact"], f"row-pass kernel differs from XLA: {k['max_abs_diff']}")
    log("kernel", ok=True, kernel="minplus_rows_banded (Pallas, Triton)",
        plain="xla_dense", rows=rec["rows"], max_abs_diff=k["max_abs_diff"],
        kernel_rowpass_s=round(k["rowpass_s"], 6),
        xla_rowpass_s=round(x["rowpass_s"], 6),
        kernel_build_s=round(k["build_s"], 6),
        xla_build_s=round(x["build_s"], 6))


def run_one_card(of, synthetic, walk_parity, seed):
    import jax
    cpu = jax.devices("cpu")[0]
    w = Workload(of, synthetic, seed)
    log("config", depth=30, coeff=5.0, padding=1.0, distance="L2",
        search="DefaultSearch(4,10)", optimizer="BatchOptimize(10)",
        penalty="ExponentialPenalty(1.5)", top_k=10, seed=seed,
        templates=sum(len(o.templates) for o in w.objects),
        scenes=sum(len(o.scenes) for o in w.objects),
        row_pass="gpu: Pallas Triton banded kernel; cpu: XLA chunked scan",
        walk="XLA lockstep walk", pairs="device_pairs (gathers)")
    phase_build(w, cpu)
    sync = phase_match(w, cpu)
    phase_walk(w, walk_parity, cpu)
    phase_pairs(w)
    phase_served(w, sync)
    phase_kernel(w)


# ---------------------------------------------------------------------------
# four cards: the multi-device paths against their one-card results
# ---------------------------------------------------------------------------

def run_four_cards(of, synthetic, seed):
    import jax
    import numpy as np
    from openfdcm_tpu.parallel import (make_mesh, match_many_bank_sharded,
                                       build_featuremap_spatial,
                                       search_spatial)
    devs = jax.devices()
    check(len(devs) == 4, f"--chips 4 needs 4 devices, found {len(devs)}")
    w = Workload(of, synthetic, seed)
    o = w.objects[0]
    bank = w.bank(0)
    one, one_s = timed(lambda: w.match(0, o.scenes, bank))

    mesh = make_mesh(shape=(4,), axis_names=("scene",))
    dp, cold = timed(lambda: w.match(0, o.scenes, bank, mesh=mesh))
    _, warm = timed(lambda: w.match(0, o.scenes, bank, mesh=mesh))
    for a_list, b_list in zip(dp, one):
        check(len(a_list) == len(b_list) and all(
            _matches_close(a, b) for a, b in zip(a_list, b_list)),
            "scene-parallel match_many differs from one card")
    log("scene_parallel", ok=True, mesh=dict(mesh.shape), scenes=len(dp),
        cold_s=round(cold, 3), warm_s=round(warm, 4),
        one_card_s=round(one_s, 4), equals_one_card=True)

    bmesh = make_mesh(shape=(4,), axis_names=("bank",))

    def bank_run():
        return match_many_bank_sharded(
            o.scenes, o.templates, w.params, w.searcher, w.optimizer,
            mesh=bmesh, top_k=w.top_k, penalty=w.penalty,
            template_lengths=w.lengths[0][:len(o.templates)])
    bs, cold = timed(bank_run)
    _, warm = timed(bank_run)
    for a_list, b_list in zip(bs, one):
        check(len(a_list) == len(b_list) and all(
            _matches_close(a, b) for a, b in zip(a_list, b_list)),
            "bank-sharded match differs from one card")
    log("bank_sharded", ok=True, mesh=dict(bmesh.shape), scenes=len(bs),
        cold_s=round(cold, 3), warm_s=round(warm, 4), equals_one_card=True)

    smesh = make_mesh(shape=(4,), axis_names=("rows",))
    scene = o.scenes[0]

    def spatial():
        fmap = build_featuremap_spatial(scene, w.params, mesh=smesh)
        return fmap, search_spatial(w.searcher, w.optimizer, fmap,
                                    o.templates, scene, mesh=smesh)
    (sfm, sres), cold = timed(spatial)
    _, warm = timed(spatial)
    ref_fm = of.build_featuremap(scene, w.params)
    ref = of.search(of.DefaultMatch(), w.searcher, w.optimizer, ref_fm,
                    o.templates, scene)
    fw, fh = ref_fm.feature_size
    check(np.array_equal(np.asarray(sfm.dt3)[:, :fh, :fw],
                         np.asarray(ref_fm.dt3)[:, :fh, :fw]),
          "spatial DT3 differs from one card")
    check(len(sres) == len(ref) and all(
        _matches_close(a, b) for a, b in zip(sres, ref)),
        "spatial search differs from one card")
    log("spatial", ok=True, mesh=dict(smesh.shape), matches=len(sres),
        cold_s=round(cold, 3), warm_s=round(warm, 4), dt3="bit-equal",
        equals_one_card=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args()
    t_start = time.perf_counter()
    try:
        of, synthetic, walk_parity = _import_repo()
        import jax
        info = of.device_info()
        check(info["platform"] == "gpu",
              f"no GPU: JAX runs on {info['platform']} ({info['kind']})")
        of.enable_compilation_cache()
        log("device", ok=True, **{k: repr(v) for k, v in info.items()},
            jax=jax.__version__)
        print(of.profiling.card_info(), flush=True)
        if args.chips == 4:
            run_four_cards(of, synthetic, args.seed)
        else:
            run_one_card(of, synthetic, walk_parity, args.seed)
    except (SmokeFailure, AssertionError, RuntimeError) as e:
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    log("total", wall_s=round(time.perf_counter() - t_start, 3))
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
