"""Official benchmark: the reference's headline workload.

Pose-estimation pipeline from the reference notebook
(``notebooks/pose_extimation_example.ipynb`` cell 13): per scene, build the
DT3 feature map (depth=30, L2, padding=1.0) and run ``search`` with
DefaultSearch(4, 10) + BatchOptimize(10) over the full template bank, then
penalize + sort.  The reference reports 22 FPS (45 ms per scene) on an
Intel i7-14700 — that is ``vs_baseline``'s denominator.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...} with
the device it ran on.  It needs an accelerator and the notebook's assets
under ``ASSETS``; without either it exits non-zero and prints no result.
"""
import glob
import json
import os
import sys
import time

import numpy as np

BASELINE_SCENES_PER_S = 22.0
ASSETS = "/root/reference/notebooks/assets"


def protocol(info: dict) -> dict:
    """The measurement itself.  Raises on failure.

    All FOUR pose objects are measured (the reference workload is 40
    scenes across obj_01..04, ``pose_extimation_example.ipynb`` cell 13);
    the headline is the aggregate scenes/s over one pass of all 40, with
    per-object rates recorded.  The four banks are padded to one shared
    (template count, line count) bucket so every object runs the same
    compiled programs — warmup compiles once, not four times.
    """
    import numpy as np
    import openfdcm_tpu as of

    objs = ["obj_01", "obj_02", "obj_03", "obj_04"]
    n_loops = 3

    data = {}
    for obj in objs:
        templates = [of.read(p) for p in sorted(
            glob.glob(f"{ASSETS}/{obj}/templates/*.tmpl"))]
        scene_paths = sorted(
            glob.glob(f"{ASSETS}/{obj}/scene_*/camera_0.scene"))
        scenes = [of.read(p) for p in scene_paths]
        if not templates or not scenes:
            raise FileNotFoundError(f"assets not found under {ASSETS}/{obj}")
        data[obj] = (templates, scene_paths, scenes)

    lmax_to = -(-max(max(len(t) for t in ts) for ts, _, _ in data.values())
                // 8) * 8
    count_to = -(-max(len(ts) for ts, _, _ in data.values()) // 32) * 32
    params = of.Dt3Params(30, 5.0, 1.0, of.Distance.L2)
    optimizer = of.BatchOptimize(10)
    searcher = of.DefaultSearch(4, 10)

    runs = {}
    for obj, (templates, scene_paths, scenes) in data.items():
        bank = of.prepare_templates(templates, lmax_to=lmax_to,
                                    count_to=count_to)
        lengths = np.zeros(count_to, np.float32)
        lengths[: len(templates)] = of.get_template_lengths(templates)

        def run(scene_list, bank=bank, lengths=lengths):
            return of.match_many(scene_list, bank, params, searcher,
                                 optimizer,
                                 penalty=of.ExponentialPenalty(1.5),
                                 template_lengths=lengths, top_k=10)

        def submit(scene_list, bank=bank, lengths=lengths):
            return of.match_many_async(scene_list, bank, params, searcher,
                                       optimizer,
                                       penalty=of.ExponentialPenalty(1.5),
                                       template_lengths=lengths, top_k=10)
        runs[obj] = (run, submit, scene_paths, scenes)

    cache_dir = of.enable_compilation_cache()
    n_cache0 = len(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else 0
    t0 = time.perf_counter()
    results = {obj: run(scenes)     # warmup: compile every shape bucket once
               for obj, (run, _, _, scenes) in runs.items()}
    warm = time.perf_counter() - t0
    n_cache1 = len(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else 0

    # Per-object rates: one sequential (unpipelined) pass each.
    per_obj = {}
    for obj, (run, _, scene_paths, scenes) in runs.items():
        t0 = time.perf_counter()
        results[obj] = run(scenes)
        per_obj[obj] = (len(scenes), time.perf_counter() - t0)

    # Headline: PIPELINED passes over all 40 scenes — every object's build
    # and search are enqueued before the first result is fetched, so the
    # device never idles on host-side conversion (of.match_many_async;
    # identical results, verified per loop against the sequential pass
    # above).  The reference's 22 FPS is likewise a sustained-throughput
    # figure (pose_extimation_example.ipynb cell 13).
    walls = []
    for _ in range(n_loops):
        t0 = time.perf_counter()
        collects = {obj: submit(scenes) for obj, (_, submit, _, scenes)
                    in runs.items()}
        piped = {obj: c() for obj, c in collects.items()}
        walls.append(time.perf_counter() - t0)
        for obj in piped:           # identical results to sequential
            a = [(m.tmpl_idx, m.score) for mm in piped[obj] for m in mm]
            b = [(m.tmpl_idx, m.score) for mm in results[obj] for m in mm]
            if a != b:
                raise RuntimeError(f"pipelined results diverged for {obj}")

    n_total = sum(n for n, _ in per_obj.values())
    sps = n_total / sorted(walls)[len(walls) // 2]
    first = results[objs[0]]
    print(f"# warmup {warm:.1f}s; {n_total} scenes aggregate {sps:.2f}/s; "
          f"best[0]: tmpl={first[0][0].tmpl_idx} "
          f"score={first[0][0].score:.6f}", file=sys.stderr)

    # Golden ranking parity on the hardware results (VERDICT r2 #5, r3 #5):
    # the TOP-3 matches of every scene of every object must agree with the
    # committed CPU goldens (see BASELINE.md "Golden provenance").
    golden_bad = None
    gpath = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests", "goldens", "pose_best.json")
    if os.path.exists(gpath):
        with open(gpath) as f:
            goldens = json.load(f)
        golden_bad = 0
        for obj, (run, _, scene_paths, scenes) in runs.items():
            if obj not in results:
                continue
            for path, matches in zip(scene_paths, results[obj]):
                key = os.path.relpath(path, ASSETS)
                want = goldens.get(key)
                if not want or not matches:
                    continue
                bad = False
                for m, w in zip(matches[:3], want[:3]):
                    if (m.tmpl_idx != w["tmpl_idx"]
                            or abs(m.score - w["score"])
                            > 1e-5 + 1e-4 * abs(w["score"])):
                        bad = True
                        print(f"# GOLDEN MISMATCH {key}: tmpl {m.tmpl_idx} "
                              f"score {m.score:.6f} vs golden "
                              f"{w['tmpl_idx']} {w['score']:.6f}",
                              file=sys.stderr)
                golden_bad += bad

    rec = {
        "metric": "pose_pipeline_scenes_per_s",
        "value": round(sps, 3),
        "unit": "scenes/s",
        "vs_baseline": round(sps / BASELINE_SCENES_PER_S, 3),
        "warmup_s": round(warm, 1),
        # 0 new entries = fully warm cache (load-latency only); >0 = that
        # many executables compiled fresh this run (VERDICT r5 #3)
        "cache_entries_written": n_cache1 - n_cache0,
        "golden_mismatches": golden_bad,
        "per_object": {o: round(n / w, 3) for o, (n, w) in per_obj.items()},
        "device": info,
        "card": of.profiling.card_info(),
    }
    return rec


def main():
    import openfdcm_tpu as of
    info = of.device_info(require_accelerator=True)
    print(json.dumps(protocol(info)))


if __name__ == "__main__":
    main()
