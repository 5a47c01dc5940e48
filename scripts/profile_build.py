"""Trace the pose workload's device work and reduce it to time per layer.

Runs one warm DT3 build of a 10-scene pose batch and one warm
``match_many`` over those scenes under ``jax.profiler``, then sums the
device duration of every GPU kernel event by the named scope it carries
(``seed_scatter``, ``distance_transform``, ``propagate``,
``line_integral``; ``pairs``, ``candidates``, ``walk``,
``penalize_topk``) and by kernel name.  The summary goes to stdout and
``chiprun_out/profile_build.json``.

    python scripts/profile_build.py [--seed 0]
"""
import argparse
import collections
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

import openfdcm_tpu as of  # noqa: E402

SCOPES = ("seed_scatter", "distance_transform", "propagate", "line_integral",
          "pairs", "candidates", "walk", "penalize_topk")


def reduce_trace(path: str) -> dict:
    """Device time per scope and per kernel name from an ``.xplane.pb``.

    Busy time is the union of kernel intervals on each device plane; a
    kernel is attributed to the first scope named in any of its stats."""
    pd = jax.profiler.ProfileData.from_file(path)
    by_scope = collections.Counter()
    by_name = collections.Counter()
    intervals = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                dur = ev.duration_ns
                text = " ".join([ev.name] + [str(v) for _, v in ev.stats])
                scope = next((s for s in SCOPES if s in text), "other")
                by_scope[scope] += dur
                by_name[ev.name] += dur
                intervals.append((ev.start_ns, ev.start_ns + dur))
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (max(b for _, b in intervals) - min(a for a, _ in intervals)
              if intervals else 0.0)
    return dict(busy_ms=busy / 1e6, window_ms=window / 1e6,
                by_scope_ms={k: v / 1e6 for k, v in by_scope.most_common()},
                top_kernels_ms={k: v / 1e6
                                for k, v in by_name.most_common(25)})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    from tests import synthetic
    info = of.device_info(require_accelerator=True)
    print(json.dumps(info))
    print(of.profiling.card_info())
    of.enable_compilation_cache()
    obj = synthetic.make_object(args.seed, 0)
    params = of.Dt3Params(30, 5.0, 1.0, of.Distance.L2)
    bank = of.prepare_templates(obj.templates)
    lengths = of.get_template_lengths(obj.templates)

    def build():
        return jax.block_until_ready(
            of.build_featuremap_batch(obj.scenes, params).dt3)

    def match():
        return of.match_many(obj.scenes, bank, params, of.DefaultSearch(4, 10),
                             of.BatchOptimize(10),
                             penalty=of.ExponentialPenalty(1.5),
                             template_lengths=lengths, top_k=10)

    out = {"device": info, "card": of.profiling.card_info()}
    for name, fn in (("build", build), ("match_many", match)):
        fn()                                        # compile + warm
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as d:
            jax.profiler.start_trace(d)
            fn()
            jax.profiler.stop_trace()
            path = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                             recursive=True)[0]
            out[name] = dict(wall_ms=wall * 1e3, **reduce_trace(path))
        print(json.dumps({name: out[name]}), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_build.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
