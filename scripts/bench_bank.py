"""Large-bank benchmark: BASELINE.md config 3 ("10k-template bank x 1 scene").

Builds an N-template bank by augmenting the reference's bundled obj_01
templates (rotation x scale grid — the same kind of viewpoint densification
the reference's sampling stage performs), then matches ONE scene against the
whole bank through ``match_many(top_k=...)`` — exercising the pair-axis
chunking (``pipeline._PAIR_CHUNK``) and the device-side penalize+top-k path
at bank scale.  Reports templates scored per second.

Usage:
  python scripts/bench_bank.py [n_templates] [depth]     # default 10000, 30
  OPENFDCM_BANK_MESH=bank python scripts/bench_bank.py   # bank-sharded path
"""
import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ASSETS = "/root/reference/notebooks/assets"


def augment_bank(templates, n_target: int):
    """Densify a template bank to ``n_target`` by rotating/scaling copies."""
    out = list(templates)
    base = len(templates)
    i = 0
    while len(out) < n_target:
        src = np.asarray(templates[i % base], np.float32)
        step = i // base
        ang = 0.13 * (step + 1)
        scale = 1.0 + 0.05 * ((step % 7) - 3)
        c, s = np.cos(ang), np.sin(ang)
        r = np.asarray([[c, -s], [s, c]], np.float32) * np.float32(scale)
        aug = np.concatenate([src[:, 0:2] @ r.T, src[:, 2:4] @ r.T], axis=1)
        out.append(np.ascontiguousarray(aug, np.float32))
        i += 1
    return out[:n_target]


def main():
    n_target = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
    depth = int(sys.argv[2]) if len(sys.argv) > 2 else 30

    import openfdcm_tpu as of
    print(of.device_info(), file=sys.stderr)
    of.enable_compilation_cache()

    templates = [of.read(p) for p in sorted(
        glob.glob(f"{ASSETS}/obj_01/templates/*.tmpl"))]
    scene = of.read(f"{ASSETS}/obj_01/scene_0/camera_0.scene")
    bank_list = augment_bank(templates, n_target)
    lengths = of.get_template_lengths(bank_list)

    params = of.Dt3Params(depth, 5.0, 1.0, of.Distance.L2)
    searcher = of.DefaultSearch(4, 10)
    optimizer = of.BatchOptimize(10)

    mesh = None
    mesh_kind = os.environ.get("OPENFDCM_BANK_MESH", "")
    if mesh_kind:
        import jax
        from openfdcm_tpu.parallel import make_mesh
        mesh = make_mesh(axis_names=("bank",))
        print(f"# bank mesh over {len(jax.devices())} devices",
              file=sys.stderr)

    def run():
        if mesh is not None:
            from openfdcm_tpu.parallel import match_many_bank_sharded
            return match_many_bank_sharded(
                [scene], bank_list, params, searcher, optimizer, mesh=mesh,
                top_k=10, penalty=of.ExponentialPenalty(1.5),
                template_lengths=lengths)
        bank = of.prepare_templates(bank_list)
        return of.match_many([scene], bank, params, searcher, optimizer,
                             penalty=of.ExponentialPenalty(1.5),
                             template_lengths=lengths, top_k=10)

    t0 = time.perf_counter()
    res = run()
    warm = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = run()
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[1]
    tps = n_target / wall
    best = res[0][0]
    print(f"# warmup {warm:.1f}s; bank={n_target} depth={depth} "
          f"wall={wall:.3f}s best tmpl={best.tmpl_idx} "
          f"score={best.score:.6f}", file=sys.stderr)
    print(json.dumps({
        "metric": "bank_templates_per_s", "value": round(tps, 1),
        "unit": "templates/s", "bank_size": n_target, "depth": depth,
        "wall_s": round(wall, 3), "warmup_s": round(warm, 1),
        "sharded": bool(mesh_kind),
    }))


if __name__ == "__main__":
    main()
