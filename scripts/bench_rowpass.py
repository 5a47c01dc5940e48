"""Time the forms of the DT3 L2 row pass on the accelerator.

Forms: the CPU-tuned chunked scan (``dt._minplus_chunked_rows``), the dense
broadcast-reduce (``dt._minplus_dense_rows``, XLA's plain form) and the
banded Pallas Triton kernel (``ops.minplus_gpu``).  Input: the column-pass
distances of one pose batch (seeded synthetic data, depth 30, 640 canvas).
Each form is checked bit-equal to the dense form, timed alone, and timed
inside the whole ``build_featuremap_batch``.  ``chip_smoke.py`` calls
:func:`measure` for its kernel phase.

    python scripts/bench_rowpass.py [--seed 0] [--reps 5] [--scenes 10]
        [--depth 30] [--forms xla_chunked,xla_dense,triton_banded] [--cpu]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import openfdcm_tpu as of  # noqa: E402
from openfdcm_tpu.core import dt  # noqa: E402
from openfdcm_tpu.matching import featuremap as fm  # noqa: E402
from openfdcm_tpu.matching.pipeline import _batch_inputs  # noqa: E402

FORMS = {
    "xla_chunked": lambda r, g: dt._minplus_chunked_rows(r),
    "xla_dense": lambda r, g: dt._minplus_dense_rows(r),
    "triton_banded": dt._minplus_banded_gpu,
}


def _time(fn, reps):
    jax.block_until_ready(fn())                       # compile + warm
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)), walls


def column_rows(scenes, params):
    """``(rows, g)``: the squared column-pass distances ``(S·D·H, W)`` of a
    scene batch and the column-pass distances they come from."""
    lines, mask, lhw, _, _, st = _batch_inputs(scenes, params, 128)
    ind = jax.jit(lambda a, b, c: fm._indicator_batch(
        a, b, c, depth=st["depth"], phys_h=st["phys_h"], phys_w=st["phys_w"],
        max_points=st["max_points"], points_cap=st["points_cap"]))(
        jnp.asarray(lines), jnp.asarray(mask), jnp.asarray(lhw))
    g = jax.jit(dt.column_pass)(ind)
    return jnp.minimum(g * g, jnp.inf).reshape(-1, st["phys_w"]), g


def measure(scenes, params, forms, reps: int) -> dict:
    """Per form: bit-equality with the dense form, the row pass alone and
    the whole batched build (cold = first call after clearing JAX's
    caches), median and all walls in seconds."""
    rows, g = column_rows(scenes, params)
    ref = np.asarray(jax.jit(FORMS["xla_dense"])(rows, g))
    rec = {}
    try:
        for name in forms:
            fn = jax.jit(FORMS[name])
            out = np.asarray(fn(rows, g))
            r = 2 if name == "xla_chunked" else reps
            med, walls = _time(lambda: fn(rows, g), r)
            dt._gpu_rows = FORMS[name]         # the build's GPU form
            jax.clear_caches()
            t0 = time.perf_counter()
            jax.block_until_ready(of.build_featuremap_batch(scenes, params).dt3)
            cold = time.perf_counter() - t0
            bmed, bwalls = _time(
                lambda: of.build_featuremap_batch(scenes, params).dt3, r)
            rec[name] = dict(
                max_abs_diff=float(np.max(np.abs(out - ref))),
                exact=bool(np.array_equal(out, ref)), rowpass_s=med,
                rowpass_walls=walls, build_s=bmed, build_walls=bwalls,
                build_cold_s=cold)
    finally:
        dt._gpu_rows = dt._minplus_banded_gpu
        jax.clear_caches()
    return dict(rows=list(rows.shape),
                active_sources=float(jnp.mean(jnp.isfinite(rows))),
                forms=rec)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--scenes", type=int, default=10)
    ap.add_argument("--depth", type=int, default=30)
    ap.add_argument("--forms", default=",".join(FORMS))
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU (no timing claims)")
    args = ap.parse_args()

    from tests import synthetic
    info = of.device_info(require_accelerator=not args.cpu)
    print(json.dumps(info))
    print(of.profiling.card_info())
    of.enable_compilation_cache()
    obj = synthetic.make_object(args.seed, 0, n_scenes=args.scenes)
    params = of.Dt3Params(args.depth, 5.0, 1.0, of.Distance.L2)
    rec = measure(obj.scenes, params, args.forms.split(","), args.reps)
    print(json.dumps({"rowpass_forms": rec, "device": info}))


if __name__ == "__main__":
    main()
