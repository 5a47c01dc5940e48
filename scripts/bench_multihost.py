"""Multi-process (multi-controller) scaling harness — SURVEY §2.4's
multi-host row, runnable on one machine.

Launches N JAX processes (``jax.distributed.initialize`` over a local
coordinator), each owning 4 virtual CPU devices, and runs the sharded
candidate optimizer + ``global_topk`` over the global 2D mesh — the same
program a multi-host deployment runs, with collectives crossing the process
boundary.  Checks that every process's global top-k equals the
single-process result bit-for-bit (SURVEY §7.3 determinism), and reports
walls.

On several hosts the same worker runs with ``initialize()`` given each
process's coordinator address and id; efficiency numbers on one shared CPU
are contention-bound and only the correctness signal matters.

Usage:  python scripts/bench_multihost.py [n_processes]
"""
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = 17677
DEV_PER_PROC = 4


def worker(pid: int, nproc: int):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count={DEV_PER_PROC}").strip()
    import jax
    # importing openfdcm_tpu is backend-free (no module-level jnp
    # constants), so the library's initialize wrapper is safe here
    from openfdcm_tpu.parallel import initialize
    initialize(coordinator_address=f"127.0.0.1:{PORT}",
               num_processes=nproc, process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    import openfdcm_tpu as of
    from openfdcm_tpu.parallel import (make_mesh, global_topk,
                                       optimize_candidates_sharded_batch)

    assert len(jax.devices()) == nproc * DEV_PER_PROC, jax.devices()

    # Identical per-process problem construction (replicated host compute).
    rng = np.random.default_rng(3)
    n_lines, c = 10, 64
    tmpl = np.zeros((n_lines, 4), np.float32)
    tmpl[:, 0:2] = rng.uniform(5, 40, (n_lines, 2)).astype(np.float32)
    tmpl[:, 2:4] = tmpl[:, 0:2] + rng.uniform(3, 12, (n_lines, 2)).astype(np.float32)
    fm = of.build_featuremap(tmpl, of.Dt3Params(4, 5.0, 2.2, of.Distance.L2))
    d, ph, pw = fm.dt3.shape
    w, h = fm.feature_size

    s = 2
    lines = np.tile(tmpl[None, None], (s, c, 1, 1)).astype(np.float32)
    mask = np.ones((s, c, n_lines), bool)
    ang = rng.uniform(0, 2 * np.pi, (s, c)).astype(np.float32)
    av = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    dt3_flat = np.tile(np.asarray(fm.dt3).reshape(1, -1), (s, 1))
    tr = np.tile(np.asarray(fm.scene_translation)[None], (s, 1))
    fs = np.tile(np.asarray([[float(w), float(h)]], np.float32), (s, 1))

    kwargs = dict(mode="batch", window=10, dense_steps=1)
    hw = (ph, pw)

    def run(mesh):
        scores, trans, valid = optimize_candidates_sharded_batch(
            mesh, dt3_flat, fm.angles, tr, hw, fs, lines, mask, av, **kwargs)
        return scores, trans, valid

    # Global mesh across ALL processes: scene x cand.
    gmesh = make_mesh(shape=(s, (nproc * DEV_PER_PROC) // s),
                      axis_names=("scene", "cand"))
    r = run(gmesh)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    r = run(gmesh)
    jax.block_until_ready(r)
    t_global = time.perf_counter() - t0
    scores, _, valid = r

    # Single-process reference on one local device (addressable data only).
    lmesh = make_mesh(shape=(1, 1), axis_names=("scene", "cand"),
                      devices=jax.local_devices()[:1])
    ref = run(lmesh)
    s_ref, v_ref = np.asarray(ref[0]), np.asarray(ref[2])

    # Each process verifies the shards it owns against the reference —
    # bit-equality across the process boundary.
    ok = True
    for shard in scores.addressable_shards:
        ok &= bool(np.array_equal(np.asarray(shard.data), s_ref[shard.index]))

    # Cross-process deterministic global ranking (replicated np input is
    # sharded to each process's local devices by jit; replicated output is
    # fully addressable everywhere).
    cand_mesh = make_mesh(shape=(nproc * DEV_PER_PROC,), axis_names=("cand",))
    masked = np.where(v_ref[0], s_ref[0], np.inf)
    order = np.lexsort((np.arange(masked.shape[0]), masked))[:8]
    sk, ik = global_topk(cand_mesh, jnp.asarray(s_ref[0]),
                         jnp.asarray(v_ref[0]), k=8)
    ok &= bool(np.array_equal(np.asarray(ik), order) and
               np.allclose(np.asarray(sk), masked[order]))
    print(json.dumps({"pid": pid, "ok": ok,
                      "t_global_s": round(t_global, 4),
                      "devices": len(jax.devices())}), flush=True)
    if not ok:
        sys.exit(1)


def main():
    nproc = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    procs = []
    # Each worker owns DEV_PER_PROC virtual CPU devices and nothing else:
    # pinning the CPU keeps the workers off any accelerator on the host
    # (one process per card), and PYTHONPATH makes the repo importable.
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    for pid in range(nproc):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "worker",
             str(pid), str(nproc)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs, fails = [], 0
    for p in procs:
        out, err = p.communicate(timeout=560)
        outs.append(out.strip().splitlines()[-1] if out.strip() else err[-400:])
        fails += p.returncode != 0
    for o in outs:
        print(f"# {o}", file=sys.stderr)
    ok = fails == 0
    rec = json.loads(outs[0]) if ok else {}
    print(json.dumps({
        "metric": "multihost_topk_bitexact", "value": 1.0 if ok else 0.0,
        "unit": "bool", "processes": nproc,
        "devices": rec.get("devices"),
        "t_global_s": rec.get("t_global_s"),
    }))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]))
    else:
        main()
