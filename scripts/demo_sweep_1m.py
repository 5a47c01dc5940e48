"""BASELINE config 5 demonstration (single-host part): a REAL 1M-template
resumable sweep, with a mid-run kill + resume.

Builds a 1,000,000-template bank lazily (rotation x scale augmentation of
the reference's bundled obj_01 templates — the same viewpoint densification
the reference's sampling stage performs) and sweeps ONE scene against it
through :func:`openfdcm_tpu.resumable_sweep`.  The bank never resides in
host RAM: chunks are generated on demand through a sliceable lazy sequence.

Protocol (driven by this script in one invocation):
  1. run the sweep in a subprocess, SIGKILL it after ``--kill-after`` s;
  2. re-invoke the sweep in-process — it resumes at the first unprocessed
     chunk (checkpoint in ``--state``) and runs to completion;
  3. write ``chiprun_out/SWEEP_1M.json`` with throughput + the kill/resume
     evidence.

Usage:
  python scripts/demo_sweep_1m.py [--n 1000000] [--depth 2] [--chunk 4096]
                                  [--kill-after 120] [--state DIR]

The multi-host part of config 5 (bank sharding + all_gather re-rank) is
covered by ``parallel/bank.py`` + ``scripts/bench_multihost.py``; this
script demonstrates the 1M *scale* and the preemption story.
"""
import argparse
import glob
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ASSETS = "/root/reference/notebooks/assets"


class LazyAugmentedBank:
    """Sliceable 1M-template bank: item ``i`` is base template ``i % B``
    rotated/scaled by a grid keyed on ``i // B`` (matches
    ``scripts/bench_bank.py:augment_bank`` for the first copies)."""

    def __init__(self, base_templates, n_total: int):
        self.base = [np.asarray(t, np.float32) for t in base_templates]
        self.n = int(n_total)

    def __len__(self):
        return self.n

    def _one(self, i: int):
        b = len(self.base)
        src = self.base[i % b]
        step = i // b
        if step == 0:
            return src
        ang = 0.13 * step
        scale = 1.0 + 0.05 * (((step - 1) % 7) - 3)
        c, s = np.cos(ang), np.sin(ang)
        r = np.asarray([[c, -s], [s, c]], np.float32) * np.float32(scale)
        return np.ascontiguousarray(
            np.concatenate([src[:, 0:2] @ r.T, src[:, 2:4] @ r.T], axis=1),
            np.float32)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [self._one(i) for i in range(*idx.indices(self.n))]
        return self._one(int(idx))


def run_sweep(args):
    import jax
    jax.config.update("jax_platforms", "cpu")   # demo is CPU-sized shapes
    import openfdcm_tpu as of
    of.enable_compilation_cache()

    base = [of.read(p) for p in sorted(
        glob.glob(f"{ASSETS}/obj_01/templates/*.tmpl"))]
    scene = of.read(f"{ASSETS}/obj_01/scene_0/camera_0.scene")
    bank = LazyAugmentedBank(base, args.n)
    lengths = np.concatenate([
        np.asarray(of.get_template_lengths(bank[lo:min(lo + 65536, args.n)]),
                   np.float32)
        for lo in range(0, args.n, 65536)])

    params = of.Dt3Params(args.depth, 5.0, 1.0, of.Distance.L2)
    t0 = time.perf_counter()
    res = of.resumable_sweep(
        [scene], bank, params, of.DefaultSearch(4, 10), of.BatchOptimize(10),
        top_k=10, state_dir=args.state, penalty=of.ExponentialPenalty(1.5),
        template_lengths=lengths, chunk_size=args.chunk)
    wall = time.perf_counter() - t0
    best = res[0][0]
    return wall, best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--kill-after", type=float, default=120.0)
    ap.add_argument("--state", default="/tmp/sweep_1m_state")
    ap.add_argument("--child", action="store_true",
                    help="internal: run the sweep only (kill target)")
    args = ap.parse_args()

    if args.child:
        wall, best = run_sweep(args)
        print(json.dumps({"wall_s": round(wall, 1),
                          "best": [best.tmpl_idx, round(best.score, 6)]}))
        return

    os.makedirs(args.state, exist_ok=True)
    state_file = os.path.join(args.state, "state.json")
    if os.path.exists(state_file):
        os.remove(state_file)

    # phase 1: start, then SIGKILL mid-run
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child",
         "--n", str(args.n), "--depth", str(args.depth),
         "--chunk", str(args.chunk), "--state", args.state],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    time.sleep(args.kill_after)
    child.send_signal(signal.SIGKILL)
    child.wait()
    killed_chunks = 0
    if os.path.exists(state_file):
        with open(state_file) as f:
            killed_chunks = json.load(f)["done_chunks"]
    print(f"# killed after {args.kill_after}s at chunk {killed_chunks}",
          flush=True)

    # phase 2: resume to completion in-process
    t0 = time.perf_counter()
    wall2, best = run_sweep(args)
    total_chunks = -(-args.n // args.chunk)
    rec = {
        "metric": "sweep_1m_templates_per_s",
        "n_templates": args.n,
        "depth": args.depth,
        "chunk_size": args.chunk,
        "killed_at_chunk": killed_chunks,
        "resumed_chunks": total_chunks - killed_chunks,
        "resume_wall_s": round(wall2, 1),
        "templates_per_s_resumed": round(
            (total_chunks - killed_chunks) * args.chunk / max(wall2, 1e-9), 1),
        "best": [best.tmpl_idx, round(best.score, 6)],
        "backend": "cpu",
        "note": "single-host CPU demonstration of the 1M-template resumable "
                "sweep (BASELINE config 5 scale + preemption story); "
                "multi-host sharding is exercised by bench_multihost.py",
    }
    print(json.dumps(rec))
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out", "SWEEP_1M.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
