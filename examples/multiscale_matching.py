"""General template matching with a multi-scale template bank, mirroring the
reference's general example workflow
(``/root/reference/notebooks/general_template_matching_example.ipynb``):
a base template is expanded into a bank of scaled variants, matched into a
scene, and the best variant + pose is reported.  (The notebook detects scene
lines with OpenCV's FLD; here the scene is synthetic line data — the library
consumes line arrays from any detector.)

Also demonstrates ``ConcentricRangeStrategy``: restricting the search to an
annulus around an expected object location.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import openfdcm_tpu as of


def star_template(n_spokes=7, radius=40.0):
    """A star of line segments — asymmetric enough to pin rotation."""
    lines = []
    for i in range(n_spokes):
        a = 2 * np.pi * i / n_spokes + 0.17 * i / n_spokes
        r = radius * (0.6 + 0.4 * (i % 3) / 2)
        lines.append([0.0, 0.0, r * np.cos(a), r * np.sin(a)])
    return np.asarray(lines, np.float32)


def rigid(angle, tx, ty):
    c, s = np.cos(angle), np.sin(angle)
    return np.asarray([[c, -s, tx], [s, c, ty]], np.float32)


def transform(lines, mat):
    pts = lines.reshape(-1, 2) @ mat[:2, :2].T + mat[:2, 2]
    return pts.reshape(-1, 4).astype(np.float32)


def main():
    print("devices:", of.device_info())
    of.enable_compilation_cache()
    base = star_template()
    scales = [0.6, 0.8, 1.0, 1.25, 1.5]
    bank_np = [base * s for s in scales]

    true_scale, true_pose = 1.25, rigid(0.8, 140.0, 90.0)
    scene = transform(base * true_scale, true_pose)
    rng = np.random.default_rng(0)
    clutter = rng.uniform(0, 250, (30, 4)).astype(np.float32)
    scene = np.concatenate([scene, clutter])

    params = of.Dt3Params(depth=30, dt3_coeff=5.0, padding=1.5)
    searcher = of.DefaultSearch(3, 10)
    optimizer = of.BatchOptimize(5)
    lengths = of.get_template_lengths(bank_np)
    bank = of.prepare_templates(bank_np)

    t0 = time.perf_counter()
    fm = of.build_featuremap(scene, params)
    matches = of.search(of.DefaultMatch(), searcher, optimizer, fm, bank, scene)
    best = of.sort_matches(of.penalize(of.ExponentialPenalty(1.5), matches, lengths))[0]
    print(f"matched in {time.perf_counter() - t0:.2f}s (incl. compile)")
    print(f"best variant: scale={scales[best.tmpl_idx]} (true {true_scale}), "
          f"score={best.score:.4f}")
    print(f"recovered pose:\n{np.round(best.transform, 3)}")
    print(f"true pose:\n{np.round(true_pose, 3)}")

    # Same search restricted to an annulus around the (known) object center.
    center = tuple(true_pose[:2, 2])
    annulus = of.ConcentricRangeStrategy(3, 10, center, 0.0, 80.0)
    matches = of.search(of.DefaultMatch(), annulus, optimizer, fm, bank, scene)
    best2 = of.sort_matches(of.penalize(of.ExponentialPenalty(1.5), matches, lengths))[0]
    print(f"annulus search best: scale={scales[best2.tmpl_idx]}, "
          f"score={best2.score:.4f}, {len(matches)} candidates")


if __name__ == "__main__":
    main()
