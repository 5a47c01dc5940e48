"""General template matching on real images, mirroring the reference
notebook (``/root/reference/notebooks/general_template_matching_example.ipynb``):
detect line segments in a photographed scene and two template images, build
a multi-scale template bank (25 + 20 scale variants), and match.

The notebook uses OpenCV's FastLineDetector (ximgproc); this environment
ships OpenCV without ximgproc, so the LSD detector stands in — the detector
is outside the library either way (the matcher consumes line arrays from any
source).
"""
import os
import sys
import time

import cv2
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import openfdcm_tpu as of

ASSETS = "/root/reference/notebooks/assets"


def detect_lines(image_path, scale=0.5):
    img = cv2.imread(image_path)
    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    lsd = cv2.createLineSegmentDetector()
    lines = lsd.detect(gray)[0]
    if lines is None:
        return np.zeros((0, 4), np.float32)
    return (lines.reshape(-1, 4) * scale).astype(np.float32)   # (N, 4)


def main():
    print("devices:", of.device_info())
    of.enable_compilation_cache()
    tmpl1 = detect_lines(f"{ASSETS}/ulaval_laboratoire_robotique_tmpl.png")
    tmpl2 = detect_lines(f"{ASSETS}/logo_innoptech.png")
    scene = detect_lines(f"{ASSETS}/ulaval_laboratoire_robotique_scene.png")
    print(f"detected lines: tmpl1={len(tmpl1)} tmpl2={len(tmpl2)} scene={len(scene)}")

    # Multi-scale banks, as in the notebook (cell 13).
    templates1 = [tmpl1 * s for s in np.linspace(0.1, 0.8, 25)]
    templates2 = [tmpl2 * s for s in np.linspace(0.3, 1.0, 20)]
    all_templates = templates1 + templates2

    params = of.Dt3Params(depth=30, dt3_coeff=5.0, padding=1.0,
                          distance=of.Distance.L2)
    searcher = of.DefaultSearch(3, 10)
    optimizer = of.BatchOptimize(5)
    lengths = of.get_template_lengths(all_templates)
    bank = of.prepare_templates(all_templates)

    t0 = time.perf_counter()
    fm = of.build_featuremap(scene, params)
    matches = of.search(of.DefaultMatch(), searcher, optimizer, fm, bank, scene)
    penalized = of.penalize(of.ExponentialPenalty(1.5), matches, lengths)
    ranked = of.sort_matches(penalized)
    wall = time.perf_counter() - t0
    print(f"matched {len(all_templates)} template variants "
          f"({len(matches)} candidates) in {wall:.2f}s (incl. compile on first run)")

    best = ranked[0]
    group = "tmpl1" if best.tmpl_idx < len(templates1) else "tmpl2"
    print(f"best: {group} variant {best.tmpl_idx}, score={best.score:.5f}")
    print(f"pose:\n{np.round(best.transform, 3)}")
    best2 = next(m for m in ranked
                 if (m.tmpl_idx >= len(templates1)) != (best.tmpl_idx >= len(templates1)))
    group2 = "tmpl1" if best2.tmpl_idx < len(templates1) else "tmpl2"
    print(f"best {group2}: variant {best2.tmpl_idx}, score={best2.score:.5f}")


if __name__ == "__main__":
    main()
