"""Pose-estimation template matching, mirroring the reference notebook
(``/root/reference/notebooks/pose_extimation_example.ipynb``): for each scene
of an object, match its pre-rendered template bank and report the top
matches and per-stage timings — then run the multiview 6-DOF stage the
reference only documents (README.md:84-98): per-view FDCM, cross-view
triangulation + voting, and pose composition.

The bundled assets have one camera per scene, so the 6-DOF stage
demonstrates both README paths on scene_0: (a) single-view + known support
plane, and (b) two-view triangulation against a second view synthesized by
lifting camera_0's scene onto that plane and reprojecting it into a
calibrated camera_1 (geometrically consistent with the plane hypothesis).

Usage: python examples/pose_estimation.py [obj_01|obj_02|obj_03|obj_04]
"""
import glob
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import openfdcm_tpu as of
from openfdcm_tpu import pose

ASSETS = "/root/reference/notebooks/assets"


def multiview_6dof(scene0, templates, params, searcher, optimizer, lengths):
    """The stage after matching: triangulate + vote + compose (README's
    procedure steps 3-5)."""
    # Virtual calibration: camera_0 fronto-parallel at depth Z over the
    # scene plane z=0; camera_1 laterally displaced by one baseline.
    f = z = 800.0
    baseline = 60.0
    k = np.asarray([[f, 0, 0], [0, f, 0], [0, 0, 1]], np.float32)
    cams = [pose.Camera(k, np.eye(3, dtype=np.float32),
                        np.asarray([-cx, 0.0, z], np.float32))
            for cx in (0.0, baseline)]

    # Lift camera_0 lines onto the plane, render camera_1's view.
    import jax.numpy as jnp
    arr = of.geometry.as_lines_np(scene0)
    kj, rj, tj = (jnp.asarray(a) for a in (cams[0].k, cams[0].r, cams[0].t))
    plane = jnp.asarray([0, 0, 1, 0], jnp.float32)
    o, d1 = pose.backproject_rays(jnp.asarray(arr[:, 0:2]), kj, rj, tj)
    _, d2 = pose.backproject_rays(jnp.asarray(arr[:, 2:4]), kj, rj, tj)
    p1 = np.asarray(pose.intersect_plane(o, d1, plane))
    p2 = np.asarray(pose.intersect_plane(o, d2, plane))
    lines3d = np.concatenate([p1, p2], axis=1).astype(np.float32)
    scene1 = pose.project_lines(lines3d, cams[1])

    # Per-view FDCM in ONE batched dispatch, then vote + triangulate.
    views = [arr, scene1]
    matches = of.match_many(views, templates, params, searcher, optimizer,
                            penalty=of.ExponentialPenalty(1.5),
                            template_lengths=lengths, top_k=8)
    dets = pose.multiview_detections(matches, templates, cams, k=8,
                                     eps_px=10.0)
    # Template viewpoint rotations come from the sampling renderer; the
    # bundled assets don't ship them, so use canonical identity here.
    rots = [np.eye(3)] * len(templates)
    if dets:
        best = dets[0]
        p6 = pose.six_dof_pose(best, matches, rots, cams)
        print(f"multiview: {len(dets)} voted detections; best tmpl "
              f"{best.tmpl_idx} votes={best.votes} rms={best.rms:.2f}px")
        print("6-DOF pose (world from object):")
        print(np.array_str(p6, precision=3, suppress_small=True))
    else:
        print("multiview: no cross-view consensus")
    pp = pose.plane_pose(matches[0][0], templates, rots, cams[0],
                         np.asarray([0, 0, 1, 0], np.float32))
    print("single-view + plane-hypothesis pose:")
    print(np.array_str(pp, precision=3, suppress_small=True))


def main(obj: str = "obj_01"):
    print("devices:", of.device_info())
    of.enable_compilation_cache()
    t0 = time.perf_counter()
    tmpl_paths = sorted(glob.glob(f"{ASSETS}/{obj}/templates/*.tmpl"))
    scene_paths = sorted(glob.glob(f"{ASSETS}/{obj}/scene_*/camera_0.scene"))
    templates = of.io.read_batch(tmpl_paths)
    scenes = of.io.read_batch(scene_paths)
    print(f"loaded {len(templates)} templates, {len(scenes)} scenes "
          f"in {time.perf_counter() - t0:.2f}s")

    # Notebook configuration (pose notebook cell 13).
    params = of.Dt3Params(depth=30, dt3_coeff=5.0, padding=1.0,
                          distance=of.Distance.L2)
    searcher = of.DefaultSearch(4, 10)
    optimizer = of.BatchOptimize(10)
    penalizer = of.ExponentialPenalty(1.5)
    lengths = of.get_template_lengths(templates)
    bank = of.prepare_templates(templates)

    t0 = time.perf_counter()
    fms = of.build_featuremap_batch(scenes, params)
    all_matches = of.search_batch(of.DefaultMatch(), searcher, optimizer,
                                  fms, bank, scenes)
    for path, matches in zip(scene_paths, all_matches):
        best = of.sort_matches(of.penalize(penalizer, matches, lengths))[:3]
        tops = ", ".join(f"tmpl {m.tmpl_idx} (score {m.score:.4f})" for m in best)
        print(f"{os.path.basename(os.path.dirname(path))}: {tops}")
    wall = time.perf_counter() - t0
    print(f"{len(scenes)} scenes in {wall:.2f}s "
          f"({len(scenes) / wall:.2f} scenes/s, incl. compile on first run)")

    # README.md:84-98 steps 3-5 on scene_0's cameras.
    multiview_6dof(scenes[0], templates, params, searcher, optimizer, lengths)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "obj_01")
