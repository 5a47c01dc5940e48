"""Seeded pose-estimation data at the shapes of the upstream pose notebook.

The upstream notebook (``notebooks/pose_extimation_example.ipynb``) matches
4 objects of ~105 templates each (421 in all, 29-33 lines at most per
template) against 10 scenes per object of a few hundred lines each, on a
canvas that pads to the 640 bucket.  Its assets are not part of this
repository, so the smoke run, the benchmark and the tests generate data of
the same shapes here, from a seed:

- each object is a random wireframe of ``_BASE_LINES`` segments;
- each template is one "view" of its object: a random subset of the
  wireframe under a per-template anisotropic squash (the projection of a
  tilted object) and in-plane rotation, so no two templates coincide;
- each scene plants one template of its object under a rigid transform
  among short clutter segments, inside a ``600 x 450`` frame whose corner
  markers make every scene's padded canvas 640 wide.

The planted template is the ground truth for the ranking check.
"""
from __future__ import annotations

import dataclasses

import numpy as np

OBJECT_TEMPLATES = (106, 104, 111, 100)     # 421 templates in all
OBJECT_MAX_LINES = (31, 29, 33, 30)
SCENES_PER_OBJECT = 10
FRAME_WH = (600.0, 450.0)
_BASE_LINES = 40
_CLUTTER_LINES = (260, 320)


@dataclasses.dataclass(frozen=True)
class PoseObject:
    """One object's template bank and scenes."""
    templates: list          # (L_t, 4) f32 per template
    scenes: list             # (N_s, 4) f32 per scene
    planted: np.ndarray      # (scenes,) int: template planted in each scene
    transforms: np.ndarray   # (scenes, 2, 3) f32: rigid transform planted


def _rot(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s], [s, c]], np.float64)


def _apply(lines: np.ndarray, mat: np.ndarray) -> np.ndarray:
    a = lines[:, 0:2] @ mat[:, :2].T + mat[:, 2]
    b = lines[:, 2:4] @ mat[:, :2].T + mat[:, 2]
    return np.concatenate([a, b], axis=1)


def _segments(rng, n: int, lo: float, hi: float, box) -> np.ndarray:
    p = rng.uniform([box[0], box[1]], [box[2], box[3]], (n, 2))
    ang = rng.uniform(-np.pi, np.pi, n)
    ln = rng.uniform(lo, hi, n)
    q = p + ln[:, None] * np.stack([np.cos(ang), np.sin(ang)], axis=1)
    return np.concatenate([p, q], axis=1)


def _template(rng, base: np.ndarray, n_lines: int) -> np.ndarray:
    keep = np.sort(rng.choice(base.shape[0], n_lines, replace=False))
    axis = rng.uniform(0, np.pi)
    squash = np.diag([rng.uniform(0.6, 1.0), 1.0])
    lin = _rot(rng.uniform(-np.pi, np.pi)) @ _rot(axis) @ squash @ _rot(-axis)
    t = _apply(base[keep], np.concatenate([lin, np.zeros((2, 1))], axis=1))
    t -= np.tile(t.reshape(-1, 2).min(axis=0), 2)      # bbox at the origin
    return (t + 10.0).astype(np.float32)


def _scene(rng, tmpl: np.ndarray):
    w, h = FRAME_WH
    n_clutter = int(rng.integers(*_CLUTTER_LINES))
    clutter = _segments(rng, n_clutter, 4.0, 40.0, (0, 0, w, h))
    clutter[:, 0::2] = np.clip(clutter[:, 0::2], 0, w)
    clutter[:, 1::2] = np.clip(clutter[:, 1::2], 0, h)
    pts = tmpl.reshape(-1, 2).astype(np.float64)
    center = (pts.min(axis=0) + pts.max(axis=0)) / 2
    rot = _rot(rng.uniform(-np.pi, np.pi))
    ext = np.abs((pts - center) @ rot.T).max(axis=0) + 2.0
    pos = rng.uniform(ext, np.array([w, h]) - ext)
    mat = np.concatenate([rot, (pos - rot @ center)[:, None]], axis=1)
    planted = _apply(tmpl.astype(np.float64), mat)
    corners = np.array([[0, 0, 4, 0], [w - 4, h, w, h]], np.float64)
    lines = np.concatenate([planted, clutter, corners])
    return lines[rng.permutation(lines.shape[0])].astype(np.float32), \
        mat.astype(np.float32)


def make_object(seed: int, obj: int, n_scenes: int = SCENES_PER_OBJECT,
                n_templates: int | None = None) -> PoseObject:
    """Object ``obj`` (0-3) of the pose data set for ``seed``.

    ``n_templates`` cuts the bank for small CPU tests (the default is the
    notebook's count for this object)."""
    rng = np.random.default_rng([seed, obj])
    base = _segments(rng, _BASE_LINES, 15.0, 80.0, (0, 0, 200, 200))
    max_lines = OBJECT_MAX_LINES[obj]
    n_t = OBJECT_TEMPLATES[obj] if n_templates is None else n_templates
    counts = rng.integers(max_lines - 10, max_lines + 1, n_t)
    counts[0] = max_lines
    templates = [_template(rng, base, int(c)) for c in counts]
    planted = rng.integers(0, n_t, n_scenes)
    scenes, mats = [], []
    for t in planted:
        s, m = _scene(rng, templates[int(t)])
        scenes.append(s)
        mats.append(m)
    return PoseObject(templates, scenes, planted.astype(np.int64),
                      np.asarray(mats, np.float32).reshape(-1, 2, 3))


def make_pose_dataset(seed: int, **kw) -> list:
    """All four objects of the pose data set for ``seed``."""
    return [make_object(seed, o, **kw) for o in range(len(OBJECT_TEMPLATES))]
