"""Backend-invariant orientation classification (r4 golden regression).

An r4 bench drift (obj_02/scene_3 tmpl-74: accelerator score 0.195048 vs
CPU golden 0.197035) came from classifying candidate lines via
``atan(dy/dx)``: two XLA backends' atan approximations disagree by up to
~2e-5 rad, which flips nearest-angle classification for lines within that
window of a slice midpoint (the offending line classified 20 on the CPU, 19
on the accelerator).  ``classify_lines`` now compares the raw ratio ``dy/dx`` against a
host-precomputed f32 threshold table (``orientation_ratio_splits``) — only
IEEE-exact ops on device, so every backend is bit-identical to the numpy
oracle semantics (``tests/oracle.py:16-27`` / reference ``dt3cpu.h:93-114``).
"""
import numpy as np
import pytest

from openfdcm_tpu.matching import featuremap as fm
from tests import oracle as orc


@pytest.mark.parametrize("depth", [2, 3, 4, 30, 60])
def test_ratio_table_matches_oracle(depth):
    """Table classification == the scalar numpy oracle for adversarial
    ratios: random Cauchy (uniform in angle), exact threshold neighborhoods
    (+-2 ulps), axis-aligned and degenerate lines."""
    splits, wrap = fm.orientation_ratio_splits(depth)
    angles = fm.make_angles(depth)
    sp = np.asarray(splits, np.float32)

    rng = np.random.default_rng(depth)
    rs = [rng.standard_cauchy(5000).astype(np.float32),
          np.float32([0.0, -0.0, np.inf, -np.inf, 1e30, -1e30, 1e-30])]
    for t in list(splits) + [wrap]:
        t = np.float32(t)
        rs.append(np.nextafter(t, -np.inf, dtype=np.float32)[None])
        rs.append(np.asarray([t]))
        rs.append(np.nextafter(t, np.inf, dtype=np.float32)[None])
    for r in np.concatenate(rs):
        table = 0 if r >= np.float32(wrap) else int(np.sum(r >= sp))
        with np.errstate(all="ignore"):
            want = orc.closest_orientation_idx(angles, float(np.arctan(r)))
        assert table == want, (float(r), table, want)


def test_classify_lines_device_matches_oracle():
    """The jnp entry point agrees with the oracle on random lines,
    vertical/horizontal lines, and degenerate points (NaN -> depth-1)."""
    import jax.numpy as jnp

    depth = 30
    angles = jnp.asarray(fm.make_angles(depth))
    rng = np.random.default_rng(7)
    p1 = rng.uniform(0, 100, (500, 2)).astype(np.float32)
    d = rng.normal(0, 10, (500, 2)).astype(np.float32)
    d[:40, 0] = 0.0          # vertical
    d[40:80, 1] = 0.0        # horizontal
    d[80:90] = 0.0           # degenerate point lines
    lines = np.concatenate([p1, p1 + d], axis=1).astype(np.float32)

    got = np.asarray(fm.classify_lines(angles, jnp.asarray(lines)))
    an = fm.make_angles(depth)
    for i, ln in enumerate(lines):
        with np.errstate(all="ignore"):
            r = np.float32(ln[3] - ln[1]) / np.float32(ln[2] - ln[0])
            want = orc.closest_orientation_idx(an, float(np.arctan(r)))
        assert got[i] == want, (i, ln, got[i], want)
