"""Orientation propagation against a numpy relaxation in the reference's
order (``src/featuremaps/dt3cpu.cpp:77-107``)."""
import math

import numpy as np
import jax.numpy as jnp
import pytest

from openfdcm_tpu.matching import featuremap as fm

F32 = np.float32


def _reference_relax(dt3: np.ndarray, angles: np.ndarray, coeff: float):
    """1.5 forward then 1.5 backward cycles of
    ``img[c] = min(img[c], img[c-step] + coeff * min(|da|, |da - pi|))``."""
    out = dt3.astype(F32).copy()
    m = len(angles)

    def relax(c, step):
        c1, c2 = (c - step) % m, c % m
        h = F32(abs(F32(angles[c1]) - F32(angles[c2])))
        w = F32(F32(coeff) * min(h, F32(abs(h - F32(math.pi)))))
        out[c2] = np.minimum(out[c2], (out[c1] + w).astype(F32))

    for c in range(math.ceil(1.5 * m)):
        relax(c, 1)
    for c in range(m, -math.floor(1.5 * m), -1):
        relax(c, -1)
    return out


@pytest.mark.parametrize("depth", [4, 8, 30])
def test_relaxation_matches_reference_order(depth):
    rng = np.random.default_rng(depth)
    dt3 = rng.uniform(0, 50, (depth, 9, 11)).astype(F32)
    dt3[rng.random(dt3.shape) < 0.3] = F32(3.0e38)      # far-field pixels
    angles = fm.make_angles(depth)
    got = np.asarray(fm.propagate_orientation_relax(
        jnp.asarray(dt3), fm.propagation_steps(angles, 5.0)))
    np.testing.assert_array_equal(got, _reference_relax(dt3, angles, 5.0))


@pytest.mark.parametrize("depth", [4, 8, 30])
def test_closed_form_propagation_agrees(depth):
    """The min-plus closure (``propagation_weights``) equals the relaxation
    up to f32 rounding of the step sums."""
    rng = np.random.default_rng(depth + 100)
    dt3 = rng.uniform(0, 50, (depth, 7, 5)).astype(F32)
    angles = fm.make_angles(depth)
    closed = np.asarray(fm.propagate_orientation(
        jnp.asarray(dt3), jnp.asarray(fm.propagation_weights(angles, 5.0))))
    np.testing.assert_allclose(closed, _reference_relax(dt3, angles, 5.0),
                               rtol=1e-6, atol=1e-4)
