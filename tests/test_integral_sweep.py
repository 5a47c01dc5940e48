"""The XLA line integral against a numpy transliteration of the reference's
sequential block-shift sweep (``core/imgproc.h:38-84``)."""
import numpy as np
import jax.numpy as jnp
import pytest

from openfdcm_tpu.core import integral

F32 = np.float32


def _std_round(x: np.ndarray) -> np.ndarray:
    return (np.sign(x) * np.floor(np.abs(x) + F32(0.5))).astype(np.int64)


def _reference_integral(img: np.ndarray, angle: float, logical_hw) -> np.ndarray:
    """In place, in sweep order: each swept column (row, for a y-major
    angle) adds the previously swept one shifted by
    ``round(i*r) - round((i-1)*r)`` along the minor axis; shifted-out
    entries add nothing.  Only the logical region is swept."""
    h, w = logical_hw
    out = img.astype(F32).copy()
    c, s = F32(np.cos(F32(angle))), F32(np.sin(F32(angle)))
    tan = s / c
    if -1.0 <= tan < 1.0:                       # rasterizeVector, x-major
        x_major, flip, r = True, bool(c < 0), F32(tan - 2.0 * (c < 0) * tan)
    else:
        inv = F32(1.0) / tan
        x_major, flip, r = False, bool(s < 0), F32(inv - 2.0 * (s < 0) * inv)
    view = out[:h, :w] if x_major else out[:h, :w].T   # sweep along axis 1
    n_minor, n_sweep = view.shape
    order = list(range(n_sweep))[::-1] if flip else list(range(n_sweep))
    rnd = _std_round(np.arange(n_sweep, dtype=F32) * r)
    for i in range(1, n_sweep):
        d = int(rnd[i] - rnd[i - 1])
        col, prev = order[i], order[i - 1]
        for y in range(n_minor):
            if 0 <= y - d < n_minor:
                view[y, col] = F32(view[y, col] + view[y - d, prev])
    return out


# make_angles(8) (both x-major groups and the flipped y-major group) plus
# angles past +-pi/2 (the flipped x-major group) and a steep positive one
_ANGLES = [-1.5707964, -1.1780972, -0.7853982, -0.39269912, 0.0, 0.39269912,
           0.7853981, 1.1780974, 2.8, 3.3, -2.0]


@pytest.mark.parametrize("angle", _ANGLES)
def test_line_integral_matches_reference_sweep(angle):
    rng = np.random.default_rng(int(abs(angle) * 1e4))
    img = rng.uniform(0, 9, (23, 37)).astype(F32)
    got = np.asarray(integral.line_integral(jnp.asarray(img), angle))
    np.testing.assert_array_equal(got, _reference_integral(img, angle,
                                                           img.shape))


@pytest.mark.parametrize("angle", [-1.1780972, 0.39269912, 2.8])
def test_line_integral_stack_padded_canvas(angle):
    """Zero physical padding beyond the logical region leaves the logical
    integral reference-exact (the padding is swept last or holds zeros)."""
    rng = np.random.default_rng(7)
    logical = (19, 29)
    img = np.zeros((32, 48), F32)
    img[:logical[0], :logical[1]] = rng.uniform(0, 5, logical)
    got = np.asarray(integral.line_integral_stack(
        jnp.asarray(img)[None], [angle], logical_hw=logical))[0]
    want = _reference_integral(img, angle, logical)
    np.testing.assert_array_equal(got[:logical[0], :logical[1]],
                                  want[:logical[0], :logical[1]])
