"""The DT row pass against a brute-force numpy EDT, and the GPU row-pass
kernel (``ops/minplus_gpu.py``) in the Pallas interpreter."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from openfdcm_tpu.core import dt
from openfdcm_tpu.core.types import Distance, F32_MAX
from openfdcm_tpu.ops import minplus_gpu

_DENSITY = {"sparse": 0.01, "dense": 0.2}


def _seeds(width: int, density: str, rows: int = 12, seed: int = 0):
    rng = np.random.default_rng([width, rows, seed])
    mask = rng.random((rows, width)) < _DENSITY[density]
    mask[rng.integers(rows), rng.integers(width)] = True    # never empty
    return mask


def _brute_force(mask: np.ndarray, metric: Distance) -> np.ndarray:
    ys, xs = np.nonzero(mask)
    gy, gx = np.mgrid[:mask.shape[0], :mask.shape[1]]
    dy = np.abs(gy[..., None] - ys).astype(np.float32)
    dx = np.abs(gx[..., None] - xs).astype(np.float32)
    if metric == Distance.L1:
        return (dx + dy).min(axis=-1)
    d2 = (dx * dx + dy * dy).min(axis=-1)
    return np.sqrt(d2) if metric == Distance.L2 else d2


@pytest.mark.parametrize("density", sorted(_DENSITY))
@pytest.mark.parametrize("width", [64, 200, 256])
@pytest.mark.parametrize("metric", [Distance.L1, Distance.L2,
                                    Distance.L2_SQUARED])
def test_row_pass_matches_brute_force_edt(metric, width, density):
    mask = _seeds(width, density)
    ind = jnp.where(jnp.asarray(mask), 0.0, F32_MAX).astype(jnp.float32)
    got = np.asarray(dt.dt_from_indicator(ind, metric=metric))
    np.testing.assert_array_equal(got, _brute_force(mask, metric))


def _column_pass(mask: np.ndarray):
    ind = jnp.where(jnp.asarray(mask), 0.0, jnp.inf).astype(jnp.float32)
    g = dt.column_pass(ind)
    return jnp.minimum(g * g, jnp.inf), g


@pytest.mark.parametrize("density", sorted(_DENSITY))
@pytest.mark.parametrize("width", [64, 200, 256])
def test_banded_kernel_interpret_matches_dense(width, density):
    """The kernel's plan (band ∩ active chunks), its padding of rows and
    columns to the tile grid, and its loop, run in the interpreter: bit-
    equal to the dense form (all values are exact integers in f32)."""
    mask = _seeds(width, density, rows=45)
    g2, g = _column_pass(mask)
    got = minplus_gpu.minplus_rows_banded(
        g2, dt._nearest_1d_l1(g), interpret=True)
    assert got.shape == g2.shape
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(dt._minplus_dense_rows(g2)))


def test_chunked_and_dense_forms_agree():
    g2, _ = _column_pass(_seeds(200, "sparse", rows=130))
    np.testing.assert_array_equal(np.asarray(dt._minplus_chunked_rows(g2)),
                                  np.asarray(dt._minplus_dense_rows(g2)))


def test_plan_skips_empty_and_far_chunks():
    """An all-empty row tile scans no chunk; a tile far from its only
    seed column scans only the chunks inside its L1 band."""
    width = 256
    mask = np.zeros((2, minplus_gpu.RB, width), bool)   # two images
    mask[1, 3, 5] = True                    # one seed, second image only
    g2, g = _column_pass(mask)
    chunks, nch = minplus_gpu.plan_chunks(
        g2.reshape(-1, width), dt._nearest_1d_l1(g).reshape(-1, width))
    nch = np.asarray(nch)
    assert (nch[0] == 0).all()
    assert (nch[1] == 1).all()
    assert (np.asarray(chunks)[1, :, 0] == 0).all()


@pytest.mark.gpu
def test_banded_kernel_compiled_on_gpu(gpu_device):
    mask = _seeds(640, "sparse", rows=256)
    with jax.default_device(gpu_device):
        g2, g = _column_pass(mask)
        got = jax.jit(minplus_gpu.minplus_rows_banded)(
            g2, dt._nearest_1d_l1(g))
        want = dt._minplus_dense_rows(g2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
