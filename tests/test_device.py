"""Device selection, the compile-cache rule, the smoke script's refusal to
run without a GPU, and the correctly rounded divide/sqrt branch."""
import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import openfdcm_tpu as of
from openfdcm_tpu.core import geometry as geo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_info_reports_and_refuses_cpu():
    info = of.device_info()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}
    with pytest.raises(RuntimeError, match="no accelerator"):
        of.device_info(require_accelerator=True)


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compilation_cache_dir(env_dir, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = REPO
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    code = ("import jax, openfdcm_tpu as of; p = of.enable_compilation_cache();"
            " print(p); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [want, want]


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = str(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, script], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "FAILED" in out.stderr


@pytest.mark.parametrize("seed", [0, 1])
def test_corrected_divide_and_sqrt_are_correctly_rounded(seed):
    """The branch the GPU compiles (``_div_corrected``/``_sqrt_corrected``)
    reproduces IEEE division and sqrt; quotients above 4e34, where the
    Veltkamp split overflows, pass through."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-3, 3, 4096)
         ).astype(np.float32)
    b = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-3, 3, 4096)
         ).astype(np.float32)
    a[:4] = [3e38, -1e36, 1.0, 0.0]
    b[:4] = [2.0, 1e-2, 0.0, 5.0]
    q = np.asarray(jax.jit(geo._div_corrected)(jnp.asarray(a), jnp.asarray(b)))
    with np.errstate(divide="ignore", over="ignore"):
        np.testing.assert_array_equal(q, a / b)
    x = np.abs(a)
    s = np.asarray(jax.jit(geo._sqrt_corrected)(jnp.asarray(x)))
    np.testing.assert_array_equal(s, np.sqrt(x))


def test_div_cr_picks_cpu_branch_per_compiled_platform():
    a = jnp.asarray([1.0, 2.0, 7.0], jnp.float32)
    b = jnp.asarray([3.0, 7.0, 9.0], jnp.float32)
    text = jax.jit(geo.div_cr).lower(a, b).compile().as_text()
    assert "nextafter" not in text.lower()
    np.testing.assert_array_equal(np.asarray(geo.div_cr(a, b)),
                                  np.asarray(a) / np.asarray(b))
