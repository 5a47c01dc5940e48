"""openfdcm_tpu: Fast Directional Chamfer Matching in JAX.

Re-implements the full capability surface of Innoptech/OpenFDCM with a
JAX/XLA compute path for accelerators: the DT3 feature bank is one dense
``[depth, H, W]`` tensor built with batched seed-min distance transforms and
shear-cumsum line integrals; candidate generation, alignment, and the greedy
1D optimizers all run as lockstep batched device code.

Public API mirrors the reference's Python module
(``modules/python/src/matching.cpp:62-307``, ``core.cpp:39-50``); see
:mod:`openfdcm_tpu.compat` for a drop-in ``import openfdcm`` shim.
"""
from .core.types import Distance
from .core import geometry, io, utils
from .core.errors import OpenFDCMError, PointOutOfBound, ImgProcError
from .core.io import read, write
from .core.geometry import get_template_lengths
from .matching.featuremap import (
    Dt3Params, Dt3Featuremap, build_featuremap, evaluate, minmax_translation,
    save_featuremap, load_featuremap,
)
from . import profiling
from .matching.search import (
    DefaultSearch, ConcentricRangeStrategy, establish_search_strategy,
)
from .matching.optimize import (
    DefaultOptimize, IndulgentOptimize, BatchOptimize, DenseOptimize, optimize,
)
from .matching.penalty import DefaultPenalty, ExponentialPenalty, penalize
from .matching.match import (
    Match, DefaultMatch, search, sort_matches, TemplateBank, prepare_templates,
)
from .matching.pipeline import (
    Dt3FeaturemapBatch, build_featuremap_batch, search_batch, match_many,
    match_many_async,
)
from .sweep import resumable_sweep, SweepState
from .serving import MatcherService

# Reference spells the enum `openfdcm.distance`.
distance = Distance

__version__ = "0.1.0"
# Reference exposes OPENFDCM_VER_{MAJOR,MINOR,PATCH} (core/version.h.in:28-32).
version_info = tuple(int(p) for p in __version__.split("."))

__all__ = [
    "Distance", "distance", "read", "write", "get_template_lengths",
    "Dt3Params", "Dt3Featuremap", "build_featuremap", "evaluate",
    "save_featuremap", "load_featuremap", "profiling",
    "minmax_translation", "DefaultSearch", "ConcentricRangeStrategy",
    "establish_search_strategy", "DefaultOptimize", "IndulgentOptimize",
    "BatchOptimize", "DenseOptimize", "optimize", "DefaultPenalty",
    "ExponentialPenalty", "penalize", "Match", "DefaultMatch", "search",
    "sort_matches", "TemplateBank", "prepare_templates", "geometry", "io",
    "Dt3FeaturemapBatch", "build_featuremap_batch", "search_batch", "match_many",
    "match_many_async",
    "resumable_sweep", "SweepState", "MatcherService",
    "OpenFDCMError", "PointOutOfBound", "ImgProcError", "utils",
    "enable_compilation_cache", "device_info",
]


def device_info(require_accelerator: bool = False) -> dict:
    """The devices JAX runs on: ``{"platform", "kind", "count"}`` of
    ``jax.devices()`` (platform and ``device_kind`` of the first device).

    ``require_accelerator``: raise ``RuntimeError`` when JAX finds only CPU
    devices — a measurement or smoke run must fail there, never fall back.
    """
    import jax
    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    if require_accelerator and info["platform"] == "cpu":
        raise RuntimeError(
            f"no accelerator: JAX found only CPU devices ({info})")
    return info


def enable_compilation_cache(min_compile_secs: float = 0.5) -> str:
    """Enable JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and no
    directory is set here.  Otherwise the cache is ``.jax_cache`` at the
    root of the checkout: a fixed path, since the path is part of what
    makes a later process find the entries again.
    """
    import os
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
