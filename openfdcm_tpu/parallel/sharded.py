"""Multi-device sharding of the FDCM matching pipeline.

The reference is a single-process, thread-pool-parallel CPU library (its only
parallel fan-outs are the per-angle DT build and the per-candidate optimize,
reference ``dt3cpu.h:196-224`` and ``src/optimizestrategies/defaultoptimize.cpp:72-90``).
The accelerator scaling story replaces both with SPMD over a
``jax.sharding.Mesh``:

* **candidate parallelism** (axis ``"cand"``): the aligned-template candidate
  tensor is sharded across devices; every device walks its own candidates in
  lockstep against a replicated DT3.  This is the analogue of the reference's
  per-candidate thread fan-out, scaled across chips instead of cores.
* **scene/data parallelism** (axis ``"scene"``): a batch of scenes (one DT3
  per scene) is sharded across the other mesh axis; candidates for each scene
  are sharded along ``"cand"`` within it.

Both paths run under ``shard_map`` so the greedy-walk ``while_loop`` stays
*local* to each device — no per-iteration cross-device synchronization; the
only collective is the final top-k merge (``all_gather`` of per-shard
winners), matching the plan in SURVEY.md §2.4.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..matching import optimize as opt

__all__ = [
    "make_mesh", "pad_to_multiple", "optimize_candidates_sharded",
    "optimize_candidates_sharded_batch", "topk_candidates",
]


def make_mesh(shape=None, axis_names=("cand",), devices=None) -> Mesh:
    """A device mesh for candidate (and optionally scene) parallelism.

    ``shape=None`` puts all available devices on the first axis.
    """
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    n = int(np.prod(shape))
    arr = np.asarray(devices[:n]).reshape(shape)
    return Mesh(arr, axis_names)


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def optimize_candidates_sharded(mesh: Mesh, dt3_flat, angles, scene_tr,
                                hw, feature_size, cand_lines, cand_mask,
                                cand_align, *, mode: str, window: int,
                                dense_steps: int, axis: str = "cand"):
    """Candidate-sharded :func:`openfdcm_tpu.matching.optimize.optimize_candidates`.

    ``cand_*`` leading axis must be divisible by ``mesh.shape[axis]``.  The
    DT3 (``dt3_flat``) is replicated; each device runs the lockstep walk on
    its candidate shard with no cross-device traffic.
    """
    def local(fs, lines, mask, av):
        return opt.optimize_candidates(
            dt3_flat, angles, scene_tr, hw, fs, lines, mask, av,
            mode=mode, window=window, dense_steps=dense_steps)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False,
    )
    return jax.jit(fn)(feature_size, cand_lines, cand_mask, cand_align)


def optimize_candidates_sharded_batch(mesh: Mesh, dt3_flat, angles, scene_tr,
                                      hw, feature_size, cand_lines, cand_mask,
                                      cand_align, *, mode: str, window: int,
                                      dense_steps: int,
                                      scene_axis: str = "scene",
                                      cand_axis: str = "cand"):
    """Scene-batched, 2D-sharded optimize.

    Shapes: ``dt3_flat (S, D*PH*PW)``, ``scene_tr (S, 2)``,
    ``feature_size (S, 2)``, ``cand_lines (S, C, L, 4)``,
    ``cand_mask (S, C, L)``, ``cand_align (S, C, 2)``.
    Scenes shard along ``scene_axis``, candidates along ``cand_axis``.
    """
    def local(dt3s, trs, fss, lines, masks, avs):
        def one(dt3_one, tr, fs, l, m, a):
            return opt.optimize_candidates(
                dt3_one, angles, tr, hw, fs, l, m, a,
                mode=mode, window=window, dense_steps=dense_steps)
        return jax.vmap(one)(dt3s, trs, fss, lines, masks, avs)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(scene_axis), P(scene_axis), P(scene_axis),
                  P(scene_axis, cand_axis), P(scene_axis, cand_axis),
                  P(scene_axis, cand_axis)),
        out_specs=(P(scene_axis, cand_axis),) * 3,
        check_vma=False,
    )
    return jax.jit(fn)(dt3_flat, scene_tr, feature_size,
                       cand_lines, cand_mask, cand_align)


@partial(jax.jit, static_argnames=("k",))
def topk_candidates(scores, valid, k: int):
    """Deterministic global top-k of candidate scores (ascending = best).

    Invalid candidates rank last.  Ties break on candidate index — the
    reference's single-process ``std::sort`` tie order is unspecified
    (``matchstrategy.h:48-55``); fixing (score, index) makes 1-chip and
    N-host runs rank identically (SURVEY.md §7.3).
    Returns ``(scores_k, idx_k)``.
    """
    masked = jnp.where(valid, scores, jnp.inf)
    # top_k finds maxima; negate for ascending-best.  Stable tie-break on
    # index via lexicographic trick: top_k is stable in JAX (first occurrence
    # wins on ties), so -masked directly gives lowest-score-first, lowest
    # index first among equals.
    neg = -masked
    vals, idx = jax.lax.top_k(neg, k)
    return -vals, idx
