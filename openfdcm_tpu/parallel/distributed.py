"""Multi-host runtime helpers.

The reference is single-process (SURVEY.md §2.4); scaling beyond one host
here uses the standard JAX multi-controller runtime: every host calls
:func:`initialize`, builds the same global mesh, and runs the same sharded
program; collectives ride ICI/DCN.

``global_topk`` is the cross-shard ranking primitive: each shard reduces its
candidate scores to a local top-k, the small (k, shard) tensors are
all-gathered, and a final re-rank yields a deterministic global top-k
(stable tie-breaking on global candidate index, SURVEY.md §7.3).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize the multi-host runtime (``jax.distributed.initialize``).

    Where the cluster environment announces the job, arguments are
    auto-detected; otherwise pass all three (coordinator ``host:port``,
    process count, this process's id).
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_topk(mesh: Mesh, scores, valid, k: int, axis: str = "cand"):
    """Deterministic global top-k over a candidate axis sharded on ``axis``.

    ``scores``/``valid``: global arrays ``(C,)`` sharded along ``axis``.
    Returns replicated ``(scores_k, global_idx_k)`` — ascending (best first);
    invalid candidates rank last; ties break on global candidate index.
    """
    n_shards = mesh.shape[axis]

    def local(s, v):
        shard = jax.lax.axis_index(axis)
        c_local = s.shape[0]
        masked = jnp.where(v, s, jnp.inf)
        kk = min(k, c_local)
        vals, idx = jax.lax.top_k(-masked, kk)
        gidx = idx + shard * c_local
        # all_gather the per-shard winners, then re-rank.
        av = jax.lax.all_gather(-vals, axis)          # (S, kk)
        ai = jax.lax.all_gather(gidx, axis)           # (S, kk)
        flat_v = av.reshape(-1)
        flat_i = ai.reshape(-1)
        take = min(k, n_shards * kk)
        # Sort by (score, index) for deterministic ties: lexicographic via
        # argsort on score then stable index ordering from top_k is NOT
        # guaranteed across shards, so sort a packed key.
        order = jnp.lexsort((flat_i, flat_v))[:take]
        return flat_v[order], flat_i[order]

    fn = shard_map(local, mesh=mesh, in_specs=(P(axis), P(axis)),
                   out_specs=(P(), P()), check_vma=False)
    return jax.jit(fn)(scores, valid)
