"""Pallas (Triton route) kernel for the exact L2² row pass of the distance
transform on NVIDIA GPUs.

The separable EDT's row pass is a min-plus convolution with a quadratic
kernel: ``out[r, x] = min_s (g2[r, s] + (x - s)^2)`` (``core/dt.py``).  The
dense form is O(W²) per row; two exactness-preserving prunes cut it:

1. **L1 band.**  The winning source for a pixel satisfies
   ``|x - s*| <= d_L2(x) <= d_L1(x)``, so a tile of destination pixels only
   needs sources within ``max d_L1 + 1`` of its columns.  The L1 distances
   cost two cumulative-min passes (``dt._nearest_1d_l1``).
2. **Active sources.**  After the column pass ``g2[r, s]`` is finite only
   for source columns holding a seed somewhere in the column, and an
   infinite source never wins.  Each tile skips source chunks that are
   all-infinite over its rows, which is what makes the sparse orientation
   slices of a DT3 stack cheap.

The per-tile chunk list (band ∩ active, ascending) is planned in XLA and
read by each program from device memory.  One program owns an
``(RB rows, CB dest columns)`` tile and loops over its chunks, one source
column at a time, with the running minimum held in registers.  Sources are
read from the transposed ``(W, N)`` layout so that one source column of the
tile's rows is a contiguous load.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

RB = 32     # rows per tile
CB = 64     # destination columns per tile
SC = 16     # source columns per chunk of the plan


def _kernel(chunks_ref, nch_ref, g2t_ref, out_ref):
    i = pl.program_id(0)
    j = pl.program_id(1)
    r0 = i * RB
    xs = (j * CB + jax.lax.broadcasted_iota(jnp.int32, (CB,), 0)
          ).astype(jnp.float32)

    def chunk(ci, acc):
        c = chunks_ref[i, j, ci]

        def source(s, acc):
            col = c * SC + s
            v = g2t_ref[col, pl.ds(r0, RB)]                # (RB,)
            d = xs - col.astype(jnp.float32)
            return jnp.minimum(acc, v[:, None] + (d * d)[None, :])
        return jax.lax.fori_loop(0, SC, source, acc)

    acc = jnp.full((RB, CB), jnp.inf, jnp.float32)
    out_ref[...] = jax.lax.fori_loop(0, nch_ref[i, j], chunk, acc)


def plan_chunks(g2: jax.Array, l1: jax.Array):
    """Per-tile compacted source-chunk plan for ``(N, W)`` inputs tiled by
    ``(RB, CB)`` with source chunks of ``SC`` columns: ``(chunks (nbr, nbc,
    nsc) int32, nch (nbr, nbc) int32)``.  Chunk ``c`` is scanned by tile
    ``(i, j)`` iff it intersects the tile's L1 winner-radius window AND
    holds a finite source anywhere in the tile's rows."""
    n, w = g2.shape
    nbr, nbc, nsc = n // RB, w // CB, w // SC
    r_tile = jnp.max(l1.reshape(nbr, RB, nbc, CB), axis=(1, 3))
    r_tile = (jnp.minimum(r_tile, jnp.float32(w)) + 1.0).astype(jnp.int32)
    x0 = (jnp.arange(nbc, dtype=jnp.int32) * CB)[None, :]
    c_lo = jnp.maximum(0, (x0 - r_tile) // SC)                 # (nbr, nbc)
    c_hi = jnp.minimum(nsc - 1, (x0 + CB - 1 + r_tile) // SC)
    act = jnp.any(jnp.isfinite(g2).reshape(nbr, RB, nsc, SC), axis=(1, 3))
    c = jnp.arange(nsc, dtype=jnp.int32)
    sel = (act[:, None, :] & (c[None, None, :] >= c_lo[:, :, None])
           & (c[None, None, :] <= c_hi[:, :, None]))          # (nbr, nbc, nsc)
    nch = jnp.sum(sel, axis=-1).astype(jnp.int32)
    key = jnp.where(sel, c[None, None, :], c[None, None, :] + nsc)
    chunks = (jnp.sort(key, axis=-1) % nsc).astype(jnp.int32)
    return chunks, nch


def minplus_rows_banded(g2: jax.Array, l1: jax.Array, *,
                        interpret: bool = False) -> jax.Array:
    """Exact ``out[r, x] = min_s (g2[r, s] + (x-s)^2)`` over the last axis.

    ``g2``: ``(N, W)`` squared column distances (+inf where no seed);
    ``l1``: ``(N, W)`` exact L1 distances of the same seed set (the band
    bound).  Any ``N``, ``W``: both are padded to the tile grid here.
    ``interpret`` runs the kernel in the Pallas interpreter (tests only).
    """
    n, w = g2.shape
    n_p = -(-n // RB) * RB
    w_p = -(-w // CB) * CB
    g2p = jnp.pad(g2, ((0, n_p - n), (0, w_p - w)), constant_values=jnp.inf)
    l1p = jnp.pad(l1, ((0, n_p - n), (0, w_p - w)), constant_values=0.0)
    chunks, nch = plan_chunks(g2p, l1p)
    g2t = g2p.T
    whole = [pl.BlockSpec(a.shape, lambda i, j, nd=a.ndim: (0,) * nd)
             for a in (chunks, nch, g2t)]
    out = pl.pallas_call(
        _kernel,
        grid=(n_p // RB, w_p // CB),
        in_specs=whole,
        out_specs=pl.BlockSpec((RB, CB), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((n_p, w_p), jnp.float32),
        backend="triton",
        interpret=interpret,
        name="minplus_rows_banded",
    )(chunks, nch, g2t)
    return out[:n, :w]
