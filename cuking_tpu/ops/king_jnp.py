"""Reference-semantics popcount path (plain jnp, any backend).

This is the direct analogue of the reference's per-pair strided
popcount loop (cuking.cu:216-240): for every pair in an (i-panel, j-panel)
tile, AND the packed planes word-wise and ``jax.lax.population_count`` the
six masked combinations.  Counts are exact int32.

It is the semantics baseline for the fast path (king_mm) and
the bench.py "vs_baseline" denominator; memory scales with
``row_block · NJ · W`` so it processes i-rows in blocks."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cuking_tpu.ops.king_math import KingCounts


def _pc(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.population_count(x).astype(jnp.int32)


def _row_block_counts(planes_i_blk, planes_j):
    """[2, BI, W] × [2, NJ, W] → six [BI, NJ] int32."""
    het_i = planes_i_blk[0][:, None, :]  # [BI, 1, W]
    hom_i = planes_i_blk[1][:, None, :]
    het_j = planes_j[0][None, :, :]      # [1, NJ, W]
    hom_j = planes_j[1][None, :, :]

    # Missing ⇔ both bits set; defined mask per cuking.cu:229.
    defined = ~(het_i & hom_i) & ~(het_j & hom_j)
    ref_i = ~het_i & ~hom_i
    ref_j = ~het_j & ~hom_j

    def count(mask):
        return jnp.sum(_pc(mask), axis=-1)

    return KingCounts(
        both_het=count(het_i & het_j & defined),
        het_i=count(het_i & defined),
        het_j=count(het_j & defined),
        opposing_hom=count(((ref_i & hom_j) | (hom_i & ref_j)) & defined),
        concordant_hom=count(((ref_i & ref_j) | (hom_i & hom_j)) & defined),
        shared_sites=count(defined),
    )


def panel_counts_popcount(
    planes_i: jnp.ndarray,
    planes_j: jnp.ndarray,
    row_block: int = 8,
) -> KingCounts:
    """Six KING counters for all (i, j) pairs of two packed panels.

    planes_i: [2, NI, W] uint32, planes_j: [2, NJ, W] uint32 →
    six [NI, NJ] int32 count matrices.  NI must be divisible by row_block
    (panel sizes are padded powers of two throughout the engine).
    """
    ni = planes_i.shape[1]
    row_block = min(row_block, ni)
    while ni % row_block:  # largest divisor of ni not exceeding row_block
        row_block -= 1
    blocks = planes_i.reshape(2, ni // row_block, row_block, planes_i.shape[2])
    blocks = jnp.moveaxis(blocks, 1, 0)  # [nblk, 2, BI, W]
    out = jax.lax.map(lambda blk: _row_block_counts(blk, planes_j), blocks)
    return KingCounts(*(x.reshape(ni, -1) for x in out))
