"""KING kinship / IBS epilogue — the numerics parity contract.

Implements exactly the reference's fp32 expression tree (cuking.cu:286-307),
which is itself Hail's "between-family" estimator
(https://hail.is/docs/0.2/methods/relatedness.html#hail.methods.king)::

    min_hets = min(num_het_i, num_het_j)
    kin  = 0.5 + (2*num_both_het - 4*num_opposing_hom
                  - num_het_i - num_het_j) / (4*min_hets)
    ibs0 = num_opposing_hom
    ibs2 = num_concordant_hom + num_both_het
    ibs1 = num_shared_sites - ibs0 - ibs2

All counts are exact integers (int32 here, uint32 in the reference), so fp32
parity with the CUDA kernel is deterministic as long as the operation order is
preserved: the numerator folds left-to-right as
``((2f*bh - 4f*oh) - hi) - hj``, and the denominator is materialized as
``4f * min_hets`` before the division.  ``min_hets == 0`` produces IEEE
inf/NaN exactly like the reference (NaN fails the strict ``kin > threshold``
test; +inf passes it).

The division must round like IEEE ``div.rn``, as the reference's CUDA ``/``
does.  XLA:GPU lowers an f32 division to PTX ``div.full.f32``, an
approximation within 2 ulp (on an H100 about 28% of kin values came out
1 ulp off), so ``_div_rn`` divides exactly in integer arithmetic instead;
on the CPU it equals the hardware division bit for bit.  The other epilogue
operations lower to ``mul.rn``/``sub.rn``/``add.rn``, which no FMA
contraction may touch."""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax


class KingCounts(NamedTuple):
    """The six per-pair counters accumulated over defined sites
    (cuking.cu:216-240)."""

    both_het: jnp.ndarray        # popcount(het_i & het_j & defined)
    het_i: jnp.ndarray           # popcount(het_i & defined)
    het_j: jnp.ndarray           # popcount(het_j & defined)
    opposing_hom: jnp.ndarray    # popcount(((ref_i&alt_j)|(alt_i&ref_j)) & defined)
    concordant_hom: jnp.ndarray  # popcount(((ref_i&ref_j)|(alt_i&alt_j)) & defined)
    shared_sites: jnp.ndarray    # popcount(defined)


class KingResult(NamedTuple):
    kin: jnp.ndarray   # float32
    ibs0: jnp.ndarray  # int32
    ibs1: jnp.ndarray  # int32
    ibs2: jnp.ndarray  # int32


_QUOTIENT_BITS = 27  # ≥ 26 significant bits: 24 + round + one below it


def _div_rn(numer: jnp.ndarray, denom: jnp.ndarray) -> jnp.ndarray:
    """``numer / denom`` rounded to nearest even, for integer-valued float32
    operands below 2^31 in magnitude (the epilogue's are) and ``denom >= 0``.

    Restoring long division of the integer magnitudes, aligned so that the
    first quotient bit has weight 2^e, gives 27 quotient bits; the
    remainder's non-zero-ness is ORed into the lowest one (the sticky bit),
    so the exact uint32 → float32 conversion rounds as the true quotient
    would, and scaling by 2^(e-26) is exact.  ``denom == 0`` keeps the
    hardware division, whose ±inf/NaN are exact."""
    a = jnp.abs(numer).astype(jnp.uint32)
    b = denom.astype(jnp.uint32)
    e = lax.clz(b).astype(jnp.int32) - lax.clz(a).astype(jnp.int32)
    # Align both to the same bit length (≤ 31, so 2·bb fits in uint32).
    aa = a << jnp.maximum(-e, 0).astype(jnp.uint32)
    bb = b << jnp.maximum(e, 0).astype(jnp.uint32)
    q = jnp.zeros_like(a)
    r = aa
    for _ in range(_QUOTIENT_BITS):
        bit = r >= bb
        q = (q << 1) | bit.astype(jnp.uint32)
        r = jnp.where(bit, r - bb, r) << 1
    q = q | (r != 0).astype(jnp.uint32)
    scale = lax.bitcast_convert_type(
        (e - (_QUOTIENT_BITS - 1) + 127) << 23, jnp.float32
    )
    mag = q.astype(jnp.float32) * scale
    exact = jnp.where(numer < 0, -mag, mag)
    return jnp.where((denom == 0) | (a == 0), numer / denom, exact)


def king_from_counts(counts: KingCounts) -> KingResult:
    """Counts → (kin, ibs0, ibs1, ibs2) with the reference's exact fp32
    op order (cuking.cu:289-307)."""
    bh = counts.both_het.astype(jnp.float32)
    hi = counts.het_i.astype(jnp.float32)
    hj = counts.het_j.astype(jnp.float32)
    oh = counts.opposing_hom.astype(jnp.float32)

    min_hets = jnp.minimum(hi, hj)
    # ((2*bh - 4*oh) - hi) - hj, left-associative like the C expression.
    numer = jnp.float32(2.0) * bh - jnp.float32(4.0) * oh - hi - hj
    denom = jnp.float32(4.0) * min_hets
    kin = jnp.float32(0.5) + _div_rn(numer, denom)

    ibs0 = counts.opposing_hom
    ibs2 = counts.concordant_hom + counts.both_het
    ibs1 = counts.shared_sites - ibs0 - ibs2
    return KingResult(kin=kin, ibs0=ibs0, ibs1=ibs1, ibs2=ibs2)
