"""Matmul reformulation: KING counters as int8 indicator matmuls.

All six counters of cuking.cu:216-240 are bilinear in three per-site 0/1
indicators per sample — H (het), A (hom-alt), D (defined) — because
``hom-ref = D − H − A`` and every masked popcount is an inner product over
sites:

    both_het[i,j]       = <H_i, H_j>
    het_i[i,j]          = <H_i, D_j>          (het_i & defined depends on j!)
    het_j[i,j]          = <D_i, H_j>
    shared_sites[i,j]   = <D_i, D_j>
    opposing_hom[i,j]   = <R_i, A_j> + <A_i, R_j>
                        = DA + AD − HA − AH − 2·AA
    concordant_hom[i,j] = <R_i, R_j> + <A_i, A_j>
                        = DD − DH − DA − HD + HH + HA − AD + AH + 2·AA

with XY := X_i · Y_jᵀ.  Stacking X = [H; A; D] per panel gives one
``[3·NI, S] × [3·NJ, S]ᵀ`` int8→int32 matmul per site-chunk that yields all
nine blocks.  On the GPU XLA hands the dot to cuBLAS's int8 tensor-core
GEMM, which is what makes this the fast path.  Counts stay integer-exact:
int8 products accumulated in int32.

XLA does not fuse the unpack or the chunk accumulation into the GEMM: each
site chunk writes its int8 indicators and re-reads and re-writes the
[3·NI, 3·NJ] int32 Gram matrix through device memory (PERF.md has the
measured split)."""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from cuking_tpu.ops.king_math import KingCounts


def unpack_plane(words: jnp.ndarray, dtype=jnp.int8) -> jnp.ndarray:
    """[N, W] uint32 → [N, 32·W] bits, site order s = b·W + w (bitset.py).

    32 shift-ANDs concatenated along the lane axis — no gathers, no
    transposes.  The jnp twin of bitset.unpack_plane_np.
    """
    cols = [
        ((words >> jnp.uint32(b)) & jnp.uint32(1)).astype(dtype) for b in range(32)
    ]
    return jnp.concatenate(cols, axis=1)


def indicator_planes(planes: jnp.ndarray, dtype=jnp.int8) -> jnp.ndarray:
    """[2, N, W] packed → [3, N, 32·W] H/A/D indicators.

    Bitwise on packed words first (cheap), then one unpack per indicator:
    H = het & ~hom, A = ~het & hom, D = ~(het & hom)  — missing is (1,1).
    """
    het, hom = planes[0], planes[1]
    h = het & ~hom
    a = ~het & hom
    d = ~(het & hom)
    return jnp.stack([unpack_plane(p, dtype) for p in (h, a, d)], axis=0)


def counts_from_gram(gram: jnp.ndarray, ni: int, nj: int) -> KingCounts:
    """[3·NI, 3·NJ] stacked-indicator Gram matrix → six [NI, NJ] counters."""
    blk = lambda r, c: lax.dynamic_slice(gram, (r * ni, c * nj), (ni, nj))
    HH, HA, HD = blk(0, 0), blk(0, 1), blk(0, 2)
    AH, AA, AD = blk(1, 0), blk(1, 1), blk(1, 2)
    DH, DA, DD = blk(2, 0), blk(2, 1), blk(2, 2)
    return KingCounts(
        both_het=HH,
        het_i=HD,
        het_j=DH,
        opposing_hom=DA + AD - HA - AH - 2 * AA,
        concordant_hom=DD - DH - DA - HD + HH + HA - AD + AH + 2 * AA,
        shared_sites=DD,
    )


def panel_counts_matmul(
    planes_i: jnp.ndarray,
    planes_j: jnp.ndarray,
    site_chunk_words: int = 128,
) -> KingCounts:
    """Six KING counters via the stacked-indicator matmul (plain XLA).

    planes_i: [2, NI, W] uint32, planes_j: [2, NJ, W] → six [NI, NJ] int32.
    The site axis is processed in chunks so the unpacked int8 indicators
    never exceed ``3 · N_panel · 32 · site_chunk_words`` bytes.
    """
    ni, nj = planes_i.shape[1], planes_j.shape[1]
    w = planes_i.shape[2]
    # The chunk must divide W; rather than asserting (W's multiple depends on
    # the layout's words_multiple, which callers may pick independently),
    # clamp to the largest divisor of W not exceeding the request.
    chunk = min(site_chunk_words, w)
    if w % chunk:
        chunk = next(c for c in range(chunk, 0, -1) if w % c == 0)
    n_chunks = w // chunk

    def body(carry, idx):
        pi = lax.dynamic_slice(planes_i, (0, 0, idx * chunk), (2, ni, chunk))
        pj = lax.dynamic_slice(planes_j, (0, 0, idx * chunk), (2, nj, chunk))
        xi = indicator_planes(pi).reshape(3 * ni, 32 * chunk)
        xj = indicator_planes(pj).reshape(3 * nj, 32 * chunk)
        gram = lax.dot_general(
            xi,
            xj,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        return carry + gram, None

    init = jnp.zeros((3 * ni, 3 * nj), jnp.int32)
    gram, _ = lax.scan(body, init, jnp.arange(n_chunks))
    return counts_from_gram(gram, ni, nj)
