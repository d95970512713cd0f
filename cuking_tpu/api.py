"""One-call library surface: the ``hl.king``-shaped dense API.

The reference's acceptance criterion is parity with Hail's ``hl.king``
(README.md:3), which returns a full N×N kinship matrix.  The pipeline surface
(CLI / KingEngine) returns thresholded sparse pairs like the reference binary;
this module adds the dense twin for library users and validation::

    import cuking_tpu
    res = cuking_tpu.king(genotypes)          # genotypes [N, S]: 0/1/2, -1=missing
    res.kin[i, j], res.ibs0[i, j], ...        # full matrices, NaN-diagonal rules below

Semantics match cuking.cu:286-307 exactly: counts over mutually-defined
sites, Hail's between-family fp32 kinship, IBS0/1/2 per somalier.  The
matrix is symmetric by construction (counters are symmetric; ``het_i``/
``het_j`` swap roles across the diagonal).  Pairs with ``min(het) == 0``
yield IEEE inf/NaN, same as the reference.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from cuking_tpu.ops import bitset
from cuking_tpu.ops.bitset import PlaneLayout
from cuking_tpu.ops.king_math import KingResult, king_from_counts
from cuking_tpu.ops.king_mm import panel_counts_matmul


def king(
    genotypes: np.ndarray,
    *,
    kernel=None,
    site_chunk_words: int = 128,
) -> KingResult:
    """Computes the full pairwise KING kinship + IBS matrices.

    Args:
      genotypes: ``[N, S]`` int array of alt-allele counts (0, 1, 2) with
        ``-1`` marking missing calls — the dense equivalent of the sparse
        ``n_alt_alleles`` input table.
      kernel: optional override ``(planes_i, planes_j) -> KingCounts``
        (e.g. ``ops.king_jnp.panel_counts_popcount``); defaults to the XLA
        int8-matmul path.
      site_chunk_words: site-chunking granularity for the default kernel.

    Returns:
      KingResult of ``[N, N]`` arrays: ``kin`` float32, ``ibs0/1/2`` int32.
    """
    g = np.asarray(genotypes)
    if g.ndim != 2:
        raise ValueError(f"genotypes must be [num_samples, num_sites], got {g.shape}")
    layout = PlaneLayout.create(g.shape[1], words_multiple=min(
        bitset.DEFAULT_WORDS_MULTIPLE, max(16, site_chunk_words)))
    packed = bitset.pack_genotypes(g, layout)
    planes = jnp.asarray(packed)
    if kernel is None:
        counts = panel_counts_matmul(
            planes, planes, site_chunk_words=site_chunk_words
        )
    else:
        counts = kernel(planes, planes)
    return king_from_counts(counts)
