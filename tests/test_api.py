"""Dense ``cuking_tpu.king`` API: full-matrix parity with the oracle and the
hl.king-contract invariants (symmetry, exact 0.5 for duplicates)."""

import numpy as np
import pytest

import cuking_tpu
from cuking_tpu.ops.oracle import oracle_counts
from cuking_tpu.ops.king_math import king_from_counts
from cuking_tpu.utils.synthetic import random_genotypes


def test_king_matches_oracle():
    g = random_genotypes(40, 700, missing_rate=0.1, seed=11, num_related_pairs=3)
    res = cuking_tpu.king(g, site_chunk_words=16)
    exp = king_from_counts(oracle_counts(g, g))
    np.testing.assert_array_equal(np.asarray(res.kin), np.asarray(exp.kin))
    np.testing.assert_array_equal(np.asarray(res.ibs0), np.asarray(exp.ibs0))
    np.testing.assert_array_equal(np.asarray(res.ibs1), np.asarray(exp.ibs1))
    np.testing.assert_array_equal(np.asarray(res.ibs2), np.asarray(exp.ibs2))


def test_king_symmetry_and_duplicates():
    g = random_genotypes(30, 500, missing_rate=0.05, seed=12)
    g[1] = g[0]  # exact duplicate pair
    res = cuking_tpu.king(g, site_chunk_words=16)
    kin = np.asarray(res.kin)
    # Symmetric where finite (het_i/het_j swap roles; min() symmetrizes).
    finite = np.isfinite(kin)
    assert (finite == finite.T).all()
    np.testing.assert_array_equal(kin[finite], kin.T[finite])
    # Duplicate samples: kin exactly float32(0.5) (verify-skill contract).
    assert kin[0, 1] == np.float32(0.5)
    ibs0 = np.asarray(res.ibs0)
    assert ibs0[0, 1] == 0


def test_king_custom_kernel_autopads():
    """An explicit kernel is called on the packed planes as given; results
    are exact N×N (here the popcount kernel at a non-power-of-two N)."""
    from cuking_tpu.ops.king_jnp import panel_counts_popcount

    g = random_genotypes(37, 600, missing_rate=0.1, seed=13, num_related_pairs=2)
    res = cuking_tpu.king(
        g, kernel=lambda pi, pj: panel_counts_popcount(pi, pj, row_block=1),
    )
    exp = king_from_counts(oracle_counts(g, g))
    assert np.asarray(res.kin).shape == (37, 37)
    np.testing.assert_array_equal(np.asarray(res.kin), np.asarray(exp.kin))


def test_king_rejects_bad_shape():
    with pytest.raises(ValueError, match="num_samples, num_sites"):
        cuking_tpu.king(np.zeros(5, dtype=np.int8))
