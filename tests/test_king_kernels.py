"""Count-kernel parity: jnp popcount and int8 matmul paths vs the numpy
oracle, and the fp32 kin/IBS epilogue vs the reference expression
(cuking.cu:286-307)."""

import numpy as np
import pytest

import jax.numpy as jnp

from cuking_tpu.ops.bitset import PlaneLayout, pack_genotypes
from cuking_tpu.ops.king_jnp import panel_counts_popcount
from cuking_tpu.ops.king_math import KingCounts, king_from_counts
from cuking_tpu.ops.king_mm import panel_counts_matmul
from cuking_tpu.ops.oracle import oracle_counts, oracle_king
from cuking_tpu.utils.synthetic import random_genotypes

KERNELS = {
    "popcount": lambda pi, pj: panel_counts_popcount(jnp.asarray(pi), jnp.asarray(pj)),
    "matmul": lambda pi, pj: panel_counts_matmul(
        jnp.asarray(pi), jnp.asarray(pj), site_chunk_words=16
    ),
    # A chunk smaller than every W below: many accumulated site chunks.
    "matmul_chunk8": lambda pi, pj: panel_counts_matmul(
        jnp.asarray(pi), jnp.asarray(pj), site_chunk_words=8
    ),
}


def _panels(num_i, num_j, num_sites, seed, missing_rate=0.12):
    g = random_genotypes(
        num_i + num_j, num_sites, missing_rate=missing_rate, seed=seed,
        num_related_pairs=2,
    )
    g_i, g_j = g[:num_i], g[num_i:]
    layout = PlaneLayout.create(num_sites, words_multiple=32)
    return g_i, g_j, pack_genotypes(g_i, layout), pack_genotypes(g_j, layout)


@pytest.mark.parametrize("kernel_name", list(KERNELS))
@pytest.mark.parametrize(
    "num_i,num_j,num_sites,seed",
    [(8, 8, 100, 0), (16, 8, 1000, 1), (8, 24, 1023, 2), (32, 32, 2048, 3)],
)
def test_counts_match_oracle(kernel_name, num_i, num_j, num_sites, seed):
    g_i, g_j, pi, pj = _panels(num_i, num_j, num_sites, seed)
    expected = oracle_counts(g_i, g_j)
    got = KERNELS[kernel_name](pi, pj)
    for name, exp, act in zip(KingCounts._fields, expected, got):
        act = np.asarray(act)
        assert act.dtype == np.int32
        assert np.array_equal(act, exp), f"{name} mismatch"


@pytest.mark.parametrize("kernel_name", list(KERNELS))
def test_all_missing_sample(kernel_name):
    """A fully missing sample has zero counts everywhere it appears."""
    g = random_genotypes(6, 256, missing_rate=0.1, seed=7)
    g[3, :] = -1
    layout = PlaneLayout.create(256, words_multiple=16)
    planes = pack_genotypes(g, layout)
    got = KERNELS[kernel_name](planes, planes)
    for name, arr in zip(KingCounts._fields, got):
        arr = np.asarray(arr)
        assert (arr[3, :] == 0).all(), name
        assert (arr[:, 3] == 0).all(), name


def test_chunk_not_dividing_words_is_clamped():
    """site_chunk_words larger than (or coprime to) W must clamp to a
    divisor, not crash — W's multiple is the layout's choice, not the
    kernel caller's (regression: chunk=512 with words_multiple=128)."""
    g = random_genotypes(16, 17_000 // 100, missing_rate=0.1, seed=19)
    # W = 20 words (640 sites at wm=4): chunk requests 512 and 7 both work.
    layout = PlaneLayout.create(g.shape[1], words_multiple=4)
    planes = pack_genotypes(g, layout)
    expected = oracle_counts(g, g)
    for chunk in (512, 7):
        got_mm = panel_counts_matmul(
            jnp.asarray(planes), jnp.asarray(planes), site_chunk_words=chunk
        )
        for exp, a in zip(expected, got_mm):
            assert np.array_equal(np.asarray(a), exp)


def test_epilogue_matches_reference_expression():
    g = random_genotypes(24, 4096, missing_rate=0.08, seed=11, num_related_pairs=4)
    layout = PlaneLayout.create(4096, words_multiple=32)
    planes = pack_genotypes(g, layout)
    counts = panel_counts_popcount(jnp.asarray(planes), jnp.asarray(planes))
    kin, ibs0, ibs1, ibs2 = king_from_counts(counts)
    exp_kin, exp_ibs0, exp_ibs1, exp_ibs2 = oracle_king(g, g)

    kin = np.asarray(kin)
    assert kin.dtype == np.float32
    iu, ju = np.triu_indices(24, k=1)
    # Bit-identical fp32 kinship (counts are exact; expression order matches).
    np.testing.assert_array_equal(kin[iu, ju], exp_kin[iu, ju])
    np.testing.assert_array_equal(np.asarray(ibs0)[iu, ju], exp_ibs0[iu, ju])
    np.testing.assert_array_equal(np.asarray(ibs1)[iu, ju], exp_ibs1[iu, ju])
    np.testing.assert_array_equal(np.asarray(ibs2)[iu, ju], exp_ibs2[iu, ju])
    # Sanity: seeded related pairs actually exceed the default threshold.
    assert kin[20, 21] > 0.0884 and kin[22, 23] > 0.0884


def test_zero_het_pair_produces_ieee_division():
    """min_hets == 0 → NaN (0/0) or ±inf, matching CUDA fp32 (cuking.cu:289-294):
    NaN must fail, +inf must pass a strict > threshold."""
    # Sample 0: only hom-ref; sample 1: only hom-alt → no hets, opposing homs.
    g = np.zeros((2, 64), dtype=np.int8)
    g[1, :] = 2
    layout = PlaneLayout.create(64, words_multiple=2)
    planes = pack_genotypes(g, layout)
    counts = panel_counts_popcount(jnp.asarray(planes), jnp.asarray(planes))
    kin = np.asarray(king_from_counts(counts).kin)
    assert np.isneginf(kin[0, 1])  # (0 - 4*64 - 0 - 0) / 0 = -inf
    assert not (kin[0, 1] > -np.inf)

    # Two identical all-hom-ref samples: numerator 0, denominator 0 → NaN.
    g2 = np.zeros((2, 64), dtype=np.int8)
    planes2 = pack_genotypes(g2, layout)
    counts2 = panel_counts_popcount(jnp.asarray(planes2), jnp.asarray(planes2))
    kin2 = np.asarray(king_from_counts(counts2).kin)
    assert np.isnan(kin2[0, 1])
    assert not (kin2[0, 1] > -np.inf)  # NaN never passes the strict >


@pytest.mark.parametrize("magnitude", [1 << 12, 1 << 20, 1 << 24, 1 << 30])
def test_exact_division_matches_ieee(magnitude):
    """The epilogue's integer long division rounds like IEEE float32
    division (what the reference's CUDA `/` does) for integer-valued
    operands of every magnitude the counters reach, incl. zero numerators
    and zero denominators (±inf/NaN)."""
    from cuking_tpu.ops.king_math import _div_rn

    rng = np.random.default_rng(magnitude)
    n = 1 << 16
    num = rng.integers(-magnitude, magnitude, n).astype(np.float32)
    den = (4 * rng.integers(0, magnitude // 4 + 1, n)).astype(np.float32)
    den[:64] = 0
    num[64:128] = 0
    got = np.asarray(_div_rn(jnp.asarray(num), jnp.asarray(den)))
    with np.errstate(divide="ignore", invalid="ignore"):
        exp = num / den
    same = (got.view(np.uint32) == exp.view(np.uint32)) | (
        np.isnan(got) & np.isnan(exp))
    assert same.all(), (num[~same][:4], den[~same][:4])


def test_exact_division_edge_operands():
    """Quotients far below 1 and far above it, power-of-two denominators,
    and the largest operands the counters reach round as IEEE does.  (An
    exact halfway quotient cannot occur: a midpoint needs 25 significant
    bits, more than a float32 numerator carries.)"""
    from cuking_tpu.ops.king_math import _div_rn

    num = np.array([1, -1, 2**30, 2**24 - 1, 3, -(2**24 - 3), 2**30 - 64,
                    12345679], np.float32)
    den = np.array([2**30, 4, 4, 3, 2**24 - 4, 12, 3 * 2**20, 4 * 1000003],
                   np.float32)
    got = np.asarray(_div_rn(jnp.asarray(num), jnp.asarray(den)))
    assert np.array_equal(got.view(np.uint32), (num / den).view(np.uint32))
