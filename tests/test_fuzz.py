"""Randomized cross-validation: engine vs the O(N²·S) numpy oracle over
varied shapes, missing rates, thresholds, kernels, and shard splits —
broadens the correctness net beyond the hand-picked cases."""

import numpy as np
import pytest

from cuking_tpu.models.king import KingConfig, KingEngine
from cuking_tpu.parallel.submatrix import Submatrix, num_shards
from cuking_tpu.utils.synthetic import random_genotypes

from tests.test_engine import assert_resultsets_equal, oracle_resultset


CASES = [
    # (n, s, missing, threshold, kernel, panel, seed)
    (17, 95, 0.0, 0.0884, "matmul", 16, 100),
    (33, 257, 0.3, 0.05, "matmul", 16, 101),
    (64, 128, 0.5, -2.0, "popcount", 32, 102),   # keep everything finite
    (21, 1000, 0.15, 0.2, "matmul", 32, 103),
    (48, 333, 0.08, 0.0, "popcount", 16, 104),
]


@pytest.mark.parametrize("n,s,missing,threshold,kernel,panel,seed", CASES)
def test_engine_fuzz_vs_oracle(n, s, missing, threshold, kernel, panel, seed):
    g = random_genotypes(
        n, s, missing_rate=missing, seed=seed, num_related_pairs=min(3, n // 4)
    )
    cfg = KingConfig(
        kin_threshold=threshold, kernel=kernel, panel=panel,
        site_chunk_words=16, sweep_batch=4,
    )
    got = KingEngine.from_genotypes(g, cfg).run()
    exp = oracle_resultset(g, threshold)
    assert_resultsets_equal(got, exp)


def test_engine_exact_fallback_on_dense_hits():
    """A step with more hits than the top_k candidate budget (2¹⁴ lanes,
    ops/compaction.CANDIDATE_BUDGET) must take accumulate_hits' exact
    full-scatter fallback: panel=256 with threshold=-2 makes every i<j
    pair of a step a hit (32,640 > 16,384), overflowing every block's
    quota."""
    n = 256
    g = random_genotypes(n, 64, missing_rate=0.0, seed=300)
    cfg = KingConfig(
        kin_threshold=-2.0, kernel="matmul", panel=256, site_chunk_words=16,
        sweep_batch=2, max_results=100_000,
    )
    got = KingEngine.from_genotypes(g, cfg).run()
    exp = oracle_resultset(g, -2.0)
    assert len(exp) > 16384  # the fallback actually triggered territory
    assert_resultsets_equal(got, exp)


def test_engine_fuzz_sharded_merge(tmp_path):
    """Random shard splits: the union over all shards equals unsharded."""
    rng = np.random.default_rng(7)
    for trial in range(3):
        n = int(rng.integers(20, 60))
        s = int(rng.integers(64, 400))
        split = int(rng.integers(2, 5))
        g = random_genotypes(n, s, missing_rate=0.1, seed=200 + trial,
                             num_related_pairs=2)
        cfg = KingConfig(kin_threshold=0.05, kernel="matmul", panel=16,
                         site_chunk_words=16, sweep_batch=4)
        parts = []
        for shard in range(num_shards(split)):
            sub = Submatrix.create(n, split, shard)
            parts.append(
                KingEngine.from_genotypes(g, cfg, submatrix=sub).run()
            )
        from cuking_tpu.models.king import ResultSet

        merged = ResultSet.concat_and_sort(parts)
        exp = oracle_resultset(g, 0.05)
        assert_resultsets_equal(merged, exp)


RING_CASES = [
    # (n, s, missing, threshold, num_devices, sub_panel, seed)
    (30, 95, 0.0, 0.0884, 3, None, 200),
    (61, 257, 0.3, 0.05, 8, 4, 201),
    (64, 128, 0.5, -2.0, 5, 8, 202),
    (23, 500, 0.15, 0.2, 2, 2, 203),
    (48, 333, 0.08, 0.0, 6, 1024, 204),  # default-style sub_panel > nd
]


@pytest.mark.parametrize("n,s,missing,threshold,num_devices,sub_panel,seed",
                         RING_CASES)
def test_ring_fuzz_vs_oracle(n, s, missing, threshold, num_devices,
                             sub_panel, seed):
    """Randomized mesh-path cross-validation: the balanced triangular ring
    with sub-tiled blocks over varied mesh sizes must be bit-exact."""
    import jax
    from jax.sharding import Mesh

    from cuking_tpu.ops.bitset import PlaneLayout, pack_genotypes
    from cuking_tpu.ops.king_mm import panel_counts_matmul
    from cuking_tpu.parallel.ring import (
        all_pairs_sharded,
        ring_output_to_resultset,
    )

    g = random_genotypes(
        n, s, missing_rate=missing, seed=seed, num_related_pairs=min(3, n // 4)
    )
    layout = PlaneLayout.create(s, words_multiple=16)
    planes = pack_genotypes(g, layout)
    mesh = Mesh(np.array(jax.devices()[:num_devices]), axis_names=("samples",))
    out = all_pairs_sharded(
        planes, n, mesh,
        lambda pi, pj: panel_counts_matmul(
            pi, pj, site_chunk_words=16
        ),
        kin_threshold=threshold, capacity_per_device=8192,
        sub_panel=sub_panel,
    )
    got = ring_output_to_resultset(out)
    exp = oracle_resultset(g, threshold)
    assert_resultsets_equal(got, exp)
