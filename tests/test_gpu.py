"""Tests that need an NVIDIA GPU (marker ``gpu``).  Elsewhere the ``gpu``
fixture (conftest.py) skips them with a reason.  On a GPU host run them
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``; chip_smoke.py
phase 4 runs them in its own process."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cuking_tpu.models.king import KingConfig, KingEngine
from cuking_tpu.ops.bitset import PlaneLayout, pack_genotypes
from cuking_tpu.ops.king_math import KingCounts, _div_rn, king_from_counts
from cuking_tpu.ops.king_mm import panel_counts_matmul
from cuking_tpu.ops.oracle import oracle_counts, oracle_king_from_counts
from cuking_tpu.utils.synthetic import random_genotypes

from tests.test_engine import assert_resultsets_equal, oracle_resultset

pytestmark = pytest.mark.gpu


def _same_kin(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return (a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a) & np.isnan(b))


def test_epilogue_division_is_ieee_on_gpu(gpu):
    """XLA:GPU's own f32 division (PTX div.full.f32) is within 2 ulp, not
    IEEE; the epilogue's exact division must match numpy bit for bit on
    the card, and so must kin from random counters."""
    rng = np.random.default_rng(0)
    n = 1 << 22
    num = rng.integers(-(1 << 24), 1 << 24, n).astype(np.float32)
    den = (4 * rng.integers(0, 1 << 22, n)).astype(np.float32)
    den[:1000] = 0
    got = np.asarray(jax.jit(_div_rn)(jax.device_put(num, gpu),
                                      jax.device_put(den, gpu)))
    with np.errstate(divide="ignore", invalid="ignore"):
        assert _same_kin(got, num / den).all()

    hi = rng.integers(0, 40000, n).astype(np.int32)
    hj = rng.integers(0, 40000, n).astype(np.int32)
    bh = (np.minimum(hi, hj) * rng.random(n)).astype(np.int32)
    oh = rng.integers(0, 30000, n).astype(np.int32)
    z = np.zeros(n, np.int32)
    counts = KingCounts(bh, hi, hj, oh, z, z)
    kin = jax.jit(king_from_counts)(KingCounts(*map(jnp.asarray, counts))).kin
    assert _same_kin(kin, oracle_king_from_counts(counts)[0]).all()


def test_matmul_counts_match_oracle_at_100k_sites(gpu):
    """The int8 matmul (cuBLAS on the card) at a real site width."""
    g = random_genotypes(96, 100_000, missing_rate=0.05, seed=21,
                         num_related_pairs=2)
    g[7] = -1
    layout = PlaneLayout.create(100_000)
    planes = jnp.asarray(pack_genotypes(g, layout))
    got = jax.jit(panel_counts_matmul)(planes[:, :32], planes[:, 32:])
    exp = np.concatenate(
        [np.stack(oracle_counts(g[r:r + 8], g[32:])) for r in range(0, 32, 8)],
        axis=1,
    )
    for k, name in enumerate(KingCounts._fields):
        assert np.array_equal(np.asarray(getattr(got, name)), exp[k]), name


def test_engine_on_gpu_matches_oracle(gpu):
    """The batched engine sweep on the card, several panels, default
    threshold and keep-all."""
    g = random_genotypes(300, 5000, missing_rate=0.05, seed=22,
                         num_related_pairs=5)
    for threshold in (0.0884, -2.0):
        cfg = KingConfig(panel=128, kin_threshold=threshold,
                         max_results=300 * 300, sweep_batch=4)
        got = KingEngine.from_genotypes(g, cfg).run()
        assert_resultsets_equal(got, oracle_resultset(g, threshold))


def test_ring_one_gpu_matches_engine(gpu):
    """The mesh ring on a one-GPU mesh emits the engine's rows exactly."""
    from jax.sharding import Mesh

    from cuking_tpu.models.king import _resolve_kernel
    from cuking_tpu.parallel.ring import all_pairs_sharded, ring_output_to_resultset

    g = random_genotypes(300, 5000, missing_rate=0.05, seed=23,
                         num_related_pairs=5)
    layout = PlaneLayout.create(5000)
    mesh = Mesh(np.array([gpu]), axis_names=("samples",))
    out = all_pairs_sharded(
        pack_genotypes(g, layout), 300, mesh, _resolve_kernel(KingConfig()),
        kin_threshold=0.0884, capacity_per_device=4096, sub_panel=128,
    )
    assert_resultsets_equal(ring_output_to_resultset(out),
                            oracle_resultset(g, 0.0884))
