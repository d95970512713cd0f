"""Host-sharded storage + presharded ring sweep on the 8-device CPU mesh.

Single-process degenerate case: all devices are local, so the host-sharded
path must reproduce the replicated-ingest path bit-for-bit — same global
plane array, same results.  (True multi-host behavior differs only in which
blocks are local; the arithmetic is identical.)
"""

import os

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from cuking_tpu.io.parquet_ingest import ingest_parquet
from cuking_tpu.io.synthetic_input import write_synthetic_input
from cuking_tpu.io.uri import Storage
from cuking_tpu.io.writer import read_results_table
from cuking_tpu.ops.bitset import PlaneLayout, pack_genotypes
from cuking_tpu.ops.king_mm import panel_counts_matmul
from cuking_tpu.parallel.distributed import HostShardedStorage
from cuking_tpu.parallel.ring import (
    all_pairs_presharded,
    all_pairs_sharded,
    ring_output_to_resultset,
)
from cuking_tpu.utils.synthetic import random_genotypes

from tests.test_engine import assert_resultsets_equal, oracle_resultset


def make_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), axis_names=("samples",))


def kernel(pi, pj):
    return panel_counts_matmul(pi, pj, site_chunk_words=16)


def test_host_sharded_storage_row_mapping():
    layout = PlaneLayout.create(100, words_multiple=16)
    mesh = make_mesh(4)
    st = HostShardedStorage(layout, 30, mesh)
    assert st.nd == 8 and st.n_pad == 32
    idx = np.arange(35)
    contains = st.contains(idx)
    # All devices local in single process; indices < num_samples stored.
    assert contains[:30].all() and not contains[30:].any()
    offs = st.storage_offsets(idx[:30])
    # Mesh-order blocks ⇒ identity mapping in the single-process case.
    np.testing.assert_array_equal(offs, idx[:30])


def test_host_sharded_ingest_matches_replicated(tmp_path):
    g = random_genotypes(43, 300, missing_rate=0.1, seed=41, num_related_pairs=3)
    storage = Storage()
    input_uri = str(tmp_path / "in.parquet")
    os.makedirs(input_uri)
    write_synthetic_input(storage, input_uri, g)
    files = storage.list_parquet_files(input_uri)

    layout = PlaneLayout.create(300, words_multiple=16)
    mesh = make_mesh(8)
    st = HostShardedStorage(layout, 43, mesh)
    ingest_parquet(storage, files, st, num_reader_threads=4)

    global_arr = st.to_global_array()
    assert global_arr.shape == (2, st.n_pad, layout.words)
    # Stored rows must equal the direct dense packing; padding all-missing.
    packed = pack_genotypes(g, layout)
    got = np.asarray(global_arr)
    np.testing.assert_array_equal(got[:, :43, :], packed)
    assert (got[:, 43:, :] == 0xFFFFFFFF).all()

    out = all_pairs_presharded(
        global_arr, 43, mesh, kernel, kin_threshold=0.05,
        capacity_per_device=4096,
    )
    got_rs = ring_output_to_resultset(out)
    exp = oracle_resultset(g, 0.05)
    assert len(exp) > 0
    assert_resultsets_equal(got_rs, exp)


def test_host_sharded_row_multiple_padding():
    """A cohort that does not divide the mesh rounds the per-device row
    count up (19 over 4 devices: 5 rows each); the padding rows stay
    missing and self-mask."""
    g = random_genotypes(19, 200, missing_rate=0.1, seed=44, num_related_pairs=2)
    layout = PlaneLayout.create(200, words_multiple=16)
    mesh = make_mesh(4)
    st = HostShardedStorage(layout, 19, mesh)
    assert st.nd == 5 and st.n_pad == 20
    stored = np.arange(19)
    st.planes[:, st.storage_offsets(stored), :] = pack_genotypes(g, layout)
    out = all_pairs_presharded(
        st.to_global_array(), 19, mesh, kernel, kin_threshold=0.05,
        capacity_per_device=1024,
    )
    got = ring_output_to_resultset(out)
    exp = oracle_resultset(g, 0.05)
    assert len(exp) > 0
    assert_resultsets_equal(got, exp)


def test_presharded_equals_sharded_entry():
    g = random_genotypes(50, 400, missing_rate=0.05, seed=42, num_related_pairs=2)
    layout = PlaneLayout.create(400, words_multiple=16)
    planes = pack_genotypes(g, layout)
    mesh = make_mesh(8)
    out1 = all_pairs_sharded(
        planes, 50, mesh, kernel, kin_threshold=0.05, capacity_per_device=1024,
    )
    rs1 = ring_output_to_resultset(out1)

    st = HostShardedStorage(layout, 50, mesh)
    stored = np.arange(50)
    st.planes[:, st.storage_offsets(stored), :] = planes[:, stored, :]
    out2 = all_pairs_presharded(
        st.to_global_array(), 50, mesh, kernel, kin_threshold=0.05,
        capacity_per_device=1024,
    )
    rs2 = ring_output_to_resultset(out2)
    assert_resultsets_equal(rs1, rs2)


def test_cli_distributed_refuses_degraded_multihost(tmp_path, monkeypatch, capsys):
    """ADVICE r1 (medium): when the environment names a coordinator
    (JAX_COORDINATOR_ADDRESS) and jax.distributed.initialize() fails,
    degrading to a single-process mesh would compute a partial device set
    per host and race on part-00000 — refuse unless
    --allow_single_process."""
    from cuking_tpu import cli

    def boom():
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.2:8476")

    g = random_genotypes(24, 200, missing_rate=0.1, seed=45, num_related_pairs=2)
    storage = Storage()
    input_uri = str(tmp_path / "in.parquet")
    os.makedirs(input_uri)
    write_synthetic_input(storage, input_uri, g)
    argv = [
        "--input_uri", input_uri,
        "--output_uri", str(tmp_path / "out.parquet"),
        "--kernel", "matmul", "--kin_threshold", "0.05",
        "--distributed", "--quiet",
    ]
    assert cli.main(argv) == 1
    assert "JAX_COORDINATOR_ADDRESS" in capsys.readouterr().err

    # Explicit override: proceed single-process.
    assert cli.main(argv + ["--allow_single_process"]) == 0
    # Plain local environment (no coordinator named): fallback stays implicit.
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
    assert cli.main(argv) == 0


def test_cli_distributed_single_process(tmp_path):
    """--distributed in one process: host-sharded ingest + presharded ring +
    per-process partition; output equals the oracle."""
    from cuking_tpu import cli

    g = random_genotypes(40, 300, missing_rate=0.1, seed=43, num_related_pairs=3)
    storage = Storage()
    input_uri = str(tmp_path / "in.parquet")
    os.makedirs(input_uri)
    write_synthetic_input(storage, input_uri, g)
    rc = cli.main([
        "--input_uri", input_uri,
        "--output_uri", str(tmp_path / "out.parquet"),
        "--kernel", "matmul", "--kin_threshold", "0.05",
        "--distributed", "--quiet",
    ])
    assert rc == 0
    table = read_results_table(storage, str(tmp_path / "out.parquet"))
    exp = oracle_resultset(g, 0.05)
    assert table.num_rows == len(exp)
    np.testing.assert_array_equal(
        np.asarray(table.column("kin"), dtype=np.float32), exp.kin
    )


def test_cli_result_capacity_flag(tmp_path):
    """--result_capacity pre-sizes the engine's device result buffer; a
    too-small value still succeeds via the pow2 overflow retry and the
    output matches the default-capacity run exactly."""
    from cuking_tpu import cli

    g = random_genotypes(32, 200, missing_rate=0.0, seed=48)
    storage = Storage()
    input_uri = str(tmp_path / "in.parquet")
    os.makedirs(input_uri)
    write_synthetic_input(storage, input_uri, g)

    outs = {}
    for name, extra in [
        ("default", []),
        ("tiny", ["--result_capacity", "8"]),
        ("presized", ["--result_capacity", "4096"]),
    ]:
        out_uri = str(tmp_path / f"out_{name}.parquet")
        rc = cli.main([
            "--input_uri", input_uri, "--output_uri", out_uri,
            "--kernel", "matmul", "--kin_threshold", "-2.0",
            "--panel", "16", "--quiet"] + extra)
        assert rc == 0, name
        outs[name] = read_results_table(storage, out_uri)
    assert outs["tiny"].num_rows == 32 * 31 // 2  # capacity 8 overflowed
    assert outs["tiny"].equals(outs["default"])
    assert outs["presized"].equals(outs["default"])


def test_cli_capacity_per_device_flag(tmp_path):
    """--capacity_per_device small enough to overflow: the ring auto-retries
    at a pow2-bucketed capacity and the run still matches the
    single-device output."""
    from cuking_tpu import cli

    g = random_genotypes(32, 200, missing_rate=0.0, seed=47)
    storage = Storage()
    input_uri = str(tmp_path / "in.parquet")
    os.makedirs(input_uri)
    write_synthetic_input(storage, input_uri, g)

    outs = {}
    for name, extra in [
        ("single", []),
        ("tiny_cap", ["--use_mesh", "--capacity_per_device", "8"]),
    ]:
        out_uri = str(tmp_path / f"out_{name}.parquet")
        rc = cli.main([
            "--input_uri", input_uri, "--output_uri", out_uri,
            "--kernel", "matmul", "--kin_threshold", "-2.0",
            "--panel", "16", "--quiet"] + extra)
        assert rc == 0, name
        outs[name] = read_results_table(storage, out_uri)
    assert outs["tiny_cap"].num_rows > 8  # capacity genuinely overflowed
    assert outs["tiny_cap"].equals(outs["single"])


def test_scaling_bench_cpu_mesh_schedule():
    """tools/scaling_bench.py (the multi-GPU scaling harness, VERDICT r3
    #5) — its CPU-mesh mode must validate the multi-device schedule here:
    identical hit totals at every D and exit 0.  The GPU mode of the same
    tool measures pairs/s per card + ppermute overlap."""
    import importlib
    import sys

    sb = importlib.import_module("tools.scaling_bench")
    argv = sys.argv
    sys.argv = ["scaling_bench", "--devices", "1", "2", "4",
                "--rows-per-chip", "64", "--sites", "2000"]
    try:
        rc = sb.main()
    finally:
        sys.argv = argv
    assert rc == 0
