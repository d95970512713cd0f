#!/usr/bin/env python3
"""Smoke test of the KING engine on NVIDIA GPUs, through its user entry points.

    python chip_smoke.py            # one GPU: phases 1-4 below
    python chip_smoke.py --mesh4    # four GPUs: phase 5 only

Phases (one GPU):
  1. Count-kernel parity at real widths: the matmul kernel on a 256×256 slab
     at 100,000 sites and a 64×64 diagonal slab at 1,000,000 sites, each with
     one all-missing sample, against ops/oracle.py; the six counters and kin
     (uint32 bit patterns; NaN only as NaN) must be equal.
  2. The KingEngine sweep over 32,768 samples × 100,000 sites with 512
     planted clone families of 8: the emitted pairs must be exactly the
     14,336 planted ones, every row equal to the oracle; warm-up, the median
     of 3 sweeps and pairs/s are printed with the card's name.
  3. The CLI (needs pyarrow): the committed golden fixture must reproduce
     tests/golden/expected.json bit for bit, and a seed-generated
     Hail-shaped input of 2,048 × 100,000 must go through ingest, sweep and
     write with every emitted row equal to the oracle.
  4. The tests marked ``gpu``, in this process.
With --mesh4 only phase 5 runs: the phase-2 cohort through the mesh ring
over four GPUs (``--use_mesh``), and through its ``--split_factor 2``
composition merged over the 3 shards, must equal the single-device engine
byte for byte; pairs/s per card at D=4 is printed beside D=1.

Everything runs in this one process (a second JAX process could not get the
card's memory).  The script exits non-zero when JAX finds no GPU or any
phase fails; its last stdout line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

FAMILIES, MEMBERS = 512, 8  # 512 × C(8, 2) = 14,336 planted pairs
COHORT, SITES = 32768, 100_000
THRESHOLD = 0.0884  # the CLI's default (cuking.cu:43-45)


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(AssertionError):
    """A phase's output disagreed with its reference."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def _pool() -> ThreadPoolExecutor:
    return ThreadPoolExecutor(max_workers=os.cpu_count() or 1)


def same_kin(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise: equal float32 bit patterns, or both NaN (NaN payloads
    differ between numpy and the GPU; NaN kin is never emitted)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return (a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a) & np.isnan(b))


# -- references and checkers (numpy only; tests run them on tiny cohorts) ---


def oracle_counts_blocked(g_i, g_j, pool, rows: int = 4):
    """ops/oracle.py's counts in row blocks (it broadcasts [NI, NJ, S])."""
    from cuking_tpu.ops.king_math import KingCounts
    from cuking_tpu.ops.oracle import oracle_counts

    parts = list(pool.map(
        lambda r: oracle_counts(g_i[r:r + rows], g_j),
        range(0, len(g_i), rows),
    ))
    return KingCounts(*(np.concatenate(f, axis=0) for f in zip(*parts)))


def cohort_planes(num_samples, layout, families, members, seed):
    """Random packed planes with ``families`` clone families of ``members``
    consecutive samples (kin 0.5 within a family, strongly negative
    elsewhere) and the layout's padding sites missing."""
    from cuking_tpu.ops.bitset import pack_genotypes

    rng = np.random.default_rng(seed)
    planes = rng.integers(
        0, 2**32, (2, num_samples, layout.words), dtype=np.uint32
    )
    # Hom-ref genotypes set no bits except at padding sites (set = missing).
    planes |= pack_genotypes(np.zeros((1, layout.num_sites), np.int8), layout)
    for f in range(families):
        src = f * members
        planes[:, src + 1:src + members] = planes[:, src:src + 1]
    return planes


def planted_pairs(families, members) -> set:
    return {
        (f * members + a, f * members + b)
        for f in range(families)
        for a in range(members)
        for b in range(a + 1, members)
    }


def check_hit_set(results, expected: set) -> None:
    got = set(zip(results.i_idx.tolist(), results.j_idx.tolist()))
    check(len(got) == len(results), "duplicate pairs in the output")
    check(got == expected,
          f"hit set differs: {len(got - expected)} unexpected, "
          f"{len(expected - got)} missing of {len(expected)}")


def check_rows_against_oracle(results, genotype_row, pool) -> None:
    """Every emitted row (kin bits, ibs0/1/2) equals the oracle for its
    pair; ``genotype_row(k)`` is sample k's dense [S] genotypes."""
    from cuking_tpu.ops.oracle import oracle_king

    cache = {}

    def row(k):
        if k not in cache:
            cache[k] = genotype_row(k)[None, :]
        return cache[k]

    for k in sorted(set(results.i_idx.tolist()) | set(results.j_idx.tolist())):
        row(k)

    def one(n):
        kin, ibs0, ibs1, ibs2 = oracle_king(
            row(int(results.i_idx[n])), row(int(results.j_idx[n]))
        )
        return (
            bool(same_kin(kin[0, 0], results.kin[n]))
            and int(ibs0[0, 0]) == int(results.ibs0[n])
            and int(ibs1[0, 0]) == int(results.ibs1[n])
            and int(ibs2[0, 0]) == int(results.ibs2[n])
        )

    ok = list(pool.map(one, range(len(results))))
    bad = [n for n, good in enumerate(ok) if not good]
    check(not bad, f"{len(bad)} of {len(results)} rows differ from the "
                   f"oracle, e.g. row {bad[:1]}")


def plane_genotype_row(planes, layout):
    from cuking_tpu.ops.bitset import planes_to_genotypes

    return lambda k: planes_to_genotypes(planes[:, k:k + 1], layout)[0]


def results_equal(a, b) -> bool:
    """Byte-for-byte equality of two sorted ResultSets."""
    return len(a) == len(b) and all(
        np.asarray(getattr(a, f)).tobytes() == np.asarray(getattr(b, f)).tobytes()
        for f in ("i_idx", "j_idx", "kin", "ibs0", "ibs1", "ibs2")
    )


# -- phases -----------------------------------------------------------------


PARITY_CASES = (  # (sites, rows i, rows j, diagonal, seed)
    (100_000, 256, 256, False, 11),
    (1_000_000, 64, 64, True, 12),
)


def phase_kernel_parity(card: str, pool, cases=PARITY_CASES) -> None:
    import jax

    from cuking_tpu.ops.bitset import PlaneLayout, pack_genotypes
    from cuking_tpu.ops.king_math import KingCounts, king_from_counts
    from cuking_tpu.ops.king_mm import panel_counts_matmul
    from cuking_tpu.ops.oracle import oracle_king_from_counts
    from cuking_tpu.utils.synthetic import random_genotypes

    kernel = jax.jit(
        lambda a, b: (lambda c: (c, king_from_counts(c)))(
            panel_counts_matmul(a, b, site_chunk_words=128))
    )
    for sites, ni, nj, diagonal, seed in cases:
        n = ni if diagonal else ni + nj
        g = random_genotypes(n, sites, missing_rate=0.05, seed=seed,
                             num_related_pairs=2)
        g[3] = -1  # a sample with every site missing
        g_i, g_j = (g, g) if diagonal else (g[:ni], g[ni:])
        layout = PlaneLayout.create(sites)
        pi = jax.device_put(pack_genotypes(g_i, layout))
        pj = pi if diagonal else jax.device_put(pack_genotypes(g_j, layout))
        t0 = time.perf_counter()
        counts, res = jax.block_until_ready(kernel(pi, pj))
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(kernel(pi, pj))
        run_s = time.perf_counter() - t0
        exp = oracle_counts_blocked(g_i, g_j, pool)
        for name, e, a in zip(KingCounts._fields, exp, counts):
            check(np.array_equal(np.asarray(a), e),
                  f"{name} differs from the oracle at {sites} sites")
        exp_kin = oracle_king_from_counts(exp)
        for name, e, a in zip(("kin", "ibs0", "ibs1", "ibs2"), exp_kin, res):
            good = (same_kin(a, e) if name == "kin"
                    else np.asarray(a) == e)
            check(bool(np.all(good)),
                  f"{name} differs from the oracle at {sites} sites "
                  f"({int(np.size(good) - np.sum(good))} entries)")
        log(f"phase 1 kernel parity: matmul {ni}x{nj} "
            f"{'diagonal ' if diagonal else ''}slab at {sites} sites, one "
            f"all-missing sample: six counters and kin exact (tolerance 0); "
            f"compile+first {compile_s:.2f} s, run {run_s * 1e3:.2f} ms "
            f"on {card}")


def build_cohort(num_samples, num_sites, families, members, panel=1024,
                 seed=0):
    """PanelStorage holding ``cohort_planes`` for the whole matrix."""
    from cuking_tpu.models.king import PanelStorage
    from cuking_tpu.ops.bitset import PlaneLayout
    from cuking_tpu.parallel.submatrix import Submatrix

    layout = PlaneLayout.create(num_sites)
    planes = cohort_planes(num_samples, layout, families, members, seed)
    storage = PanelStorage(layout, Submatrix.create(num_samples, 1, 0), panel)
    storage.planes[:, :num_samples] = planes
    return storage, planes, layout


def engine_sweep(storage, repeats: int = 3):
    """(results, warm-up seconds, per-sweep seconds) of the engine sweep at
    the default threshold."""
    from cuking_tpu.models.king import KingConfig, KingEngine

    engine = KingEngine(storage, KingConfig(kin_threshold=THRESHOLD,
                                            panel=storage.panel))
    t0 = time.perf_counter()
    results = engine.run()
    warm = time.perf_counter() - t0
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        results = engine.run()  # ends in a host fetch of the hits
        runs.append(time.perf_counter() - t0)
    return results, warm, runs


def phase_engine(card: str, pool) -> None:
    storage, planes, layout = build_cohort(COHORT, SITES, FAMILIES, MEMBERS)
    results, warm, runs = engine_sweep(storage)
    pairs = COHORT * (COHORT - 1) / 2
    check_hit_set(results, planted_pairs(FAMILIES, MEMBERS))
    check_rows_against_oracle(results, plane_genotype_row(planes, layout), pool)
    med = float(np.median(runs))
    log(f"phase 2 engine sweep {COHORT} x {SITES}: {len(results)} hits = "
        f"the {len(results)} planted pairs, every row equal to the oracle; "
        f"warm-up (incl. compile) {warm:.2f} s, sweeps {runs} s, median "
        f"{med:.4f} s -> {pairs / med / 1e6:.1f} M pairs/s on {card}")
    import jax

    from cuking_tpu.models.king import KingConfig
    from cuking_tpu.utils.hbm import engine_plane_bytes, sweep_buffer_bytes

    modeled = (engine_plane_bytes(storage.submatrix, layout.words, storage.panel)
               + sweep_buffer_bytes(KingConfig(panel=storage.panel)))
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
    log(f"phase 2 device memory: peak_bytes_in_use {peak} vs the capacity "
        f"model's {modeled} bytes (utils/hbm.py)")


def read_partition_rows(path: str):
    import pyarrow.parquet as pq

    t = pq.read_table(path).to_pydict()
    return [
        {
            "i": t["i"][k], "j": t["j"][k],
            "kin_bits": struct.unpack("<I", struct.pack("<f", t["kin"][k]))[0],
            "ibs0": t["ibs0"][k], "ibs1": t["ibs1"][k], "ibs2": t["ibs2"][k],
        }
        for k in range(len(t["i"]))
    ]


def phase_cli(card: str, pool, n: int = 2048, sites: int = 100_000) -> None:
    from cuking_tpu import cli
    from cuking_tpu.io.synthetic_input import write_synthetic_input
    from cuking_tpu.io.uri import Storage
    from cuking_tpu.models.king import ResultSet
    from cuking_tpu.utils.synthetic import random_genotypes

    golden = os.path.join(ROOT, "tests", "golden")
    with open(os.path.join(golden, "expected.json")) as f:
        expected = json.load(f)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke-") as tmp:
        out = os.path.join(tmp, "golden-out")
        rc = cli.main(["--input_uri", os.path.join(golden, "input.parquet"),
                       "--output_uri", out, "--quiet"])
        check(rc == 0, f"CLI exited {rc} on the golden fixture")
        got = read_partition_rows(os.path.join(out, "part-00000.snappy.parquet"))
        check(got == expected["rows_default_threshold"],
              "golden fixture: CLI output differs from tests/golden/expected.json")
        log(f"phase 3 CLI: golden fixture bit-exact ({len(got)} rows) on {card}")

        related = 8
        g = random_genotypes(n, sites, missing_rate=0.05, seed=3,
                             num_related_pairs=related)
        inp, out = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        write_synthetic_input(Storage(), inp, g)
        t0 = time.perf_counter()
        rc = cli.main(["--input_uri", inp, "--output_uri", out, "--quiet"])
        cli_s = time.perf_counter() - t0
        check(rc == 0, f"CLI exited {rc} on the synthetic input")
        rows = read_partition_rows(os.path.join(out, "part-00000.snappy.parquet"))
        res = ResultSet(
            i_idx=np.array([int(r["i"][1:]) for r in rows], np.int32),
            j_idx=np.array([int(r["j"][1:]) for r in rows], np.int32),
            kin=np.array([r["kin_bits"] for r in rows],
                         np.uint32).view(np.float32),
            ibs0=np.array([r["ibs0"] for r in rows], np.int32),
            ibs1=np.array([r["ibs1"] for r in rows], np.int32),
            ibs2=np.array([r["ibs2"] for r in rows], np.int32),
        )
        planted = {(n - 2 * k - 2, n - 2 * k - 1) for k in range(related)}
        emitted = set(zip(res.i_idx.tolist(), res.j_idx.tolist()))
        check(planted <= emitted,
              f"synthetic input: {len(planted - emitted)} planted pairs missing")
        check_rows_against_oracle(res, lambda k: g[k], pool)
        log(f"phase 3 CLI: {n} x {sites} Hail-shaped input through ingest, "
            f"sweep and write in {cli_s:.1f} s; {len(res)} rows, all planted "
            f"pairs present, every row equal to the oracle, on {card}")


def phase_gpu_tests(card: str) -> None:
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "--rootdir", ROOT, os.path.join(ROOT, "tests")])
    check(rc == 0, f"tests marked gpu failed (pytest exit code {rc})")
    log(f"phase 4 tests marked gpu: passed on {card}")


def phase_mesh4(card: str, pool) -> None:
    import jax
    from jax.sharding import Mesh

    from cuking_tpu.models.king import (
        KingConfig, PanelStorage, ResultSet, _resolve_kernel,
    )
    from cuking_tpu.parallel.ring import (
        ring_output_to_resultset, submatrix_pairs_sharded,
    )
    from cuking_tpu.parallel.submatrix import Submatrix, num_shards

    devices = jax.devices()
    check(len(devices) >= 4, f"--mesh4 needs four GPUs, JAX has {devices}")
    mesh = Mesh(np.array(devices[:4]), axis_names=("samples",))
    storage, planes, layout = build_cohort(COHORT, SITES, FAMILIES, MEMBERS)
    single, warm1, runs1 = engine_sweep(storage)
    check_hit_set(single, planted_pairs(FAMILIES, MEMBERS))
    kernel = _resolve_kernel(KingConfig())

    def ring(st):
        out = submatrix_pairs_sharded(
            st, mesh, kernel, kin_threshold=THRESHOLD, sub_panel=1024,
        )
        jax.block_until_ready(out.counts)
        return out

    t0 = time.perf_counter()
    ring(storage)
    warm4 = time.perf_counter() - t0
    runs4 = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = ring(storage)
        runs4.append(time.perf_counter() - t0)
    meshed = ring_output_to_resultset(out)
    check(results_equal(meshed, single),
          "mesh ring output differs from the single-device engine")
    used = {d.id for d in out.counts.sharding.device_set}
    check(used == {d.id for d in devices[:4]},
          "ring output is not spread over the four devices")
    log(f"phase 5 --use_mesh over 4 GPUs: {len(meshed)} rows, byte-for-byte "
        f"equal to the single-device engine")

    parts = []
    for shard in range(num_shards(2)):
        sm = Submatrix.create(COHORT, 2, shard)
        st = PanelStorage(layout, sm, 1024)
        idx = sm.stored_sample_indices()
        st.planes[:, st.storage_offsets(idx)] = planes[:, idx]
        parts.append(ring_output_to_resultset(ring(st)))
    merged = ResultSet.concat_and_sort(parts)
    check(results_equal(merged, single),
          "--split_factor 2 over the mesh differs from the single-device engine")
    log(f"phase 5 --split_factor 2 x --use_mesh: 3 shards merged, "
        f"{len(merged)} rows, byte-for-byte equal to the single-device engine")

    pairs = COHORT * (COHORT - 1) / 2
    d1, d4 = float(np.median(runs1)), float(np.median(runs4))
    log(f"phase 5 D=1 engine: warm-up {warm1:.2f} s, sweeps {runs1} s -> "
        f"{pairs / d1 / 1e6:.1f} M pairs/s per card; D=4 ring: warm-up "
        f"{warm4:.2f} s, sweeps {runs4} s -> {pairs / d4 / 1e6:.1f} M pairs/s, "
        f"{pairs / d4 / 4 / 1e6:.1f} M pairs/s per card; on {card}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh4", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from cuking_tpu.utils.compile_cache import enable_compile_cache
    from cuking_tpu.utils.device import NoGpuError, nvidia_smi_line, require_gpu

    enable_compile_cache()
    try:
        device = require_gpu()
    except NoGpuError as e:
        print(f"chip_smoke.py: {e}", file=sys.stderr)
        return 1
    import jax

    card = nvidia_smi_line()
    log(card)
    log(f"jax.devices() = {jax.devices()}; device_kind = {device.device_kind}; "
        f"memory_stats()['bytes_limit'] = "
        f"{device.memory_stats().get('bytes_limit')} of the card's 80 GB")
    with _pool() as pool:
        if args.mesh4:
            phase_mesh4(card, pool)
        else:
            phase_kernel_parity(card, pool)
            phase_engine(card, pool)
            try:
                import pyarrow  # noqa: F401
            except ImportError:
                log("phase 3 CLI: skipped, pyarrow is not installed here; "
                    "the engine phases are the main path")
            else:
                phase_cli(card, pool)
            phase_gpu_tests(card)
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform,
        "kind": device.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
