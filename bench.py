#!/usr/bin/env python3
"""Benchmark: sample pairs per second on one GPU (BASELINE.json).

Runs the full KingEngine sweep (jitted panel steps: int8 indicator matmul,
fp32 epilogue, threshold, on-device compaction) on one GPU over synthetic
packed planes at 100k sites and reports unique-pair throughput.  Further
sections: the 1M-site regime, a hit-bearing sweep at the default
threshold, the count kernel alone on one panel pair, host ingest, and the
mesh ring path on one device.

``vs_baseline``: ratio against the straightforward XLA popcount
implementation on the SAME card (the direct translation of the reference's
per-pair popcount approach, cuking.cu:216-240) — the reference itself
publishes no numbers (BASELINE.md), so the baseline is the non-matmul path.

Every time is a host clock around work that ends in ``block_until_ready``
(or a host fetch).  Progress goes to stderr; the last stdout line is one
JSON object naming the device.  Exits non-zero when JAX finds no GPU or any
section fails.

Usage: python bench.py
"""

import dataclasses
import json
import sys
import time

import numpy as np

T_START = time.monotonic()


def log(msg):
    print(f"[{time.monotonic() - T_START:6.1f}s] {msg}", file=sys.stderr,
          flush=True)


def timed_runs(fn, n):
    """Wall seconds of ``n`` calls of ``fn`` (which must block)."""
    runs = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        runs.append(time.perf_counter() - t0)
    return runs


def main() -> int:
    sys.path.insert(0, ".")
    from cuking_tpu.utils.compile_cache import enable_compile_cache
    from cuking_tpu.utils.device import NoGpuError, describe, require_gpu

    enable_compile_cache()
    try:
        device = require_gpu()
    except NoGpuError as e:
        print(f"bench.py: {e}", file=sys.stderr)
        return 1
    info = describe(device)
    log(f"device: {info}")

    import jax

    from cuking_tpu.models.king import (
        KingConfig, KingEngine, PanelStorage, _resolve_kernel,
    )
    from cuking_tpu.ops.bitset import PlaneLayout
    from cuking_tpu.ops.king_jnp import panel_counts_popcount
    from cuking_tpu.parallel.submatrix import Submatrix

    result = {
        "metric": "sample-pairs/sec/chip @ 100000 sites (KING kinship+IBS)",
        "value": 0,
        "unit": "pairs/s",
        "vs_baseline": 0.0,
        "device": info,
        "diagnostics": {},
    }
    diag = result["diagnostics"]

    # 32k samples: production cohorts are at least this large, and the
    # fixed per-dispatch host latency amortizes over a long sweep.
    num_samples, num_sites, panel = 32768, 100_000, 1024
    layout = PlaneLayout.create(num_sites)
    config = KingConfig(
        kin_threshold=0.9,  # random data ⇒ no hits: measures pure compute
        panel=panel, sweep_batch=16,
    )
    storage = PanelStorage(layout, Submatrix.create(num_samples, 1, 0), panel)
    rng = np.random.default_rng(0)
    storage.planes[:] = rng.integers(
        0, 2**32, storage.planes.shape, dtype=np.uint32
    )
    engine = KingEngine(storage, config)
    unique_pairs = num_samples * (num_samples - 1) / 2

    def ms(runs):
        return [r * 1e3 for r in runs]

    # ---- headline: engine sweep at 100k sites ------------------------------
    t0 = time.perf_counter()
    engine.run()  # compiles the sweep
    diag["warmup_compile_s"] = time.perf_counter() - t0
    sweep_runs = timed_runs(engine.run, 5)
    dt = float(np.median(sweep_runs))
    result["value"] = unique_pairs / dt
    diag["sweep_runs_ms"] = ms(sweep_runs)
    log(f"engine sweep: median {dt * 1e3:.1f} ms over {len(sweep_runs)} "
        f"runs -> {unique_pairs / dt / 1e6:.1f} M pairs/s")

    planes_dev = engine.planes_dev
    pi = planes_dev[:, :panel]
    pj = planes_dev[:, panel:2 * panel]

    def panel_pair_rate(kernel):
        fn = jax.jit(kernel)
        jax.block_until_ready(fn(pi, pj))
        runs = timed_runs(lambda: jax.block_until_ready(fn(pi, pj)), 5)
        return panel * panel / float(np.median(runs)), runs

    # ---- popcount baseline (one panel pair) --------------------------------
    base_rate, base_runs = panel_pair_rate(
        lambda a, b: panel_counts_popcount(a, b, row_block=8)
    )
    result["vs_baseline"] = result["value"] / base_rate
    diag["popcount_baseline_pairs_per_sec"] = base_rate
    log(f"popcount baseline: {base_rate / 1e6:.2f} M pairs/s "
        f"({ms(base_runs)} ms per panel pair)")

    # ---- count kernel alone (one panel pair) -------------------------------
    kern_rate, kern_runs = panel_pair_rate(_resolve_kernel(config))
    diag["kernel_only_pairs_per_sec"] = kern_rate
    diag["kernel_only_runs_ms"] = ms(kern_runs)
    log(f"kernel only: {kern_rate / 1e6:.1f} M pairs/s")

    # ---- 1M sites (gnomAD QC-site scale, BASELINE.json cfg 2) --------------
    num_samples_1m, num_sites_1m = 16384, 1_000_000
    layout_1m = PlaneLayout.create(num_sites_1m)
    storage_1m = PanelStorage(
        layout_1m, Submatrix.create(num_samples_1m, 1, 0), panel
    )
    # One random panel tiled across the cohort: the matmul time does not
    # depend on content, and the 0.9 threshold suppresses the tiles' kin=0.5
    # duplicates, at 1/16th of the host-side generation cost.
    reps = storage_1m.planes.shape[1] // panel
    storage_1m.planes[:] = np.tile(
        rng.integers(0, 2**32, (2, panel, layout_1m.words), dtype=np.uint32),
        (1, reps, 1),
    )
    engine_1m = KingEngine(storage_1m, config)
    engine_1m.run()
    runs_1m = timed_runs(engine_1m.run, 3)
    pairs_1m = num_samples_1m * (num_samples_1m - 1) / 2
    diag["pairs_per_sec_1m_sites"] = pairs_1m / float(np.median(runs_1m))
    diag["sweep_1m_runs_ms"] = ms(runs_1m)
    log(f"1M-site sweep: {diag['pairs_per_sec_1m_sites'] / 1e6:.1f} M pairs/s")
    del engine_1m, storage_1m

    # ---- hit-bearing sweep: 512 clone families of 8 (kin 0.5 within) -------
    family, members = 512, 8
    for fam in range(family):
        src = fam * members
        storage.planes[:, src + 1:src + members, :] = (
            storage.planes[:, src:src + 1, :]
        )
    storage.mark_mutated()
    engine.config = dataclasses.replace(engine.config, kin_threshold=0.0884)
    rs = engine.run()
    hitful_runs = timed_runs(engine.run, 5)
    diag["pairs_per_sec_hitful_default_threshold"] = (
        unique_pairs / float(np.median(hitful_runs))
    )
    diag["hitful_runs_ms"] = ms(hitful_runs)
    diag["hits_emitted"] = len(rs)
    diag["hits_planted"] = family * members * (members - 1) // 2
    log(f"hit-bearing sweep: {len(rs)} hits, "
        f"{diag['pairs_per_sec_hitful_default_threshold'] / 1e6:.1f} M pairs/s")

    # ---- host ingest: COO → bit-plane packing ------------------------------
    from cuking_tpu.native import packer as native_packer
    from cuking_tpu.ops.bitset import allocate_planes, clear_bits_coo

    n_ing_samples, n_entries = 2048, 4_000_000
    ing_planes = allocate_planes(n_ing_samples, layout)
    rng2 = np.random.default_rng(1)
    ing_offs = rng2.integers(0, n_ing_samples, n_entries).astype(np.int64)
    ing_sites = rng2.integers(0, num_sites, n_entries).astype(np.int64)
    ing_nalt = rng2.integers(0, 3, n_entries).astype(np.int32)

    def ingest_rate(fn):
        return n_entries / min(timed_runs(fn, 3))

    diag["ingest_entries_per_sec_numpy"] = ingest_rate(lambda: clear_bits_coo(
        ing_planes, layout, ing_offs, ing_sites, ing_nalt))
    if native_packer.available():
        diag["ingest_entries_per_sec_native"] = ingest_rate(
            lambda: native_packer.clear_bits(
                ing_planes, layout, ing_offs, ing_sites, ing_nalt))
    log(f"ingest: {diag['ingest_entries_per_sec_numpy'] / 1e6:.1f} M entries/s "
        f"numpy, {diag.get('ingest_entries_per_sec_native', 0) / 1e6:.1f} M "
        f"native")

    # ---- the mesh ring path on one device (same pairs as the sweep) --------
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from cuking_tpu.parallel.ring import all_pairs_presharded

    mesh = Mesh(np.array(jax.devices()[:1]), axis_names=("samples",))
    planes_sharded = jax.device_put(
        storage.planes, NamedSharding(mesh, P(None, "samples", None))
    )
    ring_kernel = _resolve_kernel(config)

    def ring_run():
        out = all_pairs_presharded(
            planes_sharded, num_samples, mesh, ring_kernel,
            kin_threshold=0.0884, capacity_per_device=1 << 20,
            sub_panel=panel,
        )
        jax.block_until_ready(out.counts)

    ring_run()
    ring_runs = timed_runs(ring_run, 3)
    diag["pairs_per_sec_ring_path_1dev"] = (
        unique_pairs / float(np.median(ring_runs))
    )
    diag["ring_runs_ms"] = ms(ring_runs)
    log(f"ring path: {diag['pairs_per_sec_ring_path_1dev'] / 1e6:.1f} M pairs/s")

    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
