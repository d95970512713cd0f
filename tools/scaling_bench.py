#!/usr/bin/env python3
"""Multi-GPU scaling harness: pairs/s per card vs device count (BASELINE.md
target: ≥85% scaling efficiency at N≥2).

Weak-scaling sweep over the PRODUCTION distributed path
(`parallel.ring.all_pairs_presharded` — the same shard_map + lax.ppermute
ring `--use_mesh/--distributed` runs): per-device resident rows stay
constant, the cohort grows with D, pair work grows ~D²/2, so ideal
pairs/s per card is flat.  For each D it reports pairs/s per card and
efficiency relative to D=1.

By backend:
- GPU, D≥2: also captures a profiler trace of one sweep and measures the
  ppermute/compute overlap (fraction of collective time covered by the same
  card's compute, tools/trace_report.ppermute_overlap) — the ring
  schedule's cross-rotation overlap claim, measured rather than asserted.
  Exits 1 if efficiency < --min-efficiency (default 0.85) unless
  --no-assert.
- CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=8
  JAX_PLATFORMS=cpu): validates the multi-device SCHEDULE and takes no
  time at all — hit totals must be identical across every D (the same
  global pair set swept by construction, parallel/ring.py ring_schedule).

Run: python tools/scaling_bench.py [--rows-per-chip 16384] [--sites 100000]
     [--devices 1 2 4] [--no-assert]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, ".")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows-per-chip", type=int, default=None,
                    help="resident samples per device (default: 16384 GPU / 64 CPU)")
    ap.add_argument("--sites", type=int, default=None)
    ap.add_argument("--devices", type=int, nargs="*", default=None,
                    help="device counts to sweep (default: 1..N available)")
    ap.add_argument("--min-efficiency", type=float, default=0.85)
    ap.add_argument("--no-assert", action="store_true")
    ap.add_argument("--trace-dir", default=os.path.join(
        tempfile.gettempdir(), "cuking_scaling_trace"))
    args = ap.parse_args()

    from cuking_tpu.utils.compile_cache import enable_compile_cache
    from cuking_tpu.utils.device import nvidia_smi_line

    enable_compile_cache()
    import jax

    import jax.numpy as jnp

    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from cuking_tpu.models.king import KingConfig, _resolve_kernel
    from cuking_tpu.ops.bitset import PlaneLayout, allocate_planes, pack_genotypes
    from cuking_tpu.parallel.ring import (
        all_pairs_presharded, ring_global_counts, ring_num_steps,
    )
    from cuking_tpu.utils.synthetic import random_genotypes

    backend = jax.default_backend()
    on_gpu = backend == "gpu"
    devices = jax.devices()
    card = nvidia_smi_line() if on_gpu else "no GPU"
    print(f"backend={backend} devices={devices} card={card}", file=sys.stderr)

    rows_per_chip = args.rows_per_chip or (16384 if on_gpu else 64)
    num_sites = args.sites or (100_000 if on_gpu else 2_000)
    chunk = 128 if on_gpu else 16
    sub_panel = 1024 if on_gpu else 32
    kernel = _resolve_kernel(KingConfig(site_chunk_words=chunk))
    ds = args.devices or list(range(1, len(devices) + 1))
    ds = sorted(set(d for d in ds if 1 <= d <= len(devices)))
    if not ds:
        print(f"No requested device count is available: asked for "
              f"{args.devices}, have {len(devices)} device(s).",
              file=sys.stderr)
        return 1

    layout = PlaneLayout.create(num_sites)
    max_rows = rows_per_chip * max(ds)
    rng = np.random.default_rng(0)
    if on_gpu:
        # Random packed words: dense defined genotypes, ~no hits at the 0.9
        # timing threshold — measures pure compute like bench.py.
        planes_all = rng.integers(
            0, 2**32, (2, max_rows, layout.words), dtype=np.uint32
        )
        # Seed hits so the emit path runs: clone 4-sample families in the
        # first chip's block (kin=0.5 between clones at any D).
        for fam in range(32):
            src = fam * 4
            for m in range(1, 4):
                planes_all[:, src + m, :] = planes_all[:, src, :]
        expected_hits = 32 * 4 * 3 // 2
    else:
        # CPU: small genuine genotypes so the oracle hit count is checkable.
        g = random_genotypes(max_rows, num_sites, missing_rate=0.05, seed=1,
                             num_related_pairs=0)
        for fam in range(8):
            src = fam * 4
            for m in range(1, 4):
                g[src + m] = g[src]
        planes_all = allocate_planes(max_rows, layout)
        planes_all[:] = pack_genotypes(g, layout)
        expected_hits = 8 * 4 * 3 // 2
    threshold = 0.4  # clones (kin=0.5) pass; unrelated random pairs don't

    results = []
    for d in ds:
        mesh = Mesh(np.array(devices[:d]), axis_names=("samples",))
        n = rows_per_chip * d
        # Clone row 0 into the LAST row so related pairs span from the first
        # to the last device block — the emit path is exercised across the
        # ring, not just within device 0's resident rows.  Row 0's family is
        # rows 0..3, so the clone at n-1 adds 4 pairs.
        planes_host = planes_all[:, :n, :].copy()
        planes_host[:, n - 1, :] = planes_host[:, 0, :]
        expected_d = expected_hits + 4
        planes_sharded = jax.device_put(
            jnp.asarray(planes_host), NamedSharding(mesh, P(None, "samples", None))
        )
        ring_args = dict(capacity_per_device=1 << 16, sub_panel=sub_panel)
        out = all_pairs_presharded(
            planes_sharded, n, mesh, kernel,
            kin_threshold=threshold, **ring_args,
        )
        hits = int(ring_global_counts(out).sum())
        jax.block_until_ready(out.counts)  # warm-up + compile
        if hits != expected_d:
            print(f"D={d}: HIT MISMATCH got {hits} expected {expected_d}",
                  file=sys.stderr)
            return 1

        row = {"devices": d, "samples": n, "ring_steps": ring_num_steps(d),
               "hits": hits}
        results.append(row)
        if not on_gpu:  # a virtual CPU mesh says nothing about the card
            print(f"D={d}: {n} samples, {hits} hits (timing not measured)",
                  file=sys.stderr)
            continue
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = all_pairs_presharded(
                planes_sharded, n, mesh, kernel,
                kin_threshold=threshold, **ring_args,
            )
            jax.block_until_ready(out.counts)
            runs.append(time.perf_counter() - t0)
        dt = float(np.median(runs))
        per_chip = n * (n - 1) / 2 / dt / d
        row.update(runs_s=runs, median_s=dt, pairs_per_sec_per_chip=per_chip)
        print(f"D={d}: {n} samples, {dt*1e3:8.1f} ms -> "
              f"{per_chip/1e6:7.1f} M pairs/s per card "
              f"({ring_num_steps(d)} ring steps, {hits} hits) on {card}",
              file=sys.stderr)

    if not on_gpu:
        # CPU mesh: the schedule property, not time — every D swept the
        # same global pair set, so hit totals must agree exactly.
        totals = {r["devices"]: r["hits"] for r in results}
        print(json.dumps({"backend": backend, "weak_scaling": results}))
        if len(set(totals.values())) != 1:
            print(f"FAIL: hit totals differ across D: {totals}",
                  file=sys.stderr)
            return 1
        print("CPU mesh: schedule validated (identical hit totals across "
              f"D={sorted(totals)}; timing not measured on a virtual mesh)",
              file=sys.stderr)
        return 0

    # Efficiency denominator: the single-device measurement.  If D=1 was
    # not swept, fall back to the smallest D measured — but say so, since
    # the BASELINE >=85% target is defined against one chip.
    one = next((r for r in results if r["devices"] == 1), None)
    base_r = one or results[0]
    base = base_r["pairs_per_sec_per_chip"]
    eff_key = ("efficiency_vs_1dev" if one is not None
               else f"efficiency_vs_{base_r['devices']}dev")
    if one is None:
        print(f"WARNING: D=1 not in the sweep; efficiency is relative to "
              f"D={base_r['devices']} (add 1 to --devices for the real "
              f"per-chip baseline).", file=sys.stderr)
    for r in results:
        r[eff_key] = round(r["pairs_per_sec_per_chip"] / base, 3)

    overlap = None
    if max(ds) > 1:
        # Trace one sweep at the largest D and measure ppermute overlap.
        from tools.trace_report import ppermute_overlap

        d = max(ds)
        mesh = Mesh(np.array(devices[:d]), axis_names=("samples",))
        n = rows_per_chip * d
        planes_sharded = jax.device_put(
            jnp.asarray(planes_all[:, :n, :]),
            NamedSharding(mesh, P(None, "samples", None)),
        )
        with jax.profiler.trace(args.trace_dir):
            out = all_pairs_presharded(
                planes_sharded, n, mesh, kernel, kin_threshold=threshold + 0.01,
                capacity_per_device=1 << 16, sub_panel=sub_panel,
            )
            jax.block_until_ready(out.counts)
        overlap = ppermute_overlap(args.trace_dir)
        print(f"ppermute overlap @ D={d}: {overlap}", file=sys.stderr)

    report = {
        "backend": backend,
        "card": card,
        "weak_scaling": results,
        "ppermute_overlap": overlap,
        "target_efficiency": args.min_efficiency,
    }
    print(json.dumps(report))

    if not args.no_assert:
        bad = [r for r in results
               if r["devices"] >= 2
               and r[eff_key] < args.min_efficiency]
        if bad:
            print(f"FAIL: scaling efficiency below "
                  f"{args.min_efficiency}: {bad}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
