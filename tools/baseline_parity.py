#!/usr/bin/env python3
"""BASELINE-scale parity: the full pipeline vs an independent oracle at the
1k-samples x 100k-sites config (BASELINE.json configs 1-4).

The committed golden fixture (tests/golden/, 24x100) pins the numeric
contract on edge cases; this script demonstrates the same bit-exact parity
at the baseline config's stated scale, end to end through the real CLI:

1. **Full-matrix parity** (configs 1+2): one CLI run with a catch-all
   threshold so EVERY finite-kin pair is emitted, compared bit-exactly
   (kin as uint32 patterns, ibs0/1/2 as ints) against an independent
   oracle — float32 GEMMs over 0/1 indicator planes computed with numpy
   only (counts are integer sums < 2^24, so fp32 GEMM accumulation is
   EXACT), kin via the published estimator with one IEEE fp32 rounding
   per op (hail.is/docs/0.2/methods/relatedness.html#hail.methods.king ==
   cuking.cu:286-307).  The GEMM oracle itself is anchored to a per-pair
   scalar loop (make_golden.py's method) on a random spot-check subset.
2. **Thresholded sparse output** (config 3): a CLI run at the reference's
   default 0.0884 threshold must equal the oracle's thresholded subset.
3. **Sharded merge** (config 4): split_factor=4 -> 10 upper-triangular
   shards, each an independent CLI run; the merged partitions must equal
   the unsharded run row-for-row, kin bit-for-bit (README.md:96-100,
   cuking.cu:866-875).

Shares no compute-path code with cuking_tpu: the oracle below is inline
numpy.  Run from the repo root (CPU is fine — this is a parity check, not
a benchmark; ~20-40 min at full scale on one core):

    JAX_PLATFORMS=cpu python tools/baseline_parity.py \
        [--samples 1000 --sites 100000] [--workdir /tmp/baseline_parity]

Smaller scales (tests use --samples 96 --sites 2000) run in seconds.
"""

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, ".")

CATCH_ALL = -1e30  # below any finite fp32 kin; NaN/-inf still excluded


def edge_case_genotypes(n, s, seed):
    """random_genotypes cohort with make_golden.py's edge cases grafted onto
    samples 0-7 so the contract's corners are exercised at scale too."""
    from cuking_tpu.utils.synthetic import random_genotypes

    g = random_genotypes(n, s, missing_rate=0.05, seed=seed,
                         num_related_pairs=5)
    rng = np.random.default_rng(seed + 1)
    g[1] = g[0]                                   # identical pair: kin 0.5
    g[2] = g[0]
    g[2, ::7] = -1                                # identical modulo missing
    g[3] = np.where(g[0] < 0, -1,
                    np.where(g[0] == 1, 1, 2 - g[0]))  # opposing-hom heavy
    g[4] = -1                                     # fully missing sample
    g[5] = np.where(g[5] == 1, 0, g[5])           # zero hets: min_hets=0
    g[6] = 0                                      # all hom-ref
    g[7] = 2                                      # all hom-alt
    del rng
    return g


def oracle_counts_gemm(g, chunk_sites=20_000):
    """Six [N, N] int64 counters via fp32 GEMM over indicator planes.

    Per site-chunk every Gram partial sum is an integer <= chunk_sites
    < 2^24, so float32 accumulation is exact; chunks then accumulate in
    int64.  Plane order: R(=0), H(=1), A(=2), D(defined)."""
    n, s = g.shape
    gram = np.zeros((4 * n, 4 * n), np.int64)
    for lo in range(0, s, chunk_sites):
        gc = g[:, lo:lo + chunk_sites]
        planes = np.concatenate(
            [
                (gc == 0).astype(np.float32),
                (gc == 1).astype(np.float32),
                (gc == 2).astype(np.float32),
                (gc >= 0).astype(np.float32),
            ],
            axis=0,
        )
        gram += (planes @ planes.T).astype(np.int64)
    blk = lambda p, q: gram[p * n:(p + 1) * n, q * n:(q + 1) * n]
    R, H, A, D = 0, 1, 2, 3
    return {
        "both_het": blk(H, H),
        "het_i": blk(H, D),
        "het_j": blk(D, H),
        "opposing_hom": blk(R, A) + blk(A, R),
        "concordant_hom": blk(R, R) + blk(A, A),
        "shared_sites": blk(D, D),
    }


def king_fp32(c):
    """Counts -> (kin, ibs0/1/2) with one IEEE fp32 rounding per op — the
    published estimator exactly as the reference kernel computes it
    (cuking.cu:286-307)."""
    f = np.float32
    bh = c["both_het"].astype(f)
    hi = c["het_i"].astype(f)
    hj = c["het_j"].astype(f)
    oh = c["opposing_hom"].astype(f)
    min_hets = np.minimum(hi, hj)
    with np.errstate(divide="ignore", invalid="ignore"):
        numer = (f(2.0) * bh - f(4.0) * oh - hi) - hj
        kin = f(0.5) + numer / (f(4.0) * min_hets)
    ibs0 = c["opposing_hom"]
    ibs2 = c["concordant_hom"] + c["both_het"]
    ibs1 = c["shared_sites"] - ibs0 - ibs2
    return kin.astype(f), ibs0, ibs1, ibs2


def scalar_spot_check(g, counts, num_pairs, seed):
    """Anchor the GEMM oracle to a direct per-pair scalar count on a random
    pair subset + the grafted edge-case pairs."""
    rng = np.random.default_rng(seed)
    n = g.shape[0]
    pairs = {(0, 1), (0, 2), (0, 3), (0, 4), (5, 6), (6, 7)}
    num_pairs = min(num_pairs, n * (n - 1) // 2)  # else the draw loop spins
    while len(pairs) < num_pairs:
        i, j = rng.integers(0, n, 2)
        if i < j:
            pairs.add((int(i), int(j)))
    for i, j in sorted(pairs):
        gi, gj = g[i], g[j]
        defined = (gi >= 0) & (gj >= 0)
        het_i, het_j = (gi == 1) & defined, (gj == 1) & defined
        expect = {
            "both_het": int(np.sum(het_i & het_j)),
            "het_i": int(np.sum(het_i)),
            "het_j": int(np.sum(het_j)),
            "opposing_hom": int(np.sum((((gi == 0) & (gj == 2))
                                        | ((gi == 2) & (gj == 0))) & defined)),
            "concordant_hom": int(np.sum((((gi == 0) & (gj == 0))
                                          | ((gi == 2) & (gj == 2))) & defined)),
            "shared_sites": int(np.sum(defined)),
        }
        for k, v in expect.items():
            got = int(counts[k][i, j])
            if got != v:
                raise AssertionError(
                    f"GEMM oracle disagrees with scalar count: pair ({i},{j})"
                    f" {k}: gemm={got} scalar={v}"
                )
    return len(pairs)


def expected_table(g, threshold):
    """Oracle (i, j, kin_bits, ibs0/1/2) rows for all i<j with finite kin
    strictly above threshold, sorted by (i, j)."""
    n = g.shape[0]
    counts = oracle_counts_gemm(g)
    npairs = scalar_spot_check(g, counts, num_pairs=40, seed=7)
    kin, ibs0, ibs1, ibs2 = king_fp32(counts)
    iu, ju = np.triu_indices(n, k=1)
    k = kin[iu, ju]
    keep = np.isfinite(k) & (k > np.float32(threshold))
    rows = np.rec.fromarrays(
        [
            iu[keep].astype(np.int64),
            ju[keep].astype(np.int64),
            k[keep].view(np.uint32),
            ibs0[iu, ju][keep],
            ibs1[iu, ju][keep],
            ibs2[iu, ju][keep],
        ],
        names="i,j,kin_bits,ibs0,ibs1,ibs2",
    )
    nonfinite = int(np.sum(~np.isfinite(k)))
    return rows, nonfinite, npairs


def read_output_rows(out_dir, sample_ids):
    """CLI output partitions -> the same record layout as expected_table."""
    import pyarrow.parquet as pq

    idx = {s: k for k, s in enumerate(sample_ids)}
    parts = sorted(
        f for f in os.listdir(out_dir) if f.endswith(".parquet")
    )
    cols = {k: [] for k in ("i", "j", "kin", "ibs0", "ibs1", "ibs2")}
    for p in parts:
        t = pq.read_table(os.path.join(out_dir, p))
        for k in cols:
            cols[k].append(t[k].to_numpy(zero_copy_only=False))
    cat = {k: np.concatenate(v) if v else np.array([]) for k, v in cols.items()}
    i = np.array([idx[s] for s in cat["i"]], np.int64)
    j = np.array([idx[s] for s in cat["j"]], np.int64)
    rows = np.rec.fromarrays(
        [
            i,
            j,
            cat["kin"].astype(np.float32).view(np.uint32),
            cat["ibs0"].astype(np.int64),
            cat["ibs1"].astype(np.int64),
            cat["ibs2"].astype(np.int64),
        ],
        names="i,j,kin_bits,ibs0,ibs1,ibs2",
    )
    order = np.lexsort((rows.j, rows.i))
    return rows[order], len(parts)


def compare(tag, got, want):
    if len(got) != len(want):
        raise AssertionError(
            f"{tag}: row count mismatch: pipeline={len(got)} oracle={len(want)}"
        )
    for field in want.dtype.names:
        bad = np.nonzero(got[field] != want[field])[0]
        if len(bad):
            k = bad[0]
            raise AssertionError(
                f"{tag}: {len(bad)} mismatches in {field}; first at row {k}: "
                f"pipeline={got[k]} oracle={want[k]}"
            )
    print(f"  {tag}: {len(want)} rows bit-identical", file=sys.stderr)


def run_cli(argv):
    from cuking_tpu import cli

    rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"CLI failed ({rc}): {argv}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=1000)
    ap.add_argument("--sites", type=int, default=100_000)
    ap.add_argument("--threshold", type=float, default=0.0884)
    ap.add_argument("--split-factor", type=int, default=4)
    ap.add_argument("--workdir", default="/tmp/baseline_parity")
    ap.add_argument("--panel", type=int, default=0,
                    help="CLI panel override (0 = auto: 256 CPU-friendly)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--keep", action="store_true",
                    help="keep workdir artifacts")
    args = ap.parse_args(argv)

    from cuking_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from cuking_tpu.io.synthetic_input import write_synthetic_input
    from cuking_tpu.io.uri import Storage
    from cuking_tpu.parallel.submatrix import num_shards

    t0 = time.time()
    n, s = args.samples, args.sites
    if n < 9:
        ap.error("--samples must be >= 9 (samples 0-7 carry grafted edge "
                 "cases; at least one regular sample is needed)")
    panel = args.panel or min(256, max(64, 1 << (n - 1).bit_length() >> 2))
    wd = args.workdir
    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd)
    in_dir = os.path.join(wd, "in.parquet")
    os.makedirs(in_dir)

    print(f"[1/5] generating {n} x {s} cohort + Parquet input...",
          file=sys.stderr)
    g = edge_case_genotypes(n, s, args.seed)
    meta = write_synthetic_input(Storage(), in_dir, g, num_partitions=8)
    sample_ids = meta.samples

    print("[2/5] independent GEMM oracle (+ scalar spot-check)...",
          file=sys.stderr)
    want_all, nonfinite, spot = expected_table(g, CATCH_ALL)
    keep = want_all.kin_bits.view(np.float32) > np.float32(args.threshold)
    want_thr = want_all[keep]

    common = ["--input_uri", in_dir, "--kernel", "matmul",
              "--panel", str(panel), "--quiet"]

    print(f"[3/5] full-matrix CLI run (catch-all threshold; "
          f"{len(want_all)} finite pairs, {nonfinite} nonfinite excluded, "
          f"oracle spot-checked on {spot} pairs)...", file=sys.stderr)
    out_full = os.path.join(wd, "out_full.parquet")
    run_cli(common + ["--output_uri", out_full,
                      f"--kin_threshold={CATCH_ALL}",  # = form: argparse
                      # rejects bare "-1e+30" as an unknown flag
                      "--max_results", str(n * n)])
    got, _ = read_output_rows(out_full, sample_ids)
    compare("full-matrix", got, want_all)

    print(f"[4/5] thresholded CLI run (> {args.threshold})...",
          file=sys.stderr)
    out_thr = os.path.join(wd, "out_thr.parquet")
    run_cli(common + ["--output_uri", out_thr,
                      "--kin_threshold", str(args.threshold)])
    got_thr, _ = read_output_rows(out_thr, sample_ids)
    compare("thresholded", got_thr, want_thr)

    k = args.split_factor
    shards = num_shards(k)
    print(f"[5/5] sharded run: split_factor={k} -> {shards} shards...",
          file=sys.stderr)
    out_sh = os.path.join(wd, "out_sharded.parquet")
    for shard in range(shards):
        run_cli(common + ["--output_uri", out_sh,
                          "--kin_threshold", str(args.threshold),
                          "--split_factor", str(k),
                          "--shard_index", str(shard)])
    got_sh, nparts = read_output_rows(out_sh, sample_ids)
    if nparts != shards:
        raise AssertionError(f"expected {shards} partitions, found {nparts}")
    compare(f"sharded-merge ({shards} partitions)", got_sh, want_thr)

    result = {
        "samples": n, "sites": s, "panel": panel,
        "pairs_compared_bit_exact": int(len(want_all)),
        "nonfinite_pairs_excluded": nonfinite,
        "thresholded_pairs": int(len(want_thr)),
        "shards": shards,
        "elapsed_s": round(time.time() - t0, 1),
        "ok": True,
    }
    print(json.dumps(result))
    if not args.keep:
        shutil.rmtree(wd, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
