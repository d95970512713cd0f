#!/usr/bin/env python3
"""Generates the committed golden parity fixture (tests/golden/).

The reference's acceptance criterion is kinship parity with Hail's
``hl.king`` (README.md:3).  Hail cannot run in this environment, so the
expected values are produced by an INDEPENDENT scalar implementation of the
published estimator — Hail's "between-family" KING kinship
(https://hail.is/docs/0.2/methods/relatedness.html#hail.methods.king), which
is also exactly the reference kernel's fp32 expression (cuking.cu:286-307):

    kin  = 0.5 + (2*N_bothHet - 4*N_opposingHom - N_het_i - N_het_j)
                 / (4 * min(N_het_i, N_het_j))          [all fp32 ops]
    ibs0 = N_opposingHom
    ibs2 = N_concordantHom + N_bothHet
    ibs1 = N_sharedSites - ibs0 - ibs2

counted over sites where BOTH samples are defined.  This script shares NO
code with cuking_tpu's compute path: per-pair Python loops over a dense
genotype matrix, numpy fp32 scalar arithmetic (one IEEE rounding per op,
like the CUDA and JAX kernels).  Kin values are stored as uint32 bit patterns so
the comparison is bit-exact, inf/NaN included.

Provenance / regeneration against real Hail: run
``tools/make_golden.py --verify-hail`` on a machine with Hail installed — it
builds the same MatrixTable, runs ``hl.king``, and asserts equality before
writing.  The committed fixture was generated without that flag (no Hail
here); the scalar implementation below is the hermetic stand-in.

Run from the repo root: ``python tools/make_golden.py``.
"""

import json
import struct
import sys

import numpy as np

sys.path.insert(0, ".")

GOLDEN_DIR = "tests/golden"
NUM_SAMPLES = 24
NUM_SITES = 100
KIN_THRESHOLD = 0.0884  # the reference default (cuking.cu:43-45)


def make_genotypes() -> np.ndarray:
    """[N, S] int8 in {-1 (missing), 0, 1, 2} with crafted edge cases."""
    rng = np.random.default_rng(20260816)
    g = rng.integers(0, 3, (NUM_SAMPLES, NUM_SITES), dtype=np.int8)
    miss = rng.random((NUM_SAMPLES, NUM_SITES)) < 0.08
    g[miss] = -1
    # Edge cases the parity contract must pin:
    g[1] = g[0]                      # identical pair -> kin 0.5
    g[2] = g[0]
    g[2, ::7] = -1                   # identical modulo missingness
    # Heavy opposing homs vs sample 0 (missing stays missing: g in {-1,0,1,2}).
    g[3] = np.where(g[0] < 0, -1, np.where(g[0] == 1, 1, 2 - g[0]))
    g[4] = -1                        # fully missing sample: 0 shared sites
    g[5] = np.where(g[5] == 1, 0, g[5])      # zero hets -> min_hets=0 (inf/nan)
    g[6] = 0                         # all hom-ref, zero hets
    g[7] = 2                         # all hom-alt, zero hets
    return g


def scalar_king(gi: np.ndarray, gj: np.ndarray):
    """Independent per-pair scalar computation (no cuking_tpu imports)."""
    bh = hi = hj = oh = ch = ss = 0
    for a, b in zip(gi.tolist(), gj.tolist()):
        if a < 0 or b < 0:
            continue
        ss += 1
        het_a, het_b = a == 1, b == 1
        bh += het_a and het_b
        hi += het_a
        hj += het_b
        oh += (a == 0 and b == 2) or (a == 2 and b == 0)
        ch += (a == 0 and b == 0) or (a == 2 and b == 2)
    f = np.float32
    with np.errstate(divide="ignore", invalid="ignore"):
        numer = f(f(f(f(2.0) * f(bh)) - f(f(4.0) * f(oh))) - f(hi)) - f(hj)
        kin = f(f(0.5) + f(numer / f(f(4.0) * f(min(hi, hj)))))
    return kin, oh, ss - oh - (ch + bh), ch + bh


def expected_rows(g: np.ndarray, threshold: float):
    rows = []
    for i in range(g.shape[0]):
        for j in range(i + 1, g.shape[0]):
            kin, ibs0, ibs1, ibs2 = scalar_king(g[i], g[j])
            if kin > np.float32(threshold):  # strict >, NaN fails
                rows.append(
                    {
                        "i": f"S{i:06d}",
                        "j": f"S{j:06d}",
                        "kin_bits": struct.unpack("<I", struct.pack("<f", kin))[0],
                        "ibs0": int(ibs0),
                        "ibs1": int(ibs1),
                        "ibs2": int(ibs2),
                    }
                )
    return rows


def verify_against_hail(g: np.ndarray) -> None:
    """Optional: assert the scalar implementation equals real hl.king."""
    import hail as hl

    mt = hl.MatrixTable.from_parts(
        rows={"row_idx": list(range(g.shape[1]))},
        cols={"col_idx": list(range(g.shape[0]))},
        entries={"GT": [[hl.call(0, 0) if v == 0 else
                         hl.call(0, 1) if v == 1 else
                         hl.call(1, 1) if v == 2 else hl.missing(hl.tcall)
                         for v in g[:, s]] for s in range(g.shape[1])]},
    )
    king = hl.king(mt.GT).entries().collect()
    phi = {}
    for e in king:
        phi[(e.col_idx, e.col_idx_2)] = np.float32(e.phi)
    for i in range(g.shape[0]):
        for j in range(i + 1, g.shape[0]):
            kin, *_ = scalar_king(g[i], g[j])
            hk = phi[(i, j)]
            assert (np.isnan(kin) and np.isnan(hk)) or kin == hk, (i, j, kin, hk)
    print("hl.king parity verified for all pairs")


def main() -> int:
    import os

    from cuking_tpu.io.synthetic_input import write_synthetic_input
    from cuking_tpu.io.uri import Storage

    g = make_genotypes()
    if "--verify-hail" in sys.argv:
        verify_against_hail(g)

    input_uri = os.path.join(GOLDEN_DIR, "input.parquet")
    os.makedirs(input_uri, exist_ok=True)
    write_synthetic_input(
        Storage(), input_uri, g, num_partitions=3, shuffle_seed=5
    )
    expected = {
        "provenance": (
            "tools/make_golden.py: independent scalar fp32 implementation of "
            "Hail's between-family KING estimator (= cuking.cu:286-307); "
            "regenerate/verify vs real hl.king with --verify-hail on Dataproc"
        ),
        "num_samples": NUM_SAMPLES,
        "num_sites": NUM_SITES,
        "kin_threshold": KIN_THRESHOLD,
        "rows_default_threshold": expected_rows(g, KIN_THRESHOLD),
        "rows_keep_all": expected_rows(g, -2.0),
    }
    with open(os.path.join(GOLDEN_DIR, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1)
    # The dense matrix itself, for fixture debuggability.
    np.save(os.path.join(GOLDEN_DIR, "genotypes.npy"), g)
    print(
        f"wrote {GOLDEN_DIR}: {len(expected['rows_default_threshold'])} rows "
        f"@ {KIN_THRESHOLD}, {len(expected['rows_keep_all'])} rows @ -2.0"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
