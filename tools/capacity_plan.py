#!/usr/bin/env python3
"""Multi-GPU capacity plan for a gnomAD-scale all-pairs KING run.

BASELINE.json config 5 is "gnomAD-exomes-scale table (100k+ samples)
data-parallel across" many accelerators.  This tool makes such a plan
*checkable*: it drives the same device-memory capacity model the CLI
enforces at runtime (cuking_tpu/utils/hbm.py — the analogue of the
reference's 40 GB A100 envelope + --split_factor relief, cuking.cu:513-517,
README.md:94-102) across all devices, picks the minimal split factor whose
worst shard fits every device, and projects wall-clock from the device's
published int8 peak times the engine's measured share of it (PERF.md).

    python tools/capacity_plan.py --samples 150000 --sites 1000000 \
        --device-kind "NVIDIA H100 80GB HBM3" --devices 64

Prints a human-readable plan and one final JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

sys.path.insert(0, ".")

from cuking_tpu.ops.bitset import PlaneLayout
from cuking_tpu.parallel.ring import default_capacity_per_device
from cuking_tpu.parallel.submatrix import num_shards
from cuking_tpu.utils.hbm import _USABLE_FRACTION, _worst_ring_shard_bytes

# Devices keyed by JAX's ``device_kind``.  Dense int8 peak and memory from
# NVIDIA's H100 data sheet (SXM: 1,979 int8 TOP/s, 80 GB HBM3).  A device
# that is not here is an error, not a default.
DEVICES = {
    "NVIDIA H100 80GB HBM3": {"int8_tops": 1979e12, "hbm_bytes": 80 * 10**9},
}
# The engine sweep's share of that peak, end to end: 246.0 M pairs/s at
# 100k sites (100,352 padded) × 18 int8 ops per pair per site = 4.44e14
# op/s, 0.2245 of 1,979 TOP/s (32,768-sample sweep, median of 3, H100 80GB
# HBM3 at a 700 W limit; PERF.md).
MEASURED_PEAK_SHARE = 0.2245
OPS_PER_SITE_PAIR = 18      # the stacked 3×3 indicator Gram, king_mm.py
SCALING_EFFICIENCY = 0.85   # BASELINE.md multi-device target


def device_spec(kind: str) -> dict:
    if kind not in DEVICES:
        raise ValueError(
            f"unknown device kind {kind!r}; known: {sorted(DEVICES)}"
        )
    return DEVICES[kind]


def padded_words(num_sites: int) -> int:
    """The engine's actual padded word count (PlaneLayout default layout),
    not a re-derivation — so plan sizes track what will really allocate."""
    return PlaneLayout.create(num_sites).words


def pairs_per_sec_per_chip(kind: str, num_sites: int) -> float:
    """Peak int8 rate times the measured end-to-end share of it, at 18 ops
    per (padded) site per pair."""
    sites_padded = padded_words(num_sites) * 32
    return (
        device_spec(kind)["int8_tops"] * MEASURED_PEAK_SHARE
        / (OPS_PER_SITE_PAIR * sites_padded)
    )


def minimal_split_factor(
    num_samples: int,
    words: int,
    num_devices: int,
    bytes_limit: int,
    *,
    panel: int = 1024,
    max_results: int = 10 << 20,
) -> int | None:
    """Smallest --split_factor whose WORST shard's ring sweep fits on every
    device (the same worst-shard model check_ring_fit prescribes from).
    None when even maximal splitting cannot fit."""
    capacity = default_capacity_per_device(max_results, num_devices)

    def worst(k: int) -> int:
        return _worst_ring_shard_bytes(
            num_samples, k, words, panel, num_devices, capacity, max_results,
        )

    if worst(1) <= bytes_limit:
        return 1
    if worst(num_samples) > bytes_limit:
        return None
    lo, hi = 1, num_samples
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if worst(mid) > bytes_limit:
            lo = mid
        else:
            hi = mid
    return hi


def build_plan(
    num_samples: int,
    num_sites: int,
    kind: str,
    num_devices: int,
    *,
    panel: int = 1024,
    max_results: int = 10 << 20,
) -> dict:
    words = padded_words(num_sites)
    limit = int(device_spec(kind)["hbm_bytes"] * _USABLE_FRACTION)
    k = minimal_split_factor(
        num_samples, words, num_devices, limit,
        panel=panel, max_results=max_results,
    )
    plan: dict = {
        "samples": num_samples,
        "sites": num_sites,
        "device_kind": kind,
        "devices": num_devices,
        "words_per_plane": words,
        "total_plane_gib": round(2 * num_samples * words * 4 / 2**30, 2),
        "split_factor": k,
    }
    if k is None:
        plan["fits"] = False
        return plan

    capacity = default_capacity_per_device(max_results, num_devices)
    worst_b = _worst_ring_shard_bytes(
        num_samples, k, words, panel, num_devices, capacity, max_results,
    )
    rate_chip = pairs_per_sec_per_chip(kind, num_sites)
    rate_slice = rate_chip * num_devices * SCALING_EFFICIENCY
    total_pairs = num_samples * (num_samples - 1) // 2
    plan.update(
        fits=True,
        num_shards=num_shards(k),
        worst_shard_gib_per_chip=round(worst_b / 2**30, 2),
        chip_hbm_usable_gib=round(limit / 2**30, 2),
        pairs_total=total_pairs,
        pairs_per_sec_per_chip=round(rate_chip),
        pairs_per_sec_slice=round(rate_slice),
        est_compute_seconds=round(total_pairs / rate_slice, 1),
        assumptions={
            "measured_peak_share": MEASURED_PEAK_SHARE,
            "scaling_efficiency_target": SCALING_EFFICIENCY,
            "ops_per_site_pair": OPS_PER_SITE_PAIR,
        },
    )
    return plan


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=150_000,
                    help="cohort size (config 5 says 100k+)")
    ap.add_argument("--sites", type=int, default=1_000_000,
                    help="QC sites (gnomAD-scale ~1M)")
    ap.add_argument("--device-kind", choices=sorted(DEVICES),
                    default="NVIDIA H100 80GB HBM3",
                    help="JAX device_kind of every device")
    ap.add_argument("--devices", type=int, default=64,
                    help="devices in the mesh (e.g. 8 hosts x 8 GPUs)")
    ap.add_argument("--max-results", type=int, default=10 << 20)
    args = ap.parse_args(argv)

    plan = build_plan(
        args.samples, args.sites, args.device_kind, args.devices,
        max_results=args.max_results,
    )
    if not plan["fits"]:
        print(
            f"{args.samples} samples x {args.sites} sites does NOT fit "
            f"{args.devices} x {args.device_kind} at any split factor; use "
            "more devices or larger ones.",
            file=sys.stderr,
        )
        print(json.dumps(plan))
        return 1

    print(
        f"Plan: {args.samples:,} samples x {args.sites:,} sites on "
        f"{args.devices} x {args.device_kind}\n"
        f"  bit planes total: {plan['total_plane_gib']} GiB "
        f"({plan['words_per_plane']} u32 words/plane/sample)\n"
        f"  split_factor {plan['split_factor']} -> "
        f"{plan['num_shards']} shard(s); worst shard "
        f"{plan['worst_shard_gib_per_chip']} GiB/device of "
        f"{plan['chip_hbm_usable_gib']} GiB usable\n"
        f"  {plan['pairs_total']:,} pairs at "
        f"~{plan['pairs_per_sec_slice']:,} pairs/s in all "
        f"({plan['pairs_per_sec_per_chip']:,}/device x {args.devices} x "
        f"{SCALING_EFFICIENCY} scaling)\n"
        f"  estimated kernel wall-clock: {plan['est_compute_seconds']} s "
        "(+ ingest/output, I/O-bound)",
        file=sys.stderr,
    )
    print(json.dumps(plan))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
