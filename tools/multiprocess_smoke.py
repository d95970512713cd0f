#!/usr/bin/env python3
"""True multi-process smoke for the --distributed path.

Round 1 validated the multi-host code only in a single process ("all devices
local").  This launches N OS processes, each owning M virtual CPU devices,
connected through jax.distributed over localhost — the real coordinator
handshake, the real cross-process collectives (ppermute ring, allgather for
skip/overflow decisions), real host-sharded ingest (each process packs only
its devices' row blocks), and one output partition per process — then merges
the partitions and checks them bit-exactly against the numpy oracle.

Scenarios (VERDICT r2 #6 — the paths that differ by topology):

* default: 2 processes x 4 devices (even D=8: exercises the wrap step)
* ``--num-processes 3 --devices-per-process 3`` (odd D=9: no wrap step)
* ``--skew``: one identical family inside a single device's row block plus
  a tiny ``--capacity-per-device``, forcing the cross-process overflow
  auto-retry (parallel/ring._run_with_retry).  Every process must reach
  the SAME retry decision from the all-gathered counts — divergence would
  desynchronize the collective program order and fail the run — and the
  merged output must still be bit-exact.
* ``--split-factor k``: the --distributed × --split_factor composition —
  all k(k+1)/2 shards swept through the same cross-process mesh, each
  shard's ranges host-sharded, one partition per (shard, host).

Usage (from the repo root): ``python tools/multiprocess_smoke.py [flags]``
The parent re-execs itself with ``--worker <pid>`` for each process.
"""

import argparse
import json
import os
import struct
import subprocess
import sys
import tempfile

sys.path.insert(0, ".")

NUM_SAMPLES, NUM_SITES = 54, 400
THRESHOLD = 0.05


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker(args) -> int:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.devices_per_process}"
    ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
    # Explicit initialization, like an embedder or a multi-host launcher
    # would do; cli.py --distributed detects the already-initialized
    # runtime.
    jax.distributed.initialize(
        coordinator_address=f"localhost:{args.port}",
        num_processes=args.num_processes,
        process_id=args.worker,
    )

    from cuking_tpu import cli
    from cuking_tpu.parallel.submatrix import num_shards

    rc = 0
    # With --split-factor, every process sweeps EVERY shard (the distributed
    # mesh spans all processes, so all must participate in each shard's
    # collective — a host that stopped after a failed shard would hang its
    # peers in the next shard's collectives); each (shard, host) pair
    # writes its own partition.
    for shard in range(num_shards(args.split_factor)):
        cli_args = [
            "--input_uri", os.path.join(args.workdir, "in.parquet"),
            "--output_uri", os.path.join(args.workdir, "out.parquet"),
            "--kin_threshold", str(THRESHOLD),
            "--kernel", "matmul", "--panel", "8",
            "--split_factor", str(args.split_factor),
            "--shard_index", str(shard),
            "--distributed", "--quiet",
        ]
        if args.capacity_per_device:
            cli_args += [
                "--capacity_per_device", str(args.capacity_per_device)
            ]
        rc = max(rc, cli.main(cli_args))
    assert jax.process_count() == args.num_processes, jax.process_count()
    assert jax.device_count() == args.num_processes * args.devices_per_process
    return rc


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--devices-per-process", type=int, default=4)
    p.add_argument("--skew", action="store_true", help=(
        "clone one family into a single device's row block so its hit "
        "buffer overflows and the cross-process auto-retry fires"))
    p.add_argument("--capacity-per-device", type=int, default=0)
    p.add_argument("--split-factor", type=int, default=1, help=(
        "run all k(k+1)/2 shards of a split-k cohort through the same "
        "distributed mesh (each shard host-sharded via HostShardedStorage; "
        "one partition per shard x host)"))
    # internal (worker re-exec):
    p.add_argument("--worker", type=int, default=None)
    p.add_argument("--workdir", default="")
    p.add_argument("--port", type=int, default=0)
    return p


def main() -> int:
    args = build_parser().parse_args()
    if args.worker is not None:
        return worker(args)

    import numpy as np

    from cuking_tpu.io.synthetic_input import write_synthetic_input
    from cuking_tpu.io.uri import Storage
    from cuking_tpu.utils.synthetic import random_genotypes

    workdir = tempfile.mkdtemp(prefix="cuking_mp_")
    g = random_genotypes(
        NUM_SAMPLES, NUM_SITES, missing_rate=0.1, seed=61, num_related_pairs=4
    )
    if args.skew:
        # One identical 8-sample family inside device 0's row block: 28
        # kin=0.5 pairs, far beyond the tiny per-device capacity below, so
        # the run must take the allgathered-counts retry on every process.
        g[:8] = g[0]
        if not args.capacity_per_device:
            args.capacity_per_device = 8
    storage = Storage()
    os.makedirs(os.path.join(workdir, "in.parquet"))
    write_synthetic_input(storage, os.path.join(workdir, "in.parquet"), g)
    np.save(os.path.join(workdir, "genotypes.npy"), g)

    port = _free_port()  # ephemeral: concurrent runs must not collide
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--worker", str(i),
             "--workdir", workdir, "--port", str(port),
             "--num-processes", str(args.num_processes),
             "--devices-per-process", str(args.devices_per_process),
             "--split-factor", str(args.split_factor)]
            + (["--capacity-per-device", str(args.capacity_per_device)]
               if args.capacity_per_device else []),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(args.num_processes)
    ]
    outputs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for i, (p, out) in enumerate(zip(procs, outputs)):
        if p.returncode != 0:
            print(f"--- worker {i} failed (rc={p.returncode}) ---\n{out}")
            return 1

    # Merge the disjoint partitions and compare with the oracle.
    from cuking_tpu.io.writer import read_results_table
    from cuking_tpu.ops.oracle import oracle_king

    table = read_results_table(storage, os.path.join(workdir, "out.parquet"))
    kin, ibs0, ibs1, ibs2 = oracle_king(g, g)
    iu, ju = np.triu_indices(NUM_SAMPLES, k=1)
    with np.errstate(invalid="ignore"):
        keep = kin[iu, ju] > np.float32(THRESHOLD)
    exp = sorted(
        (f"S{i:06d}", f"S{j:06d}",
         struct.unpack("<I", struct.pack("<f", np.float32(kin[i, j])))[0])
        for i, j in zip(iu[keep], ju[keep])
    )
    got = sorted(
        (table.column("i")[k].as_py(), table.column("j")[k].as_py(),
         struct.unpack(
             "<I", struct.pack("<f", np.float32(table.column("kin")[k].as_py()))
         )[0])
        for k in range(table.num_rows)
    )
    assert got == exp, (len(got), len(exp))
    if args.skew:
        assert len(got) >= 28 + args.capacity_per_device, len(got)
    parts = sorted(
        f for f in os.listdir(os.path.join(workdir, "out.parquet"))
        if f.endswith(".parquet")
    )
    from cuking_tpu.parallel.submatrix import num_shards
    # one partition per shard x host
    assert len(parts) == args.num_processes * num_shards(args.split_factor), parts
    print(json.dumps({
        "multiprocess_smoke": "ok",
        "processes": args.num_processes,
        "devices": args.num_processes * args.devices_per_process,
        "skew": bool(args.skew),
        "split_factor": args.split_factor,
        "pairs": len(got),
        "partitions": parts,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
