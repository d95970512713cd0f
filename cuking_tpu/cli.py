"""cuking_tpu CLI — the end-to-end pipeline (reference: cuking.cu:435-895).

Same eight flags as the reference binary (cuking.cu:27-52), same validation,
same stage structure: read metadata → build shard Submatrix → allocate planes
→ list+ingest Parquet in parallel → all-pairs KING (here: a jitted panel
sweep instead of one CUDA kernel launch) → overflow check → sort →
write one Snappy Parquet partition per shard.

Usage::

    python -m cuking_tpu.cli --input_uri gs://bucket/in.parquet \
        --output_uri gs://bucket/out.parquet --kin_threshold 0.0884 \
        --split_factor 4 --shard_index 3
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from cuking_tpu.io.metadata import read_metadata
from cuking_tpu.io.parquet_ingest import ingest_parquet
from cuking_tpu.io.uri import Storage
from cuking_tpu.io.writer import write_results
from cuking_tpu.models.king import (
    DEFAULT_KIN_THRESHOLD,
    DEFAULT_MAX_RESULTS,
    KingConfig,
    KingEngine,
    PanelStorage,
)
from cuking_tpu.ops.bitset import PlaneLayout
from cuking_tpu.parallel.submatrix import Submatrix, num_shards
from cuking_tpu.utils.status import (
    CukingError,
    FailedPreconditionError,
    InvalidArgumentError,
)
from cuking_tpu.utils.stopwatch import StageLogger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cuking_tpu",
        description="KING relatedness over cuKING-format Parquet inputs.",
    )
    p.add_argument("--input_uri", default="", help=(
        "Directory (local or gs://) containing the packed Parquet tables "
        "and metadata.json"))
    p.add_argument("--output_uri", default="", help=(
        "Directory (local or gs://) to write the Parquet result partition to"))
    p.add_argument("--requester_pays_project", default="", help=(
        "User project for accessing Requester Pays buckets on GCS"))
    p.add_argument("--num_reader_threads", type=int, default=36, help=(
        "Threads for parallel Parquet ingest"))
    p.add_argument("--max_results", type=int, default=DEFAULT_MAX_RESULTS, help=(
        "Capacity of the related-pair result buffer; exceeding it is an error"))
    p.add_argument("--kin_threshold", type=float, default=DEFAULT_KIN_THRESHOLD,
                   help=("Only store kinship coefficients strictly larger than "
                         "this threshold (default: 2nd degree or closer)"))
    p.add_argument("--split_factor", type=int, default=1, help=(
        "Split the relatedness matrix into k x k submatrices for sharding"))
    p.add_argument("--shard_index", type=int, default=0, help=(
        "Shard index in [0, split_factor*(split_factor+1)/2)"))
    # Extensions (no reference counterpart):
    p.add_argument("--kernel", default="auto",
                   choices=["auto", "popcount", "matmul"],
                   help="Count-kernel implementation")
    p.add_argument("--panel", type=int, default=1024,
                   help="Samples per panel (pair-tile edge) in the jitted sweep")
    p.add_argument("--use_mesh", action="store_true", help=(
        "Run this shard data-parallel over all local JAX devices via the "
        "shard_map ring exchange (composes with --split_factor for cohorts "
        "larger than the devices' memory; replaces the reference's "
        "share-nothing multi-GPU fan-out)"))
    p.add_argument("--distributed", action="store_true", help=(
        "Multi-process run: jax.distributed.initialize() (coordinator from "
        "JAX_COORDINATOR_ADDRESS), mesh over ALL devices of all processes; "
        "each process ingests only its devices' sample row blocks and writes "
        "its own disjoint output partition (implies --use_mesh; composes "
        "with --split_factor — partitions are then keyed by shard x process)"))
    p.add_argument("--allow_single_process", action="store_true", help=(
        "With --distributed: proceed single-process when the distributed "
        "runtime fails to initialize even though a coordinator is "
        "configured (normally a fatal error: degraded processes would "
        "each compute a partial mesh and race on part-00000)"))
    p.add_argument("--capacity_per_device", type=int, default=0, help=(
        "Per-device hit-buffer slots for the mesh ring sweep (0 = auto: "
        "2x the even share of --max_results). Row-skewed hit distributions "
        "auto-retry at a pow2-bucketed capacity, so this is only a memory "
        "knob"))
    p.add_argument("--result_capacity", type=int, default=0, help=(
        "Device result-buffer slots for the single-chip engine sweep "
        "(0 = auto: min(max_results, 2^20)). A sweep whose hit count "
        "exceeds it re-runs once at the next pow2 bucket; pipelines that "
        "know their hit count can pre-size the buffer here to avoid the "
        "second sweep"))
    p.add_argument("--skip_existing", action="store_true", help=(
        "Exit successfully without recomputing when this shard's output "
        "partition already exists (idempotent fan-out restarts)"))
    p.add_argument("--profile_dir", default="", help=(
        "If set, capture a jax.profiler trace of the sweep into this "
        "directory (view with TensorBoard / xprof)"))
    p.add_argument("--quiet", action="store_true", help="Suppress stage logs")
    return p


def _run_mesh_sweep(args, panel_storage, metadata, config, logger):
    """Multi-chip path: sample-sharded planes, ppermute ring over the mesh
    (cuking_tpu.parallel.ring) instead of the single-chip panel sweep.

    With --distributed the mesh spans every device of every process and each
    host extracts only its own devices' result buffers (share-nothing
    outputs, like the reference's independent shards, README.md:102)."""
    from cuking_tpu.models.king import _resolve_kernel
    from cuking_tpu.parallel.distributed import HostShardedStorage
    from cuking_tpu.parallel.ring import (
        all_pairs_presharded,
        default_capacity_per_device,
        ring_output_local_resultset,
        ring_output_to_resultset,
        submatrix_pairs_sharded,
    )

    mesh = _make_mesh()
    logger.print(
        f"Using a {mesh.devices.size}-device mesh for the ring sweep."
    )
    capacity = args.capacity_per_device or default_capacity_per_device(
        args.max_results, mesh.devices.size
    )
    if isinstance(panel_storage, HostShardedStorage):
        # Host-sharded path: assemble the global array(s) from this host's
        # per-device blocks (no host holds the whole cohort, and with
        # --split_factor no host even holds its full share of the cohort —
        # only this shard's ranges).
        from cuking_tpu.parallel.ring import rect_pairs_presharded

        arrays = panel_storage.to_global_arrays()
        if len(arrays) == 1:
            begin, length = panel_storage.ranges[0]
            out = all_pairs_presharded(
                arrays[0],
                length,
                mesh,
                _resolve_kernel(config),
                kin_threshold=args.kin_threshold,
                capacity_per_device=capacity,
                max_results=args.max_results,
                sub_panel=config.panel,
                row_offset=begin,
            )
        else:
            (i_begin, i_count), (j_begin, j_count) = panel_storage.ranges
            out = rect_pairs_presharded(
                arrays[0], arrays[1], i_count, j_count, mesh,
                _resolve_kernel(config),
                i_offset=i_begin,
                j_offset=j_begin,
                kin_threshold=args.kin_threshold,
                capacity_per_device=capacity,
                max_results=args.max_results,
                sub_panel=config.panel,
            )
    else:
        # Ring sweep of THIS shard (any --split_factor): a diagonal shard
        # runs the triangular ring at its global row offset, an
        # off-diagonal shard the rectangular j-rotating ring.
        out = submatrix_pairs_sharded(
            panel_storage,
            mesh,
            _resolve_kernel(config),
            kin_threshold=args.kin_threshold,
            capacity_per_device=capacity,
            max_results=args.max_results,
            sub_panel=config.panel,
        )
    if args.distributed:
        return ring_output_local_resultset(out, args.max_results)
    return ring_output_to_resultset(out, args.max_results)


def _multihost_context_reason() -> str | None:
    """A human-readable reason the current environment names a distributed
    coordinator (so this is meant to be a multi-process run), or None for a
    plain local run."""
    for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"):
        if os.environ.get(k):
            return f"{k} is set"
    return None


def _make_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), axis_names=("samples",))


def run(args: argparse.Namespace) -> None:
    # Flag validation, mirroring cuking.cu:436-465.
    if not args.input_uri:
        raise InvalidArgumentError("No input URI specified")
    if not args.output_uri:
        raise InvalidArgumentError("No output URI specified")
    if args.num_reader_threads <= 0:
        raise InvalidArgumentError("Invalid number of reader threads")
    if args.split_factor <= 0:
        raise InvalidArgumentError("Invalid split factor")
    if args.shard_index >= num_shards(args.split_factor) or args.shard_index < 0:
        raise InvalidArgumentError("Invalid shard index")
    if args.distributed:
        args.use_mesh = True

    logger = StageLogger(enabled=not args.quiet)
    storage = Storage(requester_pays_project=args.requester_pays_project)

    shard_index = args.shard_index
    if args.distributed:
        import jax

        try:
            # Embedders may have initialized the runtime themselves (e.g.
            # explicit coordinator/process args); respect that.
            if not jax.distributed.is_initialized():
                jax.distributed.initialize()
        except Exception:
            # A multi-process run whose coordinator fails to come up must
            # be fatal: silently continuing would give every process
            # process_index()==0, a local-only mesh, a full-cohort bitset per
            # host (defeating the sharded memory model), and races on
            # part-00000.  Only proceed single-process when nothing in the
            # environment names a coordinator (local dev).
            reason = _multihost_context_reason()
            if reason and not args.allow_single_process:
                raise FailedPreconditionError(
                    "jax.distributed.initialize() failed in what looks like "
                    f"a multi-process run ({reason}); refusing to degrade to "
                    "a single-process mesh. Re-run the task, or pass "
                    "--allow_single_process to override."
                )
            logger.print(
                "No distributed coordinator available; running single-process."
            )
        # Each host owns one disjoint output partition.  With
        # --split_factor the partition index combines (shard, host) so every
        # (shard × host) pair writes a unique part file and the merged
        # output keeps the reference's trivially-mergeable property
        # (README.md:102).
        shard_index = (
            args.shard_index * jax.process_count() + jax.process_index()
        )
        logger.print(
            f"Initialized distributed runtime: host {jax.process_index()} "
            f"of {jax.process_count()}, {jax.device_count()} devices total."
        )

    if args.skip_existing:
        from cuking_tpu.io.writer import partition_is_valid, partition_name

        part_uri = storage.join(args.output_uri, partition_name(shard_index))
        # Existence alone is not enough: a crashed writer (or a non-atomic
        # store) can leave a truncated partition, and skipping it would
        # silently drop this shard's pairs.  Only a partition whose Parquet
        # footer parses counts as done; anything else is recomputed, which is
        # safe because partition writes are idempotent (README.md:102).
        mine_exists = partition_is_valid(storage, part_uri)
        if args.distributed:
            # The skip decision must be COLLECTIVE: the ring sweep spans
            # every device of every process, so a host that returns early
            # while others enter the shard_map would deadlock the
            # collective.  Skip only
            # when every host's partition exists; otherwise all hosts
            # recompute (idempotent per-partition rewrites, README.md:102).
            import jax
            from jax.experimental import multihost_utils

            all_exist = multihost_utils.process_allgather(
                np.asarray([mine_exists])
            ).all()
            if all_exist:
                logger.print("All output partitions exist; skipping.")
                return
        elif mine_exists:
            logger.print(f"Output {part_uri} already exists; skipping.")
            return

    logger.begin("Reading metadata...")
    metadata = read_metadata(storage, args.input_uri)
    logger.end("metadata")

    submatrix = Submatrix.create(
        metadata.num_samples, args.split_factor, args.shard_index
    )
    # Small cohorts don't need the full default panel: shrink to the
    # smallest power of two covering the shard (≥128) so padding work
    # doesn't dominate.
    from cuking_tpu.models.king import _ceil_pow2

    shard_n = max(submatrix.num_rows, submatrix.num_cols, 1)
    panel = min(args.panel, max(128, _ceil_pow2(shard_n)))
    config = KingConfig(
        kin_threshold=args.kin_threshold,
        max_results=args.max_results,
        panel=panel,
        kernel=args.kernel,
        result_capacity=args.result_capacity,
        verbose=not args.quiet,
    )

    layout = PlaneLayout.create(metadata.num_sites)
    # Capacity model (VERDICT r1 #2): fail up front with the minimal
    # --split_factor that fits instead of an opaque XLA OOM mid-upload —
    # the posture of the reference's allocation-aware logging + README's
    # split_factor memory-relief prescription (cuking.cu:513-517).
    from cuking_tpu.utils.hbm import check_engine_fit, check_ring_fit

    if args.use_mesh:
        import jax as _jax

        from cuking_tpu.parallel.ring import default_capacity_per_device

        n_dev = len(_jax.devices())
        capacity = args.capacity_per_device or default_capacity_per_device(
            args.max_results, n_dev
        )
        # Per-shard model; on overflow the error names the minimal
        # --split_factor that fits (it composes with --use_mesh AND
        # --distributed).  HostShardedStorage pads rows only to a device
        # multiple (panel=1); PanelStorage pads to a panel multiple first.
        check_ring_fit(
            metadata.num_samples, layout.words, 0, capacity, n_dev,
            submatrix=submatrix,
            panel=1 if args.distributed else panel,
            split_factor=args.split_factor,
            max_results=args.max_results,
        )
    else:
        check_engine_fit(
            metadata.num_samples, layout.words, submatrix, config,
            args.split_factor,
        )

    if args.distributed:
        # Host-sharded storage: this host materializes only the sample
        # row-blocks its local devices own (no full-cohort bitset per host).
        from cuking_tpu.parallel.distributed import HostShardedStorage

        panel_storage = HostShardedStorage(
            layout, metadata.num_samples, _make_mesh(),
            submatrix=submatrix,
        )
    else:
        panel_storage = PanelStorage(layout, submatrix, config.panel)
    mib = panel_storage.planes.nbytes >> 20
    logger.print(f"Allocated {mib} MiB of memory for bit planes.")

    logger.begin("Listing input files...")
    input_files = storage.list_parquet_files(args.input_uri)
    logger.end("listing")
    if not input_files:
        raise FailedPreconditionError("No input files found")
    logger.print(f"Found {len(input_files)} input files.")

    logger.begin("Processing Parquet tables...")
    ingest_parquet(
        storage,
        input_files,
        panel_storage,
        num_reader_threads=args.num_reader_threads,
        logger=logger,
    )
    logger.end("ingest")

    import contextlib

    profiling = contextlib.nullcontext()
    if args.profile_dir:
        import jax.profiler

        profiling = jax.profiler.trace(args.profile_dir)

    with profiling:
        if args.use_mesh:
            logger.begin("Running mesh ring sweep...")
            results = _run_mesh_sweep(args, panel_storage, metadata, config, logger)
            logger.end("king_kernel")
        else:
            engine = KingEngine(panel_storage, config, logger=logger)
            results = engine.run()

    logger.begin(f"Writing {len(results)} results...")
    uri = write_results(
        storage, args.output_uri, results, metadata.samples, shard_index
    )
    logger.end("write")
    logger.print(f"Wrote {uri}.")


def main(argv: list[str] | None = None) -> int:
    # Parse first: --help and bad-flag exits must not pay the jax import.
    args = build_parser().parse_args(argv)
    from cuking_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    try:
        run(args)
    except CukingError as e:
        print(f"\nError: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
