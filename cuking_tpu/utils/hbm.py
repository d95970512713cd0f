"""HBM capacity model: fail before an opaque XLA OOM, with a fix in hand.

The reference sizes its allocations against a known 40 GB A100 envelope and
prescribes ``--split_factor`` as the memory-relief mechanism
(cuking.cu:513-517; README.md:96-98).  This engine's equivalent: compute
the device-resident footprint of a shard's sweep UP FRONT — bit planes plus
the bounded in-flight result buffers — compare it against the chip's HBM
limit, and when it doesn't fit, raise InvalidArgument naming the **minimal
split factor that does** instead of letting the whole-shard
``jnp.asarray`` upload die inside XLA.

The limit is queried from ``device.memory_stats()['bytes_limit']`` (GPUs
report it; CPU test devices don't — the check is skipped when the platform
can't say).  ``CUKING_HBM_BYTES_LIMIT`` overrides the query for tests and
for operators who want headroom for a colocated process.
"""

from __future__ import annotations

import os

from cuking_tpu.utils.status import InvalidArgumentError

# Fraction of the reported limit usable by the sweep's own arrays: XLA
# reserves program scratch, and the sweep needs transient epilogue buffers
# beyond what the static model counts.  On a GPU, ``bytes_limit`` is the
# pool the JAX client reserved at start-up (by default 75% of the card's
# memory, XLA_PYTHON_CLIENT_MEM_FRACTION), not the card's total, so this
# fraction applies to the reserved pool and leaves the other quarter of the
# card to the CUDA context, cuBLAS workspaces and other processes.  On an
# H100 the model's figure for a 32,768 × 100k sweep was above its measured
# ``peak_bytes_in_use`` (PERF.md), so the fraction still leaves headroom.
_USABLE_FRACTION = 0.92


def device_bytes_limit(device=None) -> int | None:
    """Usable HBM bytes of the target device, or None when unknowable.

    Env override ``CUKING_HBM_BYTES_LIMIT`` (raw bytes) wins when set."""
    env = os.environ.get("CUKING_HBM_BYTES_LIMIT")
    if env:
        try:
            return int(env)
        except ValueError:
            raise InvalidArgumentError(
                f"CUKING_HBM_BYTES_LIMIT must be a raw byte count, got {env!r}"
            )
    if device is None:
        import jax

        devices = jax.devices()
        if not devices:
            return None
        device = devices[0]
    try:
        stats = device.memory_stats()
    except Exception:
        return None
    if not stats or "bytes_limit" not in stats:
        return None
    return int(stats["bytes_limit"] * _USABLE_FRACTION)


def _ceil_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def plane_bytes(num_stored_rows: int, words: int, panel: int = 1) -> int:
    """Device bytes for the [2, rows, W] uint32 bit planes, rows padded to a
    panel multiple per range (PanelStorage layout)."""
    return 2 * _ceil_to(max(num_stored_rows, 1), panel) * words * 4


def shard_plane_bytes(
    num_samples: int, split_factor: int, words: int, panel: int
) -> int:
    """Worst-shard plane footprint at a given split factor: an off-diagonal
    shard stores row range + column range, each a full-size block padded to a
    panel multiple (cuking.cu:158-175, 507-517)."""
    block = -(-num_samples // split_factor)
    if split_factor == 1:
        return plane_bytes(num_samples, words, panel)
    return plane_bytes(block, words, panel) + plane_bytes(block, words, panel)


def sweep_buffer_bytes(config) -> int:
    """Device bytes for the engine sweep's result accumulation: ONE
    device-resident six-field hit buffer carried across all batches
    (models/king.py, donated in place — there are no per-batch buffers any
    more) plus the double-buffered per-step counter/epilogue transients.
    Sized at max_results — the worst capacity the pow2-bucketed overflow
    retry can grow the buffer to — so an up-front pass guarantees the retry
    fits too."""
    per_slot = 6 * 4  # i/j idx i32, kin f32, ibs0/1/2 i32
    worst_capacity = max(config.resolved_result_capacity(), config.max_results)
    result_buffer = worst_capacity * per_slot
    transients = 2 * 7 * config.panel * config.panel * 4
    return result_buffer + transients


def engine_plane_bytes(submatrix, words: int, panel: int) -> int:
    """Exact plane footprint of one shard's PanelStorage: the i-range and
    (off-diagonal) j-range are each padded to a panel multiple separately."""
    b = plane_bytes(submatrix.num_rows, words, panel)
    if not submatrix.is_diagonal:
        b += plane_bytes(submatrix.num_cols, words, panel)
    return b


def check_engine_fit(
    num_samples: int,
    words: int,
    submatrix,
    config,
    split_factor: int,
    bytes_limit: int | None = None,
) -> None:
    """Raises InvalidArgument naming the minimal --split_factor that fits
    when this shard's sweep footprint exceeds the device's HBM.

    No-op when the limit is unknowable (CPU test devices)."""
    limit = device_bytes_limit() if bytes_limit is None else bytes_limit
    if limit is None:
        return
    planes_b = engine_plane_bytes(submatrix, words, config.panel)
    buffers_b = sweep_buffer_bytes(config)
    need = planes_b + buffers_b
    if need <= limit:
        return

    def worst(k: int) -> int:
        return shard_plane_bytes(num_samples, k, words, config.panel) + buffers_b

    # Splitting shrinks only the plane term; the result-buffer term (sized
    # at the worst post-retry capacity) is k-independent.  If not even
    # maximal splitting fits, say so instead of prescribing a split factor
    # that cannot work (and don't walk k one-by-one up to num_samples).
    if worst(num_samples) > limit:
        raise InvalidArgumentError(
            f"Shard needs {need >> 20} MiB of device memory but only "
            f"{limit >> 20} MiB is available, and no --split_factor can "
            f"relieve it: the {buffers_b >> 20} MiB worst-case result "
            "buffers alone don't fit. Lower --max_results/"
            "--result_capacity, or use a device with more memory."
        )
    lo, hi = split_factor, num_samples  # worst(hi) <= limit
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if worst(mid) > limit:
            lo = mid
        else:
            hi = mid
    raise InvalidArgumentError(
        f"Shard needs {need >> 20} MiB of device memory "
        f"({planes_b >> 20} MiB bit planes + "
        f"{buffers_b >> 20} MiB sweep buffers) but only "
        f"{limit >> 20} MiB is available; increase --split_factor to at "
        f"least {hi}."
    )


def ring_rows_per_device(rows: int, panel: int, num_devices: int) -> int:
    """Per-device row count the ring will actually use for a range of
    ``rows`` samples: panel-padded storage rows (PanelStorage layout) split
    over the mesh — mirroring all_pairs_sharded/rect_pairs_sharded padding
    exactly."""
    padded = _ceil_to(max(rows, 1), panel)
    return -(-padded // num_devices)


def _ring_hits_bytes(capacity_per_device: int, max_results: int | None) -> int:
    """Worst-case hit-buffer bytes per device: the overflow auto-retry
    (parallel/ring._run_with_retry) can regrow the buffer to a pow2 bucket
    capped at the GLOBAL max_results, so the up-front check must budget
    that ceiling — otherwise a run that passes the check could still OOM
    on its retry (the exact failure the check exists to prevent; the
    engine model worst-cases the same way in sweep_buffer_bytes)."""
    worst = capacity_per_device
    if max_results is not None:
        worst = max(worst, max_results)
    return 6 * 4 * worst


def ring_shard_bytes(
    num_rows: int,
    num_cols: int,
    is_diagonal: bool,
    words: int,
    panel: int,
    num_devices: int,
    capacity_per_device: int,
    max_results: int | None = None,
) -> int:
    """Per-device HBM for one Submatrix shard's ring sweep: a diagonal
    shard holds 3 copies of its row panel (resident + visiting + in-flight
    ppermute); an off-diagonal shard holds its resident i-panel plus 2
    rotating j-panels; both add the six hit buffers at their worst
    (post-retry) capacity."""
    hits_b = _ring_hits_bytes(capacity_per_device, max_results)
    nd_i = ring_rows_per_device(num_rows, panel, num_devices)
    panel_i = 2 * nd_i * words * 4
    if is_diagonal:
        return 3 * panel_i + hits_b
    nd_j = ring_rows_per_device(num_cols, panel, num_devices)
    return panel_i + 2 * (2 * nd_j * words * 4) + hits_b


def _worst_ring_shard_bytes(
    num_samples: int, split_factor: int, words: int, panel: int,
    num_devices: int, capacity_per_device: int,
    max_results: int | None = None,
) -> int:
    """Worst shard at a given split factor: for k ≥ 2 an off-diagonal shard
    holding two full-size blocks (cuking.cu:158-175); for k = 1 the single
    diagonal shard."""
    block = -(-num_samples // split_factor)
    return ring_shard_bytes(
        block, block, split_factor == 1, words, panel,
        num_devices, capacity_per_device, max_results,
    )


def check_ring_fit(
    num_samples: int,
    words: int,
    rows_per_device: int,
    capacity_per_device: int,
    num_devices: int,
    bytes_limit: int | None = None,
    *,
    submatrix=None,
    panel: int = 1,
    split_factor: int = 1,
    max_results: int | None = None,
) -> None:
    """Mesh-path capacity check.  When this shard's ring footprint exceeds
    the device HBM, raises InvalidArgument naming the minimal
    ``--split_factor`` whose worst shard fits on this mesh — --use_mesh
    composes with --split_factor (parallel/ring.submatrix_pairs_sharded),
    so sharding is the memory relief here exactly as on the engine path
    (README.md:94-102).  Hit buffers are budgeted at their worst
    post-auto-retry capacity (min'd against ``max_results`` when given).

    ``submatrix`` enables the per-shard model (what the CLI always passes
    now, distributed included); without it, ``rows_per_device`` drives the
    plain triangular-ring model — a surface for library callers that
    precomputed their own per-device row count."""
    limit = device_bytes_limit() if bytes_limit is None else bytes_limit
    if limit is None:
        return
    hits_b = _ring_hits_bytes(capacity_per_device, max_results)
    if submatrix is not None:
        need = ring_shard_bytes(
            submatrix.num_rows, submatrix.num_cols, submatrix.is_diagonal,
            words, panel, num_devices, capacity_per_device, max_results,
        )
    else:
        need = 3 * (2 * rows_per_device * words * 4) + hits_b
    if need <= limit:
        return

    def worst(k: int) -> int:
        return _worst_ring_shard_bytes(
            num_samples, k, words, panel, num_devices,
            capacity_per_device, max_results,
        )

    # Splitting shrinks only the plane term; the hit-buffer term is
    # k-independent.  If not even maximal splitting fits, say so instead of
    # prescribing a split factor that cannot work.
    if worst(num_samples) > limit:
        raise InvalidArgumentError(
            f"Each of the {num_devices} mesh devices needs {need >> 20} MiB "
            f"for this shard's ring sweep but only {limit >> 20} MiB is "
            f"available, and no --split_factor can relieve it: the "
            f"{hits_b >> 20} MiB worst-case hit buffers alone don't fit. "
            "Lower --max_results/--capacity_per_device, or run on more "
            "devices."
        )
    if worst(split_factor) <= limit:
        # The caller's `need` (e.g. a library-supplied rows_per_device with
        # padding beyond this model) exceeds the limit even though the
        # internal worst-shard model at the current split fits — a split
        # prescription from the model would be misleading, so don't give one.
        raise InvalidArgumentError(
            f"Each of the {num_devices} mesh devices needs {need >> 20} MiB "
            f"for this ring sweep (incl. {hits_b >> 20} MiB worst-case hit "
            f"buffers) but only {limit >> 20} MiB is available; reduce the "
            "per-device row count or run on more devices."
        )
    # worst(k) is non-increasing in k: binary-search the minimal fitting k.
    lo, hi = split_factor, num_samples  # worst(lo) > limit, worst(hi) <= limit
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if worst(mid) > limit:
            lo = mid
        else:
            hi = mid
    raise InvalidArgumentError(
        f"Each of the {num_devices} mesh devices needs {need >> 20} MiB "
        f"for this shard's ring sweep (incl. {hits_b >> 20} MiB worst-case "
        f"hit buffers) but only {limit >> 20} MiB is available; increase "
        f"--split_factor to at least {hi} (it composes with --use_mesh), "
        "or run on more devices."
    )
