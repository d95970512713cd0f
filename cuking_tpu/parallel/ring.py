"""Multi-chip all-pairs KING: shard_map ring panel exchange over the mesh.

The reference's only multi-device story is share-nothing process sharding via
GCS (SURVEY.md §2 parallelism table; cloud_batch_submit.py fans out
k(k+1)/2 independent GPU jobs).  This design instead keeps the whole cohort
on the cards of one mesh: sample bit-plane panels are sharded over the mesh's
flat sample axis, and a **ring exchange** (``lax.ppermute``, which XLA hands
to NCCL over NVLink) rotates the j-panels so every block pair of the global
matrix is covered.  The mesh is one flat axis; nothing assumes a topology.

Balanced triangular schedule
----------------------------
The KING result is symmetric under swapping the pair (kin's numerator,
``min(het_i, het_j)``, and all IBS counters are i↔j symmetric —
cuking.cu:286-307), so a block pair {a, b} may be computed in EITHER
orientation and emitted as ``(min(i, j), max(i, j))``.  Rotating panels
*backwards* (device d receives from d+1) puts block ``(d + t) mod D`` on
device d at step t, so the schedule

    step 0:            every device × its own block   (diagonal)
    steps 1..⌊(D-1)/2⌋: every device × block (d+t)    (distinct pairs, all
                       devices fully busy — no masking at all)
    step D/2 (D even): devices d and d+D/2 both hold pair {d, d+D/2} and
                       each computes HALF of it (sub-tile row/col split)

covers each of the D(D+1)/2 block pairs exactly once in ``D//2 + 1`` steps
(⌈(D+1)/2⌉ for odd D) — the ring analogue of the reference's exactly-once
triangular Submatrix algebra (cuking.cu:129-179).  Every device performs
EXACTLY the same work (D/2 + 0.5 block-pairs for even D, (D+1)/2 for odd),
so wall-clock efficiency is ~100% at any D (±1 sub-tile of rounding when
the per-device sub-panel count is odd), versus ~50% for a naive D-step
rotation with an i<j mask.  ``ring_schedule`` is the executable
specification; ``_ring_fn`` mirrors it in traced form.

The next rotation's ``ppermute`` is issued *before* the kernel consumes the
current buffer (both only read it), so XLA's latency-hiding scheduler can
overlap the transfer with the count kernel (SURVEY.md §7 hard part (e)).

Thresholded hits are compacted into fixed per-device buffers (the SPMD
analogue of the reference's atomic result buffer, cuking.cu:296-313) with a
running cumulative-sum offset across ring steps.  Per-device totals are
exact even when a buffer overflows, so overflow is recoverable: the sweep is
re-run once at a pow2-bucketed capacity (see ``_run_with_retry``)
unless the GLOBAL total exceeds ``max_results`` — the reference's only
overflow semantic (cuking.cu:747-751).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cuking_tpu.models.king import DEFAULT_MAX_RESULTS, ResultSet
from cuking_tpu.ops.compaction import accumulate_hits, empty_result_buffers
from cuking_tpu.ops.king_math import king_from_counts
from cuking_tpu.utils.status import ResourceExhaustedError

AXIS = "samples"


def ring_num_steps(num_devices: int) -> int:
    """Scan length of the balanced schedule: ⌈(D+1)/2⌉, plus the half-active
    wrap step for even D."""
    return num_devices // 2 + 1 if num_devices % 2 == 0 else (num_devices + 1) // 2


def ring_schedule(num_devices: int) -> list[tuple[int, int, int, float]]:
    """Executable specification of the schedule: (device, step, col_block,
    work_fraction) for every (device, step).  The wrap step of an even-D
    ring (2t == D) is shared: BOTH devices of pair {d, d+D/2} compute half
    the block (fraction 0.5), split by sub-tile rows/cols in ``_ring_fn``
    phase 3.  Tests assert per-pair fractions sum to exactly 1 (each block
    pair computed exactly once) and per-device work is balanced."""
    d_ = num_devices
    sched = []
    for t in range(ring_num_steps(d_)):
        for dev in range(d_):
            frac = 1.0 if 2 * t < d_ else 0.5
            sched.append((dev, t, (dev + t) % d_, frac))
    return sched


def default_capacity_per_device(max_results: int, num_devices: int) -> int:
    """Per-device hit-buffer size for a given global ``max_results``: 2× the
    even share (floored at 2¹⁴, capped at the global limit).  Row-skewed hits
    beyond this — families are usually adjacent in sample order and land in
    one device's row block — don't fail the run: per-device totals are exact,
    so the sweep auto-retries once at a pow2-bucketed capacity."""
    return min(max_results, max(2 * (-(-max_results // num_devices)), 1 << 14))


class RingOutput(NamedTuple):
    """Per-device compacted results, concatenated on the host."""

    i_idx: jnp.ndarray  # [D * capacity] int32
    j_idx: jnp.ndarray
    kin: jnp.ndarray    # [D * capacity] float32
    ibs0: jnp.ndarray
    ibs1: jnp.ndarray
    ibs2: jnp.ndarray
    counts: jnp.ndarray  # [D] int32 exact per-device totals (may exceed capacity)

    @property
    def capacity_per_device(self) -> int:
        return self.i_idx.shape[0] // self.counts.shape[0]


def _choose_sub_panel(nd: int, requested: int) -> int:
    """Largest sub-panel ≤ requested that divides the per-device row count."""
    for p in range(min(requested, nd), 0, -1):
        if nd % p == 0:
            return p
    return nd


def _ring_fn(
    local_planes: jnp.ndarray,  # [2, nd, W] this device's sample panel
    threshold: jnp.ndarray,     # f32 scalar
    *,
    kernel: Callable,
    num_devices: int,
    num_samples: int,
    capacity: int,
    sub_panel: int | None = None,
    row_offset: int = 0,
):
    """Per-device SPMD body.  The nd×nd pair block of each ring step is
    processed in ``sub_panel``-sized sub-tiles (an inner lax.scan), so
    per-step intermediates (six int32 counter matrices + the fp32 epilogue)
    stay bounded at sub_panel² regardless of how many samples a device owns —
    without it, a production-sized row block (10k+ rows) would materialize
    multi-GB counts tensors and OOM the chip."""
    nd = local_planes.shape[1]
    words = local_planes.shape[2]
    p = sub_panel or nd
    assert nd % p == 0, (nd, p)
    ns = nd // p
    me = lax.axis_index(AXIS)
    # ``row_offset`` shifts emitted indices into global coordinates when the
    # ring sweeps one diagonal Submatrix block of a --split_factor run
    # (cuking.cu:129-179): sample r of the block is global row_offset + r,
    # and ``num_samples`` counts the BLOCK's samples.
    gi0 = row_offset + me * nd
    row_limit = row_offset + num_samples
    # Backwards rotation: device d receives from d+1, so after t hops device
    # d holds the panel of block (d + t) mod D.
    perm = [(d, (d - 1) % num_devices) for d in range(num_devices)]

    def emit(out, running, counts, gi_base, gj_base, same):
        """Epilogue + threshold + canonical-orientation compaction for one
        sub-tile (any static shape — the ns==1 wrap split emits asymmetric
        tiles).  ``same`` marks a sub-tile on the global diagonal (needs
        the strict i < j mask, cuking.cu:199); distinct blocks always hold
        distinct pairs.  KING is pair-symmetric, so a pair computed with the
        higher block resident still emits (lo, hi)."""
        res = king_from_counts(counts)
        gi = gi_base + jnp.arange(res.kin.shape[0], dtype=jnp.int32)
        gj = gj_base + jnp.arange(res.kin.shape[1], dtype=jnp.int32)
        mask = (
            (~same | (gi[:, None] < gj[None, :]))
            & (gi[:, None] < row_limit)
            & (gj[None, :] < row_limit)
            & (res.kin > threshold)
        )
        # A full-tile scatter is p² updates into the device buffer;
        # accumulate_hits cond-gates so only hit-bearing sub-tiles pay, and
        # its position scheme keeps the unique_indices promise literal even
        # when `running` has overflowed capacity (the auto-retry case).
        gi2 = jnp.broadcast_to(gi[:, None], mask.shape)
        gj2 = jnp.broadcast_to(gj[None, :], mask.shape)
        io = jnp.minimum(gi2, gj2)
        jo = jnp.maximum(gi2, gj2)
        fields = (io, jo, res.kin, res.ibs0, res.ibs1, res.ibs2)
        return accumulate_hits(out, running, mask, fields, capacity)

    def slice_rows(planes, k):
        return lax.dynamic_slice(planes, (0, k * p, 0), (2, p, words))

    def sub_counts(src_j, ii, jj):
        """Counts for sub-tile (ii, jj) of (local_planes × src_j)."""
        return kernel(slice_rows(local_planes, ii), slice_rows(src_j, jj))

    out0 = empty_result_buffers(capacity)

    # The first rotation is issued BEFORE the local-triangle phase: the hop
    # that delivers block (me+1) is in flight while the diagonal compute
    # runs.
    buf0 = (
        lax.ppermute(local_planes, AXIS, perm=perm)
        if num_devices > 1
        else local_planes
    )

    # Phase 1 — the resident block's own triangle (ring_schedule step 0).
    # The sub-pair list is STATIC and upper-triangular: sub-tiles below the
    # diagonal are never scheduled at all.
    tri_pairs = jnp.asarray(
        [(ii, jj) for ii in range(ns) for jj in range(ii, ns)], jnp.int32
    ).reshape(-1, 2)

    def tri_body(carry, pair):
        out, running = carry
        ii, jj = pair[0], pair[1]
        counts = sub_counts(local_planes, ii, jj)
        out, running = emit(
            out, running, counts, gi0 + ii * p, gi0 + jj * p, ii == jj
        )
        return (out, running), None

    (out, running), _ = lax.scan(tri_body, (out0, jnp.int32(0)), tri_pairs)

    # Phase 2 — full ring steps t = 1..⌊(D-1)/2⌋ against visiting blocks
    # (disjoint from the resident block, so the full ns×ns sub-grid is
    # useful work on EVERY device — no masking, no idling).
    grid_pairs = jnp.asarray(
        [(ii, jj) for ii in range(ns) for jj in range(ns)], jnp.int32
    ).reshape(-1, 2)

    def cross_sub_body(buf, owner):
        def sub_body(carry2, pair):
            out2, running2 = carry2
            ii, jj = pair[0], pair[1]
            counts = sub_counts(buf, ii, jj)
            return emit(
                out2, running2, counts,
                gi0 + ii * p, row_offset + owner * nd + jj * p,
                jnp.bool_(False),
            ), None

        return sub_body

    def body(carry, t):
        buf, out, running = carry
        # Issue the next rotation BEFORE consuming `buf`: the permute and the
        # kernel both only read it, so the transfer overlaps the compute.
        nxt = lax.ppermute(buf, AXIS, perm=perm) if num_devices > 1 else buf
        owner = (me + t) % num_devices
        (out, running), _ = lax.scan(
            cross_sub_body(buf, owner), (out, running), grid_pairs
        )
        return (nxt, out, running), None

    full_end = (num_devices - 1) // 2
    steps = jnp.arange(1, full_end + 1, dtype=jnp.int32)
    (buf, out, running), _ = lax.scan(body, (buf0, out, running), steps)

    # Phase 3 — the wrap step t = D/2 (even D only).  Devices a and a+D/2
    # both hold the pair {a, a+D/2} after D/2 rotations; each computes HALF
    # of it (ring_schedule frac 0.5): the lower-indexed device the first
    # h sub-rows of its resident block against the whole visitor, the
    # higher-indexed device the whole resident block against the visitor's
    # LAST ns-h sub-cols (= the canonical block's remaining rows).  Exact
    # partition for any h; h = ns//2 balances it (±1 sub-row when ns is
    # odd).  When the block is a SINGLE sub-tile (ns == 1) the split happens
    # INSIDE it by rows instead (the schedule's 0.5/0.5 promise must hold,
    # not idle the lower device): the lower device computes resident
    # rows [0, p1) × the whole visitor, the higher device its whole resident
    # × visitor rows [p1, p) — in canonical (a, b) terms, a-rows [0, p1) and
    # [p1, p) respectively.  Only a degenerate unsplittable p keeps the old
    # whole-block-to-higher-device behavior.
    if num_devices % 2 == 0 and num_devices > 1:
        owner = (me + num_devices // 2) % num_devices
        p1 = p // 2 if ns == 1 else 0
        if ns == 1 and p1:
            gj_owner = row_offset + owner * nd

            def low(carry):
                counts = kernel(
                    lax.slice_in_dim(local_planes, 0, p1, axis=1), buf
                )
                return emit(*carry, counts, gi0, gj_owner, jnp.bool_(False))

            def high(carry):
                counts = kernel(
                    local_planes, lax.slice_in_dim(buf, p1, p, axis=1)
                )
                return emit(
                    *carry, counts, gi0, gj_owner + p1, jnp.bool_(False)
                )

            out, running = lax.cond(
                2 * me < num_devices, low, high, (out, running)
            )
        else:
            h = ns // 2
            low_pairs = jnp.asarray(
                [(ii, jj) for ii in range(h) for jj in range(ns)], jnp.int32
            ).reshape(-1, 2)
            high_pairs = jnp.asarray(
                [(ii, jj) for ii in range(ns) for jj in range(h, ns)],
                jnp.int32,
            ).reshape(-1, 2)

            def half(pairs):
                def go(carry):
                    return lax.scan(cross_sub_body(buf, owner), carry, pairs)[0]

                return go

            out, running = lax.cond(
                2 * me < num_devices, half(low_pairs), half(high_pairs),
                (out, running),
            )

    return RingOutput(
        i_idx=out[0], j_idx=out[1], kin=out[2], ibs0=out[3], ibs1=out[4],
        ibs2=out[5], counts=running[None],
    )


def _rect_ring_fn(
    local_i: jnp.ndarray,   # [2, nd_i, W] this device's shard of the i-rows
    local_j: jnp.ndarray,   # [2, nd_j, W] this device's shard of the j-cols
    threshold: jnp.ndarray,
    *,
    kernel: Callable,
    num_devices: int,
    i_offset: int,
    i_count: int,
    j_offset: int,
    j_count: int,
    capacity: int,
    sub_panel_i: int | None,
    sub_panel_j: int | None,
):
    """Per-device SPMD body for an OFF-DIAGONAL Submatrix shard: every pair
    (r, c) with r in the shard's row block and c in its column block
    (cuking.cu:158-175 — off-diagonal shards hold two disjoint ranges, so
    every cross pair is valid, no triangle masking).

    Both ranges are sharded over the mesh's sample axis; the j shard rides
    the ring (``ppermute``) while the i shard stays resident, so after D
    steps every device has seen every j block: D · (nd_i × nd_j) pair tiles
    per device, identical on every device — trivially perfect balance, and
    each block pair computed exactly once.  The rotation for step t+1 is
    issued before step t's compute consumes the buffer, overlapping the
    transfer with the compute like the triangular ring."""
    nd_i, nd_j = local_i.shape[1], local_j.shape[1]
    words = local_i.shape[2]
    p_i = sub_panel_i or nd_i
    p_j = sub_panel_j or nd_j
    assert nd_i % p_i == 0 and nd_j % p_j == 0, (nd_i, p_i, nd_j, p_j)
    me = lax.axis_index(AXIS)
    gi0 = i_offset + me * nd_i
    i_limit = i_offset + i_count
    j_limit = j_offset + j_count
    local_i_idx = jnp.arange(p_i, dtype=jnp.int32)
    local_j_idx = jnp.arange(p_j, dtype=jnp.int32)
    perm = [(d, (d - 1) % num_devices) for d in range(num_devices)]

    def emit(out, running, counts, gi_base, gj_base):
        res = king_from_counts(counts)
        gi = gi_base + local_i_idx
        gj = gj_base + local_j_idx
        mask = (
            (gi[:, None] < i_limit)
            & (gj[None, :] < j_limit)
            & (res.kin > threshold)
        )
        # i-block rows precede j-block cols globally (bi < bj), so (gi, gj)
        # is already the canonical (min, max) orientation.
        gi2 = jnp.broadcast_to(gi[:, None], mask.shape)
        gj2 = jnp.broadcast_to(gj[None, :], mask.shape)
        fields = (gi2, gj2, res.kin, res.ibs0, res.ibs1, res.ibs2)
        return accumulate_hits(out, running, mask, fields, capacity)

    out0 = empty_result_buffers(capacity)
    grid_pairs = jnp.asarray(
        [(ii, jj) for ii in range(nd_i // p_i) for jj in range(nd_j // p_j)],
        jnp.int32,
    ).reshape(-1, 2)

    def sub_body(buf, owner):
        def go(carry, pair):
            out2, running2 = carry
            ii, jj = pair[0], pair[1]
            counts = kernel(
                lax.dynamic_slice(local_i, (0, ii * p_i, 0), (2, p_i, words)),
                lax.dynamic_slice(buf, (0, jj * p_j, 0), (2, p_j, words)),
            )
            return emit(
                out2, running2, counts,
                gi0 + ii * p_i, j_offset + owner * nd_j + jj * p_j,
            ), None

        return go

    def body(carry, t):
        buf, out, running = carry
        nxt = lax.ppermute(buf, AXIS, perm=perm) if num_devices > 1 else buf
        owner = (me + t) % num_devices
        (out, running), _ = lax.scan(
            sub_body(buf, owner), (out, running), grid_pairs
        )
        return (nxt, out, running), None

    (buf, out, running), _ = lax.scan(
        body, (local_j, out0, jnp.int32(0)),
        jnp.arange(num_devices, dtype=jnp.int32),
    )
    return RingOutput(
        i_idx=out[0], j_idx=out[1], kin=out[2], ibs0=out[3], ibs1=out[4],
        ibs2=out[5], counts=running[None],
    )


def _pad_and_shard(planes, count: int, mesh: Mesh) -> tuple[jnp.ndarray, int]:
    """Pads a [2, n, W] plane array with all-missing rows to an even
    per-device multiple and places it sharded along the sample axis.  Rows
    may already carry padding beyond ``count`` (panel multiples), so the pad
    target is max(count, n).
    Padding self-masks via the validity bound."""
    num_devices = mesh.devices.size
    n = planes.shape[1]
    nd = -(-max(count, n, 1) // num_devices)
    n_pad = nd * num_devices
    if n < n_pad:
        pad = np.full((2, n_pad - n, planes.shape[2]), 0xFFFFFFFF, np.uint32)
        planes = np.concatenate([np.asarray(planes), pad], axis=1)
    sharding = NamedSharding(mesh, P(None, AXIS, None))
    return jax.device_put(np.asarray(planes), sharding), nd


def all_pairs_sharded(
    planes: np.ndarray | jnp.ndarray,  # [2, N_stored, W] host or device
    num_samples: int,
    mesh: Mesh,
    kernel: Callable,
    *,
    kin_threshold: float,
    capacity_per_device: int = 1 << 20,
    max_results: int | None = None,
    auto_retry: bool = True,
    sub_panel: int | None = 1024,
    row_offset: int = 0,
) -> RingOutput:
    """Runs the ring sweep over the mesh; returns per-device compacted hits.

    ``planes`` is padded (all-ones = missing) up to ``D * ceil(N/D)`` rows and
    placed sharded along the sample axis; padding self-masks via the
    ``num_samples`` validity check.  ``sub_panel`` bounds per-step
    intermediates (see ``_ring_fn``); the default 1024 keeps them ≤~25 MiB at
    any cohort size
    (``None`` = whole block, test/debug only).
    """
    planes_sharded, _ = _pad_and_shard(planes, num_samples, mesh)
    return all_pairs_presharded(
        planes_sharded, num_samples, mesh, kernel,
        kin_threshold=kin_threshold, capacity_per_device=capacity_per_device,
        max_results=max_results, auto_retry=auto_retry,
        sub_panel=sub_panel, row_offset=row_offset,
    )


def all_pairs_presharded(
    planes_sharded: jnp.ndarray,  # [2, D*nd, W] already sharded P(None, AXIS, None)
    num_samples: int,
    mesh: Mesh,
    kernel: Callable,
    *,
    kin_threshold: float,
    capacity_per_device: int = 1 << 20,
    max_results: int | None = None,
    auto_retry: bool = True,
    sub_panel: int | None = 1024,
    row_offset: int = 0,
) -> RingOutput:
    """Ring sweep over an ALREADY sample-sharded global plane array.

    Multi-host entry point: each host builds only its devices' row blocks
    (cuking_tpu.parallel.distributed) instead of materializing the whole
    cohort's planes, then calls this.  Padding rows (global index ≥
    num_samples) must be all-ones (missing) — they self-mask.

    Overflow recovery: per-device totals stay exact past capacity, so a
    row-skewed run whose buffers overflow while the GLOBAL total is within
    ``max_results`` (the reference's only bound, cuking.cu:747-751) is
    re-run once at a pow2-bucketed capacity instead of failing.  The
    retry is deterministic across hosts — every host sees the same
    all-gathered counts.  Pass ``auto_retry=False`` to fail fast instead.
    """
    num_devices = mesh.devices.size
    nd = planes_sharded.shape[1] // num_devices
    p = _choose_sub_panel(nd, sub_panel) if sub_panel else None

    def run(capacity: int) -> RingOutput:
        fn = _compiled_ring(
            kernel, mesh, num_devices, num_samples, capacity, p, row_offset,
        )
        return fn(planes_sharded, jnp.float32(kin_threshold))

    return _run_with_retry(run, capacity_per_device, max_results, auto_retry)


def _run_with_retry(
    run: Callable[[int], RingOutput],
    capacity_per_device: int,
    max_results: int | None,
    auto_retry: bool,
) -> RingOutput:
    """Shared overflow auto-retry: per-device totals are exact past
    capacity, so a buffer overflow is re-run once at a bigger capacity —
    but only when the run is going to SUCCEED: the global total must be
    within max_results (the reference's semantic, cuking.cu:747-751; its
    own default when the caller gave none — retrying an unbounded
    keep-everything run would allocate `over` slots per device and trade a
    clean ResourceExhaustedError for a device OOM).  The retry capacity is
    bucketed to the next power of two (≤ the global limit): `capacity` is
    a compile-cache key, and retrying at the exact overflow count would
    retrace + recompile for every distinct skew."""
    out = run(capacity_per_device)
    if auto_retry:
        counts = ring_global_counts(out)
        over = int(counts.max(initial=0))
        limit = DEFAULT_MAX_RESULTS if max_results is None else max_results
        if over > capacity_per_device and int(counts.sum()) <= limit:
            bucket = 1 << (over - 1).bit_length()
            out = run(min(bucket, limit))
    return out


def rect_pairs_sharded(
    planes_i: np.ndarray | jnp.ndarray,  # [2, rows_stored, W] i-range rows
    planes_j: np.ndarray | jnp.ndarray,  # [2, cols_stored, W] j-range rows
    i_count: int,
    j_count: int,
    mesh: Mesh,
    kernel: Callable,
    *,
    i_offset: int,
    j_offset: int,
    kin_threshold: float,
    capacity_per_device: int = 1 << 20,
    max_results: int | None = None,
    auto_retry: bool = True,
    sub_panel: int | None = 1024,
) -> RingOutput:
    """Ring sweep of an OFF-DIAGONAL Submatrix shard over the mesh: all
    pairs (r, c), r in the i-range, c in the j-range (disjoint global
    ranges, cuking.cu:158-175).  Both ranges are sharded over the sample
    axis; j-blocks rotate around the ring.  Composes --split_factor with
    --use_mesh: each device holds 2/k'th of a split-k cohort's panel
    instead of the whole cohort's share — the reference's memory-relief
    axis (README.md:94-102) applied to the mesh path."""
    pi_sharded, _ = _pad_and_shard(planes_i, i_count, mesh)
    pj_sharded, _ = _pad_and_shard(planes_j, j_count, mesh)
    return rect_pairs_presharded(
        pi_sharded, pj_sharded, i_count, j_count, mesh, kernel,
        i_offset=i_offset, j_offset=j_offset, kin_threshold=kin_threshold,
        capacity_per_device=capacity_per_device, max_results=max_results,
        auto_retry=auto_retry, sub_panel=sub_panel,
    )


def rect_pairs_presharded(
    pi_sharded: jnp.ndarray,  # [2, D*nd_i, W] sharded P(None, AXIS, None)
    pj_sharded: jnp.ndarray,  # [2, D*nd_j, W] sharded P(None, AXIS, None)
    i_count: int,
    j_count: int,
    mesh: Mesh,
    kernel: Callable,
    *,
    i_offset: int,
    j_offset: int,
    kin_threshold: float,
    capacity_per_device: int = 1 << 20,
    max_results: int | None = None,
    auto_retry: bool = True,
    sub_panel: int | None = 1024,
) -> RingOutput:
    """Rectangular ring over ALREADY-sharded i/j plane arrays — the
    multi-host entry point (each host materializes only its devices' blocks
    of both ranges, cuking_tpu.parallel.distributed)."""
    num_devices = mesh.devices.size
    nd_i = pi_sharded.shape[1] // num_devices
    nd_j = pj_sharded.shape[1] // num_devices
    p_i = _choose_sub_panel(nd_i, sub_panel) if sub_panel else None
    p_j = _choose_sub_panel(nd_j, sub_panel) if sub_panel else None

    def run(capacity: int) -> RingOutput:
        fn = _compiled_rect_ring(
            kernel, mesh, num_devices, i_offset, i_count, j_offset, j_count,
            capacity, p_i, p_j,
        )
        return fn(pi_sharded, pj_sharded, jnp.float32(kin_threshold))

    return _run_with_retry(run, capacity_per_device, max_results, auto_retry)


def submatrix_pairs_sharded(
    storage,  # PanelStorage holding one shard's i-range (+ j-range) planes
    mesh: Mesh,
    kernel: Callable,
    *,
    kin_threshold: float,
    capacity_per_device: int = 1 << 20,
    max_results: int | None = None,
    auto_retry: bool = True,
    sub_panel: int | None = 1024,
) -> RingOutput:
    """Sweeps ONE Submatrix shard (any split_factor) over the mesh ring:
    a diagonal shard is the balanced triangular ring over its block with a
    global row offset; an off-diagonal shard is the rectangular j-rotating
    ring.  Input is the engine's own PanelStorage (i-range rows stored
    before the j-range, cuking.cu:171-175), so CLI ingest is shared."""
    sm = storage.submatrix
    if sm.is_diagonal:
        return all_pairs_sharded(
            storage.planes,
            sm.num_rows,
            mesh,
            kernel,
            kin_threshold=kin_threshold,
            capacity_per_device=capacity_per_device,
            max_results=max_results,
            auto_retry=auto_retry,
            sub_panel=sub_panel,
            row_offset=sm.i_begin,
        )
    return rect_pairs_sharded(
        storage.planes[:, : storage.j_store_base],
        storage.planes[:, storage.j_store_base :],
        sm.num_rows,
        sm.num_cols,
        mesh,
        kernel,
        i_offset=sm.i_begin,
        j_offset=sm.j_begin,
        kin_threshold=kin_threshold,
        capacity_per_device=capacity_per_device,
        max_results=max_results,
        auto_retry=auto_retry,
        sub_panel=sub_panel,
    )


from functools import lru_cache


_RING_OUT_SPECS = RingOutput(
    i_idx=P(AXIS), j_idx=P(AXIS), kin=P(AXIS), ibs0=P(AXIS),
    ibs1=P(AXIS), ibs2=P(AXIS), counts=P(AXIS),
)


@lru_cache(maxsize=32)
def _compiled_ring(
    kernel, mesh, num_devices, num_samples, capacity, sub_panel, row_offset,
):
    """Jitted shard_map sweep, cached so repeated invocations (retries, CLI
    re-runs, benchmarks) skip re-tracing the whole sub-tiled scan — tracing a
    100+-step scan costs hundreds of host milliseconds per call otherwise.
    Keyed on the kernel/mesh OBJECTS: callers should reuse them across calls
    to hit the cache (a miss is only a re-trace, never incorrect)."""
    fn = jax.shard_map(
        partial(
            _ring_fn,
            kernel=kernel,
            num_devices=num_devices,
            num_samples=num_samples,
            capacity=capacity,
            sub_panel=sub_panel,
            row_offset=row_offset,
        ),
        mesh=mesh,
        in_specs=(P(None, AXIS, None), P()),
        out_specs=_RING_OUT_SPECS,
        check_vma=False,
    )
    return jax.jit(fn)


@lru_cache(maxsize=32)
def _compiled_rect_ring(
    kernel, mesh, num_devices, i_offset, i_count, j_offset, j_count,
    capacity, sub_panel_i, sub_panel_j,
):
    fn = jax.shard_map(
        partial(
            _rect_ring_fn,
            kernel=kernel,
            num_devices=num_devices,
            i_offset=i_offset,
            i_count=i_count,
            j_offset=j_offset,
            j_count=j_count,
            capacity=capacity,
            sub_panel_i=sub_panel_i,
            sub_panel_j=sub_panel_j,
        ),
        mesh=mesh,
        in_specs=(P(None, AXIS, None), P(None, AXIS, None), P()),
        out_specs=_RING_OUT_SPECS,
        check_vma=False,
    )
    return jax.jit(fn)


def ring_global_counts(out: RingOutput) -> np.ndarray:
    """The exact [D] per-device hit totals, on every host.

    In a multi-host run ``out.counts`` is sharded (each host addresses only
    its local devices' entries); the reference's ``--max_results`` bounds the
    GLOBAL count (cuking.cu:747-751), so enforcement needs the all-gathered
    vector."""
    if out.counts.is_fully_addressable:
        return np.asarray(out.counts)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(out.counts, tiled=True))


def _check_overflow(
    counts: np.ndarray, capacity_per_device: int, max_results: int | None
) -> None:
    if (counts > capacity_per_device).any():
        raise ResourceExhaustedError(
            "Could not store all results: a device's hit buffer overflowed "
            f"(max {int(counts.max())} hits vs capacity {capacity_per_device}). "
            "Hits are row-skewed beyond the auto-retry bound; increase "
            "--max_results or pass a larger capacity_per_device."
        )
    if max_results is not None and counts.sum() > max_results:
        # The reference's semantic: the GLOBAL count is bounded
        # (cuking.cu:747-751).
        raise ResourceExhaustedError(
            "Could not store all results: try increasing the "
            "--max_results parameter."
        )


def ring_output_local_resultset(
    out: RingOutput, max_results: int | None = None
) -> ResultSet:
    """Multi-host variant: extracts only THIS process's device buffers.

    Each host materializes just its addressable shards and writes them as its
    own output partition — preserving the reference's share-nothing,
    trivially-mergeable output property (README.md:102) across hosts.
    Overflow and the global ``max_results`` bound are checked against the
    all-gathered counts, so every host raises in unison (fail-fast like
    cuking.cu:747-751)."""
    capacity = out.capacity_per_device
    _check_overflow(ring_global_counts(out), capacity, max_results)
    local_counts = {
        s.index[0].start or 0: int(np.asarray(s.data)[0])
        for s in out.counts.addressable_shards
    }
    buffers = {}
    for name in ("i_idx", "j_idx", "kin", "ibs0", "ibs1", "ibs2"):
        for s in getattr(out, name).addressable_shards:
            start = s.index[0].start or 0
            buffers.setdefault(start // capacity, {})[name] = np.asarray(s.data)
    parts = []
    for d, count in sorted(local_counts.items()):
        if count == 0:
            continue
        bufs = buffers[d]
        parts.append(ResultSet(**{k: v[:count] for k, v in bufs.items()}))
    return ResultSet.concat_and_sort(parts)


def ring_output_to_resultset(
    out: RingOutput, max_results: int | None = None
) -> ResultSet:
    """Host-side gather of per-device buffers → sorted ResultSet; raises on
    overflow like cuking.cu:747-751 (global ``max_results`` bound, plus the
    physical per-device capacity if auto-retry was disabled)."""
    capacity = out.capacity_per_device
    counts = np.asarray(out.counts)
    _check_overflow(counts, capacity, max_results)
    parts = []
    for d, c in enumerate(counts):
        if c == 0:
            continue
        lo = d * capacity
        parts.append(
            ResultSet(
                i_idx=np.asarray(out.i_idx[lo : lo + c]),
                j_idx=np.asarray(out.j_idx[lo : lo + c]),
                kin=np.asarray(out.kin[lo : lo + c]),
                ibs0=np.asarray(out.ibs0[lo : lo + c]),
                ibs1=np.asarray(out.ibs1[lo : lo + c]),
                ibs2=np.asarray(out.ibs2[lo : lo + c]),
            )
        )
    return ResultSet.concat_and_sort(parts)
