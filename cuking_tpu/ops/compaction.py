"""Fixed-capacity thresholded result compaction — the SPMD analogue of the
reference's atomic result buffer (cuking.cu:296-313).

The CUDA kernel reserves slots in a global ``KingResult[max_results]`` array
with ``atomicAdd`` and raises an overflow flag past capacity
(cuking.cu:299-312, 747-751).  Under jit/XLA we cannot have dynamic shapes,
so each panel-pair step compacts its hits into a static-capacity buffer via a
masked cumulative-sum scatter; positions past capacity are dropped by the
scatter (``mode='drop'``) and detected by comparing the returned total against
capacity.  Flattening row-major keeps hits ordered by (i, j), which the
reference's final host sort requires anyway (cuking.cu:761-765).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class CompactedPanel(NamedTuple):
    total: jnp.ndarray  # int32 scalar: number of pairs passing the mask
    i_idx: jnp.ndarray  # [capacity] int32 global sample i
    j_idx: jnp.ndarray  # [capacity] int32 global sample j
    kin: jnp.ndarray    # [capacity] float32
    ibs0: jnp.ndarray   # [capacity] int32
    ibs1: jnp.ndarray   # [capacity] int32
    ibs2: jnp.ndarray   # [capacity] int32


# Plain Python scalars only: a jnp scalar here would initialize the JAX
# backend at import time, so `import cuking_tpu` would claim a device.
FIELD_FILLS = (-1, -1, 0.0, 0, 0, 0)  # i, j, kin, ibs0/1/2
FIELD_DTYPES = (jnp.int32, jnp.int32, jnp.float32, jnp.int32, jnp.int32,
                jnp.int32)


def empty_result_buffers(capacity: int) -> tuple:
    """The six [capacity] result buffers at their fill values — the one
    definition shared by the engine sweep and both ring bodies."""
    return tuple(
        jnp.full((capacity,), fill, dt)
        for fill, dt in zip(FIELD_FILLS, FIELD_DTYPES)
    )


def scatter_positions(
    mask_flat: jnp.ndarray, running: jnp.ndarray | int, capacity: int
) -> jnp.ndarray:
    """Scatter positions for masked lanes with the ``unique_indices=True``
    promise holding LITERALLY, overflow included.

    Hit lane k (0-indexed over all lanes) gets ``running + cumsum - 1``,
    clamped to ``capacity + k``; dropped lanes get ``capacity + size + k``.
    All out-of-bounds values are discarded by ``mode='drop'`` — negative
    indices are NOT usable as drop sentinels (they wrap, NumPy-style) — and
    the clamp keeps every index distinct even when ``running`` has passed
    ``capacity``: in-bounds hits keep their exact slot; clamped hits sit in
    [capacity, capacity + size); dropped lanes in [capacity + size, ·).
    (Monotonicity argument: for hit lanes k1 < k2 the clamped values stay
    strictly ordered in every clamp combination.)"""
    k = jnp.arange(mask_flat.size, dtype=jnp.int32)
    pos = running + jnp.cumsum(mask_flat, dtype=jnp.int32) - 1
    return jnp.where(
        mask_flat,
        jnp.minimum(pos, capacity + k),
        capacity + mask_flat.size + k,
    )


def scatter_hits(mask: jnp.ndarray, fields, capacity: int) -> tuple:
    """The one masked cumsum-scatter primitive shared by the engine and
    compact_panel: fields ``(i, j, kin, ibs0, ibs1, ibs2)`` of any common
    shape are flattened row-major and packed into [capacity] buffers at the
    masked positions; positions past capacity are dropped (``mode='drop'``).
    Positions are unique by construction (:func:`scatter_positions`)."""
    flat = mask.ravel()
    pos = scatter_positions(flat, 0, capacity)
    return tuple(
        jnp.full((capacity,), fill, f.dtype).at[pos].set(
            f.ravel(), mode="drop", unique_indices=True
        )
        for f, fill in zip(fields, FIELD_FILLS)
    )


# Candidate lanes extracted per step by the top_k fast path; also the bound
# on hits a single step can take through it (per-block overflow falls back
# to the exact full scatter).
CANDIDATE_BUDGET = 1 << 14


def accumulate_hits(
    out: tuple, running: jnp.ndarray, mask: jnp.ndarray, fields, capacity: int
) -> tuple[tuple, jnp.ndarray]:
    """Running-offset compaction: pack this step's hits into the carried
    [capacity] buffers starting at ``running`` and return ``(out', running +
    nhits)``.  This is the device-resident cross-step accumulation the
    reference gets from its global atomicAdd slot counter
    (cuking.cu:296-313): totals stay exact past capacity (overflow is
    detected from the final count, never lost).

    A scatter costs O(lanes executed) regardless of hit count, so a naive
    path pays six full-panel 1M-update scatters on every hit-bearing step.
    The fast path therefore GATHERS first: the mask
    is split into row blocks, each block extracts its ≤ KB hit-lane indices
    with a batched ``top_k`` over index-or-(-1) keys, the six fields are
    gathered at those lanes, and only the ~2¹⁴ candidate lanes are
    scattered.  Whether this still pays on the GPU is not measured yet
    (ROADMAP Speed #6).  Hit ORDER within the buffer is block-major,
    not row-major — callers sort by (i, j, kin) at the end regardless
    (cuking.cu:761-765).  A step where any block's hit count exceeds its
    candidate quota cond-falls-back to the exact full-panel scatter, so any
    hit density remains exact."""
    flat = mask.ravel()
    n = flat.size
    ni = mask.shape[0] if mask.ndim == 2 else 1
    # Row-block split: ~2¹⁴-lane blocks, a divisor of the row count so the
    # reshape is exact.
    nb = min(ni, max(1, n // CANDIDATE_BUDGET))
    while ni % nb:
        nb -= 1
    bs = n // nb
    kb = min(bs, max(1, CANDIDATE_BUDGET // nb))
    m2 = flat.reshape(nb, bs)
    block_hits = jnp.sum(m2, axis=1, dtype=jnp.int32)
    nhits = jnp.sum(block_hits, dtype=jnp.int32)
    flat_fields = tuple(f.ravel() for f in fields)

    def fast(c):
        bufs, run = c
        lane = jnp.broadcast_to(
            jnp.arange(bs, dtype=jnp.int32)[None, :], m2.shape
        )
        key = jnp.where(m2, lane, -1)
        top, _ = jax.lax.top_k(key, kb)  # [nb, kb] lane-in-block, -1 fills
        cmask = (top >= 0).ravel()
        blk = jnp.broadcast_to(
            jnp.arange(nb, dtype=jnp.int32)[:, None] * bs, top.shape
        )
        src = (blk + jnp.maximum(top, 0)).ravel()
        pos = scatter_positions(cmask, run, capacity)
        return tuple(
            o.at[pos].set(f[src], mode="drop", unique_indices=True)
            for o, f in zip(bufs, flat_fields)
        )

    def slow(c):  # a block overflowed its quota: exact full-panel scatter
        bufs, run = c
        pos = scatter_positions(flat, run, capacity)
        return tuple(
            o.at[pos].set(f, mode="drop", unique_indices=True)
            for o, f in zip(bufs, flat_fields)
        )

    def hit(c):
        return jax.lax.cond(jnp.max(block_hits) <= kb, fast, slow, c)

    out = jax.lax.cond(nhits > 0, hit, lambda c: c[0], (out, running))
    return out, running + nhits


def compact_panel(
    mask: jnp.ndarray,
    i_idx: jnp.ndarray,
    j_idx: jnp.ndarray,
    kin: jnp.ndarray,
    ibs0: jnp.ndarray,
    ibs1: jnp.ndarray,
    ibs2: jnp.ndarray,
    capacity: int,
) -> CompactedPanel:
    """Scatter masked [NI, NJ] pair results into [capacity] buffers.

    ``total`` may exceed ``capacity``; callers treat that as overflow
    (ResourceExhausted, mirroring cuking.cu:747-751).  Engine callers use
    ``capacity == NI*NJ`` so per-panel overflow is impossible and only the
    global ``max_results`` check applies.
    """
    total = jnp.sum(mask.ravel(), dtype=jnp.int32)
    bufs = scatter_hits(mask, (i_idx, j_idx, kin, ibs0, ibs1, ibs2), capacity)
    return CompactedPanel(total, *bufs)
