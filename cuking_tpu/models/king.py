"""KingEngine — the flagship model: all-pairs KING over packed planes.

This is the equivalent of the reference's host pipeline + kernel launch
(cuking.cu:435-751), redesigned for XLA's compilation model:

* The pair matrix is swept in fixed-size **sample panels** (default 1024).
  One jitted panel-pair step — dynamic-slice panels out of HBM, run a count
  kernel, apply the fp32 epilogue, threshold, compact — is compiled ONCE and
  replayed over every (i-panel, j-panel) with i ≤ j.  Static shapes
  throughout; no data-dependent control flow inside jit.
* Within a panel pair, the count kernel is selectable: ``popcount``
  (semantics baseline) or ``matmul`` (int8 indicator matmul, which XLA hands
  to cuBLAS on the GPU — the fast path).
* Sample storage follows the reference's shard layout: the Submatrix i-range
  stored before the j-range (cuking.cu:171-175), each padded to a panel
  multiple with all-missing samples (padding self-masks: zero counters, NaN
  kin, masked by validity anyway).
* Results: hits are compacted on device into ONE fixed-capacity buffer
  carried across every step and batch of the sweep (the SPMD analogue of the
  reference's single ``KingResult[max_results]`` array + atomicAdd slot
  counter, cuking.cu:296-313, 713-723), and fetched ONCE after the sweep —
  zero per-batch host transfers, so hit-bearing throughput matches hit-free.
  ``max_results`` is enforced globally (ResourceExhausted on overflow,
  cuking.cu:747-751) and the host finally sorts by (i, j, kin)
  (cuking.cu:761-765).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from functools import partial
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from cuking_tpu.ops import bitset
from cuking_tpu.ops.bitset import PlaneLayout
from cuking_tpu.ops.compaction import accumulate_hits, empty_result_buffers
from cuking_tpu.ops.king_jnp import panel_counts_popcount
from cuking_tpu.ops.king_math import king_from_counts
from cuking_tpu.ops.king_mm import panel_counts_matmul
from cuking_tpu.parallel.submatrix import Submatrix
from cuking_tpu.utils.status import InvalidArgumentError, ResourceExhaustedError
from cuking_tpu.utils.stopwatch import StageLogger

DEFAULT_KIN_THRESHOLD = 0.0884  # 2nd degree or closer (cuking.cu:43-45)
DEFAULT_MAX_RESULTS = 10 << 20  # cuking.cu:40-41
# Default device-resident result-buffer slots (24 B each).  Smaller than
# max_results so a hit-light sweep doesn't allocate the reference's full
# 252 MiB up front; a sweep whose exact total lands in (capacity,
# max_results] is re-run once at the next pow2 bucket (totals stay exact
# past capacity, so nothing is lost — the ring path's proven design).
DEFAULT_RESULT_CAPACITY = 1 << 20


def _ceil_div(a: int, b: int) -> int:
    return (a + b - 1) // b


def _ceil_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclass(frozen=True)
class KingConfig:
    """Runtime knobs; defaults mirror the reference's flags (cuking.cu:27-52)."""

    kin_threshold: float = DEFAULT_KIN_THRESHOLD
    max_results: int = DEFAULT_MAX_RESULTS
    panel: int = 1024               # samples per panel (pair tile edge)
    kernel: str = "auto"            # auto | popcount | matmul
    site_chunk_words: int = 128     # uint32 words per site-chunk (matmul)
    popcount_row_block: int = 8     # i-rows per popcount map step
    sweep_batch: int = 64           # panel-pair steps fused into one dispatch
    result_capacity: int = 0        # device result-buffer slots (0 = auto)
    verbose: bool = False

    def resolved_result_capacity(self) -> int:
        """Initial device result-buffer capacity: the explicit knob, else
        min(max_results, DEFAULT_RESULT_CAPACITY)."""
        return self.result_capacity or max(
            1, min(self.max_results, DEFAULT_RESULT_CAPACITY)
        )


@dataclass
class ResultSet:
    """Thresholded pairs, globally indexed, sorted by (i, j, kin)."""

    i_idx: np.ndarray   # int32 global sample indices
    j_idx: np.ndarray
    kin: np.ndarray     # float32
    ibs0: np.ndarray    # int32
    ibs1: np.ndarray
    ibs2: np.ndarray

    def __len__(self) -> int:
        return len(self.i_idx)

    @classmethod
    def concat_and_sort(cls, parts: list["ResultSet"]) -> "ResultSet":
        if not parts:
            z = np.zeros(0, np.int32)
            return cls(z, z, np.zeros(0, np.float32), z.copy(), z.copy(), z.copy())
        fields = {
            name: np.concatenate([getattr(p, name) for p in parts])
            for name in ("i_idx", "j_idx", "kin", "ibs0", "ibs1", "ibs2")
        }
        # Sort by (i, j, kin) ascending, like cuking.cu:761-765.
        order = np.lexsort((fields["kin"], fields["j_idx"], fields["i_idx"]))
        return cls(**{k: v[order] for k, v in fields.items()})


@partial(jax.jit, static_argnums=(1,))
def _slice_hits(bufs, n):
    """Stacks the first ``n`` slots of the six result buffers into one
    [6, n] int32 array (kin bitcast) so the host pays a SINGLE device→host
    transfer for the whole sweep's results (six per-field fetches would cost
    a host↔device round trip each)."""
    return jnp.stack(
        [
            bufs[0][:n],
            bufs[1][:n],
            lax.bitcast_convert_type(bufs[2][:n], jnp.int32),
            bufs[3][:n],
            bufs[4][:n],
            bufs[5][:n],
        ]
    )


# The count kernel ``kernel="auto"`` picks on each platform.  On the GPU the
# plain-XLA matmul (cuBLAS int8 GEMM) measured 2.3x faster end to end than a
# fused Pallas/Triton kernel (PERF.md), so both platforms use it.
_AUTO_KERNEL = {"gpu": "matmul", "cpu": "matmul"}


def resolve_kernel_name(config: KingConfig) -> str:
    """'auto' → the fast path for the current backend; an explicit name is
    returned as given.  Raises on a platform with no kernel of its own."""
    if config.kernel != "auto":
        return config.kernel
    platform = jax.default_backend()
    if platform not in _AUTO_KERNEL:
        raise InvalidArgumentError(
            f"No count kernel for platform '{platform}'; pass --kernel "
            f"explicitly (one of popcount, matmul)."
        )
    return _AUTO_KERNEL[platform]


def _resolve_kernel(config: KingConfig) -> Callable:
    name = resolve_kernel_name(config)
    if name == "popcount":
        return partial(panel_counts_popcount, row_block=config.popcount_row_block)
    if name == "matmul":
        return partial(panel_counts_matmul, site_chunk_words=config.site_chunk_words)
    raise InvalidArgumentError(f"Unknown kernel: {config.kernel}")


class PanelStorage:
    """Padded on-host plane storage in the reference's shard layout.

    The Submatrix i-range is stored first, then (for off-diagonal shards) the
    j-range (cuking.cu:171-175); each section is padded up to a panel multiple
    with all-missing samples so every jitted panel slice has identical shape.
    """

    def __init__(self, layout: PlaneLayout, submatrix: Submatrix, panel: int):
        self.layout = layout
        self.submatrix = submatrix
        self.panel = panel
        # Bumped by mutators (ingest); lets device-side caches detect stale
        # uploads instead of silently computing on pre-ingest planes.
        self.version = 0
        self.nr = submatrix.num_rows
        self.nc = submatrix.num_cols
        self.nr_pad = max(_ceil_div(self.nr, panel), 1) * panel
        if submatrix.is_diagonal:
            self.nc_pad = self.nr_pad
            self.j_store_base = 0
            total = self.nr_pad
        else:
            self.nc_pad = max(_ceil_div(self.nc, panel), 1) * panel
            self.j_store_base = self.nr_pad
            total = self.nr_pad + self.nc_pad
        self.planes = bitset.allocate_planes(total, layout)

    def mark_mutated(self) -> None:
        """Callers that write into ``planes`` (ingest) record it here so the
        engine re-uploads instead of sweeping a stale device copy."""
        self.version += 1

    def contains(self, global_idx: np.ndarray) -> np.ndarray:
        """True for samples stored in this shard (cuking.cu:675-678); the
        ingest-facing surface shared with HostShardedStorage."""
        return self.submatrix.contains(global_idx)

    def storage_offsets(self, global_idx: np.ndarray) -> np.ndarray:
        """Global sample index → padded storage row; callers must only pass
        indices with ``contains(idx)`` true (cf. cuking.cu:675-678).

        Branch-free arithmetic rather than np.where — at gnomAD ingest scale
        this runs over ~10⁷-element index arrays per Parquet file, and
        np.where is an order of magnitude slower than a fused mask-multiply
        on some hosts."""
        sm = self.submatrix
        global_idx = np.asarray(global_idx)
        in_j = (global_idx >= sm.i_end).astype(global_idx.dtype)
        return (
            global_idx
            - sm.i_begin
            + in_j * (self.j_store_base - sm.j_begin + sm.i_begin)
        )

    @property
    def num_i_panels(self) -> int:
        return self.nr_pad // self.panel

    @property
    def num_j_panels(self) -> int:
        return self.nc_pad // self.panel

    def i_panel(self, k: int) -> tuple[int, int, int]:
        """→ (storage offset, global base index, valid sample count)."""
        off = k * self.panel
        return off, self.submatrix.i_begin + off, max(0, min(self.panel, self.nr - off))

    def j_panel(self, k: int) -> tuple[int, int, int]:
        off = k * self.panel
        return (
            self.j_store_base + off,
            self.submatrix.j_begin + off,
            max(0, min(self.panel, self.nc - off)),
        )


class KingEngine:
    """Single-process KING driver for one shard (whole matrix if
    split_factor=1)."""

    def __init__(
        self,
        storage: PanelStorage,
        config: KingConfig | None = None,
        logger: StageLogger | None = None,
    ):
        self.config = config or KingConfig()
        self.storage = storage
        self.logger = logger or StageLogger(enabled=self.config.verbose)
        self._kernel = _resolve_kernel(self.config)
        self._sweep = self._build_sweep()
        self._planes_dev_cache = None
        self._planes_dev_version = None

    @property
    def planes_dev(self) -> jnp.ndarray:
        """Device-resident planes; uploaded once per storage version
        (host→device transfers of the full bitset are expensive and the
        planes are immutable during a sweep).  Mutators that go through
        ``storage.mark_mutated()`` — ingest does — invalidate the cache
        automatically; direct writes to ``storage.planes`` need an explicit
        ``refresh_planes()``."""
        version = getattr(self.storage, "version", None)
        if self._planes_dev_cache is None or self._planes_dev_version != version:
            self._planes_dev_cache = jnp.asarray(self.storage.planes)
            self._planes_dev_version = version
        return self._planes_dev_cache

    def refresh_planes(self) -> None:
        self._planes_dev_cache = None

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_genotypes(
        cls,
        genotypes: np.ndarray,
        config: KingConfig | None = None,
        submatrix: Submatrix | None = None,
        words_multiple: int | None = None,
    ) -> "KingEngine":
        """Test/synthetic convenience: dense [N, S] genotypes → engine."""
        config = config or KingConfig()
        n, s = genotypes.shape
        submatrix = submatrix or Submatrix.create(n, 1, 0)
        wm = words_multiple or min(bitset.DEFAULT_WORDS_MULTIPLE,
                                   max(16, config.site_chunk_words))
        layout = PlaneLayout.create(s, words_multiple=wm)
        storage = PanelStorage(layout, submatrix, config.panel)
        stored = submatrix.stored_sample_indices()
        offsets = storage.storage_offsets(stored)
        storage.planes[:, offsets, :] = bitset.pack_genotypes(
            genotypes[stored], layout
        )
        return cls(storage, config)

    # -- the jitted batched sweep -------------------------------------------
    #
    # All panel-pair steps of one dispatch are fused into a lax.scan over a
    # device-resident parameter array, so the host pays ONE dispatch per
    # batch instead of one host↔device round trip per panel pair.  Hits
    # accumulate into one device-resident fixed-capacity buffer threaded
    # through the scan carry AND across batch dispatches (donated, so XLA
    # updates it in
    # place) with a running-offset cursor — the reference's result model
    # exactly (one preallocated array + a global slot counter,
    # cuking.cu:296-313, 713-723).  The scatter is cond-gated so steps with
    # zero hits (the overwhelming majority under a sane threshold) skip it.
    # The running total stays exact past capacity, so a sweep whose total
    # lands in (capacity, max_results] is re-run once at the next pow2
    # bucket — overflow is recoverable, never silent (cuking.cu:747-751
    # semantics apply only to max_results itself).

    def _pair_compute(self, planes, row):
        """Shared per-step compute: slice panels → counts → epilogue → mask."""
        panel = self.config.panel
        words = self.storage.layout.words
        i_off, j_off, gi_base, gj_base, ni_valid, nj_valid = (
            row[0], row[1], row[2], row[3], row[4], row[5]
        )
        pi = lax.dynamic_slice(planes, (0, i_off, 0), (2, panel, words))
        pj = lax.dynamic_slice(planes, (0, j_off, 0), (2, panel, words))
        counts = self._kernel(pi, pj)
        res = king_from_counts(counts)

        local = jnp.arange(panel, dtype=jnp.int32)
        gi = gi_base + local
        gj = gj_base + local
        valid = (local < ni_valid)[:, None] & (local < nj_valid)[None, :]
        # Strict upper triangle on GLOBAL indices (cuking.cu:199) and strict
        # > threshold (cuking.cu:297); NaN kin never passes.
        mask = valid & (gi[:, None] < gj[None, :]) & (
            res.kin > self._threshold_ref[0]
        )
        gi2 = jnp.broadcast_to(gi[:, None], mask.shape)
        gj2 = jnp.broadcast_to(gj[None, :], mask.shape)
        return mask, (gi2, gj2, res.kin, res.ibs0, res.ibs1, res.ibs2)

    def _build_sweep(self):
        """Per-capacity cache of the jitted accumulating sweep; the capacity
        is a static shape, so each pow2 bucket compiles once."""
        self._planes_dev_ref = [None]
        self._threshold_ref = [None]
        return {}

    def _get_sweep(self, capacity: int):
        fn = self._sweep.get(capacity)
        if fn is None:

            def body(carry, row):
                def compute(c):
                    planes = self._planes_dev_ref[0]
                    mask, fields = self._pair_compute(planes, row)
                    return accumulate_hits(c[0], c[1], mask, fields, capacity)

                def skip(c):  # padding rows (ni_valid == 0): no kernel launch
                    return c

                return lax.cond(row[4] > 0, compute, skip, carry), None

            def sweep(planes, params, threshold, bufs, running):
                # Closure cells thread loop-invariant operands into the scan
                # body without widening the carry.
                self._planes_dev_ref[0] = planes
                self._threshold_ref[0] = threshold
                (bufs, running), _ = lax.scan(body, (bufs, running), params)
                return bufs, running

            # The result buffers are donated: each batch dispatch updates
            # them in place instead of copying ~capacity slots.  `running`
            # is NOT donated — the driver keeps per-batch references for the
            # lagged max_results check.
            fn = jax.jit(sweep, donate_argnums=(3,))
            self._sweep[capacity] = fn
        return fn

    @staticmethod
    def _empty_buffers(capacity: int) -> tuple:
        return empty_result_buffers(capacity)

    def _panel_pair_params(self) -> np.ndarray:
        """[num_steps, 6] int32 schedule: (i_off, j_off, gi_base, gj_base,
        ni_valid, nj_valid) for every (i-panel, j-panel) pair with any
        candidate i<j, mirroring the shard's pair set (cuking.cu:196-201)."""
        st = self.storage
        diagonal = st.submatrix.is_diagonal
        rows = []
        for ip in range(st.num_i_panels):
            i_off, gi_base, ni_valid = st.i_panel(ip)
            if ni_valid == 0:
                continue
            jp_start = ip if diagonal else 0
            for jp in range(jp_start, st.num_j_panels):
                j_off, gj_base, nj_valid = st.j_panel(jp)
                if nj_valid == 0:
                    continue
                rows.append((i_off, j_off, gi_base, gj_base, ni_valid, nj_valid))
        return np.asarray(rows, dtype=np.int32).reshape(-1, 6)

    # -- driver --------------------------------------------------------------

    def run(self) -> ResultSet:
        """Sweeps all (i-panel, j-panel) pairs of the shard and returns the
        thresholded, sorted results."""
        cfg = self.config
        capacity = cfg.resolved_result_capacity()
        while True:
            total, results = self._run_at_capacity(capacity)
            if results is not None:
                return results
            # Exact total in (capacity, max_results]: re-run once at the
            # next pow2 bucket (a compile-cache-friendly capacity key).
            new_capacity = min(_ceil_pow2(total), cfg.max_results)
            self.logger.print(
                f"Result buffer overflowed ({total} hits > {capacity} "
                f"slots); re-running at capacity {new_capacity}."
            )
            capacity = new_capacity

    def _run_at_capacity(
        self, capacity: int
    ) -> tuple[int, ResultSet | None]:
        """One full sweep at a fixed device result-buffer capacity.

        Returns ``(total, results)``; ``results`` is None when the exact
        total exceeded ``capacity`` while staying within ``max_results``
        (the caller retries at a larger bucket).  A total beyond
        ``max_results`` raises ResourceExhausted as soon as any batch's
        running count crosses it — the sweep stops dispatching early
        (cuking.cu:747-751 semantics, enforced mid-flight)."""
        cfg = self.config
        st = self.storage
        planes_dev = self.planes_dev
        threshold = jnp.float32(cfg.kin_threshold)
        sweep = self._get_sweep(capacity)

        params = self._panel_pair_params()
        num_steps = len(params)
        batch = cfg.sweep_batch
        self.logger.begin(
            f"Running KING kernel for {st.nr} x {st.nc} matrix"
            f" ({num_steps} panel-pair steps)..."
        )

        def check_limit(count: int) -> None:
            if count > cfg.max_results:
                raise ResourceExhaustedError(
                    "Could not store all results: try increasing the "
                    "--max_results parameter."
                )

        bufs = self._empty_buffers(capacity)
        running = jnp.int32(0)
        # Dispatches are asynchronous; the max_results check lags `window`
        # batches behind so the scalar count fetch (a host↔device round
        # trip) overlaps later batches' device work instead of serializing
        # the sweep.  Result buffers live on device throughout — there is
        # nothing else to fetch per batch.
        window = 4
        pending: deque = deque()
        for lo in range(0, num_steps, batch):
            chunk = params[lo : lo + batch]
            if len(chunk) < batch:
                # Pad with no-op rows (zero valid samples → skipped on device).
                pad = np.zeros((batch - len(chunk), 6), np.int32)
                chunk = np.concatenate([chunk, pad], axis=0)
            bufs, running = sweep(
                planes_dev, jnp.asarray(chunk), threshold, bufs, running
            )
            pending.append(running)
            if len(pending) >= window:
                check_limit(int(pending.popleft()))
        while pending:
            check_limit(int(pending.popleft()))
        total = int(running)
        self.logger.end("king_kernel")

        if total > capacity:
            return total, None
        self.logger.print(f"Processing {total} results...")
        if total == 0:
            return 0, ResultSet.concat_and_sort([])
        # ONE stacked device→host transfer for the whole sweep's results,
        # pow2-bucketed so repeated runs with similar hit counts reuse the
        # compiled slice (the reference reads its device-resident buffer
        # once here too, cuking.cu:713-723, 757-765).
        n = min(_ceil_pow2(total), capacity)
        arr = np.asarray(_slice_hits(bufs, n))
        part = ResultSet(
            i_idx=arr[0, :total],
            j_idx=arr[1, :total],
            kin=arr[2, :total].view(np.float32),
            ibs0=arr[3, :total],
            ibs1=arr[4, :total],
            ibs2=arr[5, :total],
        )
        return total, ResultSet.concat_and_sort([part])
