"""Host-sharded plane storage for multi-host meshes.

The reference's memory-relief mechanism is process-level sharding: each GPU
job stores only its Submatrix's sample ranges (cuking.cu:507-517,
README.md:94-98).  On a multi-host mesh the analogous property is that each
HOST materializes only the sample row-blocks its local devices own: ingest filters
the COO entries to the host's global row ranges (exactly like the shard
ingest filter, cuking.cu:675-678), packs them into per-device numpy blocks,
and assembles globally-sharded ``jax.Array``s via
``jax.make_array_from_single_device_arrays`` — no host ever holds the whole
cohort's bitset.

The two memory-relief axes COMPOSE: passing a ``submatrix`` stores only
that shard's sample range(s) (the i-range, plus the j-range for an
off-diagonal shard, cuking.cu:158-175), each range itself sharded over the
mesh — so a host holds ``ranges/k / num_hosts``'th of the cohort on a
split-k run.

Single-process runs degenerate to "all devices are local", which is how the
unit tests cover this path on the 8-device CPU mesh.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cuking_tpu.ops import bitset
from cuking_tpu.ops.bitset import PlaneLayout
from cuking_tpu.parallel.ring import AXIS


class HostShardedStorage:
    """This host's slice of the sample-sharded global plane array(s).

    Global layout per stored range: device at mesh position ``p`` (row-major
    over ``mesh.devices``) owns range-local rows ``[p*nd, (p+1)*nd)``; rows
    at or past the range length are padding (all-ones = missing,
    self-masking).  This host stores one ``[2, nd, W]`` block per local
    device per range, concatenated in (range, mesh-position) order.

    Without ``submatrix`` there is one range covering the whole cohort
    (``[0, num_samples)``); with it, the shard's i-range (and j-range for
    off-diagonal shards) — the ingest surface (``contains`` /
    ``storage_offsets``) is identical either way.
    """

    def __init__(
        self,
        layout: PlaneLayout,
        num_samples: int,
        mesh: Mesh,
        submatrix=None,
    ):
        self.layout = layout
        self.num_samples = num_samples
        self.mesh = mesh
        self.submatrix = submatrix
        num_devices = mesh.devices.size
        if submatrix is None:
            ranges = [(0, num_samples)]
        elif submatrix.is_diagonal:
            ranges = [(submatrix.i_begin, submatrix.num_rows)]
        else:
            ranges = [
                (submatrix.i_begin, submatrix.num_rows),
                (submatrix.j_begin, submatrix.num_cols),
            ]
        self.ranges = ranges
        process = jax.process_index()
        # (mesh position, device) pairs owned by this process, mesh order.
        self.local_blocks = [
            (p, d)
            for p, d in enumerate(mesh.devices.flat)
            if d.process_index == process
        ]
        # O(1) vectorized lookups for the ingest hot path (avoid per-element
        # Python dispatch on ~10⁷-entry COO arrays).
        self._block_lut = np.full(num_devices, -1, np.int64)
        for k, (p, _) in enumerate(self.local_blocks):
            self._block_lut[p] = k
        # Per-range geometry: per-device rows (nd), local section base row.
        self._nd = []
        self._section_base = []
        base = 0
        for _, length in ranges:
            nd = -(-max(length, 1) // num_devices)
            self._nd.append(nd)
            self._section_base.append(base)
            base += nd * len(self.local_blocks)
        self._n_pad = [nd * num_devices for nd in self._nd]
        self.planes = bitset.allocate_planes(base, layout)
        self.version = 0

    @property
    def nd(self):
        """Per-device rows: an int for single-range storage (the common
        case and the pre-split API), a tuple per range otherwise."""
        return self._nd[0] if len(self._nd) == 1 else tuple(self._nd)

    @property
    def n_pad(self):
        return self._n_pad[0] if len(self._n_pad) == 1 else tuple(self._n_pad)

    def mark_mutated(self) -> None:
        self.version += 1

    # -- the ingest-facing surface (duck-typed like PanelStorage) ----------

    def _range_masks(self, global_idx: np.ndarray) -> list[np.ndarray]:
        out = []
        for (begin, length), nd in zip(self.ranges, self._nd):
            rel = np.asarray(global_idx) - begin
            in_range = (rel >= 0) & (rel < length)
            positions = np.clip(rel // nd, 0, len(self._block_lut) - 1)
            out.append(in_range & (self._block_lut[positions] >= 0))
        return out

    def contains(self, global_idx: np.ndarray) -> np.ndarray:
        """True for samples stored on this host (cf. cuking.cu:675-678)."""
        masks = self._range_masks(global_idx)
        result = masks[0]
        for m in masks[1:]:
            result = result | m
        return result

    def storage_offsets(self, global_idx: np.ndarray) -> np.ndarray:
        """Global sample index → row in this host's concatenated blocks;
        callers must only pass indices with ``contains(idx)`` true.

        Range selection needs only the (disjoint) global ranges — locality
        is guaranteed by the ``contains`` contract — so this avoids
        re-deriving the block-ownership masks on the ~10⁷-entry ingest
        arrays (the single-range common case takes the direct path)."""
        global_idx = np.asarray(global_idx)
        (begin, _), nd, base = self.ranges[0], self._nd[0], self._section_base[0]
        rel = global_idx - begin
        offsets = base + self._block_lut[
            np.clip(rel // nd, 0, len(self._block_lut) - 1)
        ] * nd + rel % nd
        for (begin, length), nd, base in zip(
            self.ranges[1:], self._nd[1:], self._section_base[1:]
        ):
            rel = global_idx - begin
            # Branch-free select (np.where is ~10-30x slower than fused
            # mask arithmetic on some hosts; see PanelStorage.storage_offsets).
            in_range = ((rel >= 0) & (rel < length)).astype(offsets.dtype)
            block = self._block_lut[
                np.clip(rel // nd, 0, len(self._block_lut) - 1)
            ]
            offsets += in_range * (base + block * nd + rel % nd - offsets)
        return offsets

    # -- assembly ----------------------------------------------------------

    def to_global_arrays(self) -> list[jax.Array]:
        """Per-device blocks → one globally-sharded [2, n_pad_r, W]
        jax.Array per stored range."""
        sharding = NamedSharding(self.mesh, P(None, AXIS, None))
        arrays = []
        for r, (nd, base) in enumerate(zip(self._nd, self._section_base)):
            shards = [
                jax.device_put(
                    self.planes[:, base + k * nd : base + (k + 1) * nd, :], d
                )
                for k, (_, d) in enumerate(self.local_blocks)
            ]
            arrays.append(
                jax.make_array_from_single_device_arrays(
                    (2, self._n_pad[r], self.layout.words), sharding, shards
                )
            )
        return arrays

    def to_global_array(self) -> jax.Array:
        """Single-range convenience (whole-cohort or diagonal-shard)."""
        assert len(self.ranges) == 1, "off-diagonal shard stores two ranges"
        return self.to_global_arrays()[0]
