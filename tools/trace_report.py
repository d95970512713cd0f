"""Capture jax.profiler traces of the engine sweep (hit-free + hitful) and
the 1-device ring on a GPU, then reduce the device planes of the xplane
(jax.profiler.ProfileData — no TensorBoard needed) to the numbers PERF.md
quotes: device busy and idle share, time by op category, and the top ops.

A GPU device plane (``/device:GPU:N``) has one line per CUDA stream; its
events are the kernels XLA launched, named after their fusion or library
kernel (``input_concatenate_fusion``, ``sm90_xmma_gemm_i8i32_...``,
``ncclDevKernel_...``).  Busy time is the union of those intervals over all
streams; idle share is 1 - busy / span, with the span from the first to the
last device event of the trace.

Usage: python tools/trace_report.py [--outdir DIR]
"""
import argparse
import collections
import dataclasses
import glob
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, ".")

CATEGORIES = (
    ("collective (NCCL)", ("nccl", "collective", "sendrecv")),
    ("int8 GEMM (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas")),
    ("scatter", ("scatter",)),
    ("sort/top_k", ("sort", "topk", "top_k", "top-k")),
    ("gather", ("gather",)),
    ("dynamic-slice/update", ("dynamic_slice", "dynamic-slice",
                              "dynamic_update_slice")),
    ("memcpy/memset", ("memcpy", "memset")),
    ("fusion (unpack/accumulate/epilogue)", ("fusion", "wrapped_")),
)


def classify(name: str) -> str:
    n = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in n for k in keys):
            return cat
    return "other"


def _device_events(trace_dir: str) -> dict:
    """{device plane name: [(name, start_ns, end_ns), ...]} over every
    stream line of each GPU plane of the newest trace under ``trace_dir``."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))[-1]
    pd = ProfileData.from_file(path)
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        events = [
            (e.name, e.start_ns, e.start_ns + e.duration_ns)
            for line in plane.lines
            for e in line.events
        ]
        if events:
            out[plane.name] = events
    return out


def _union_ns(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def analyze(trace_dir: str) -> dict:
    """Busy/idle share, time by category and the top five ops, summed over
    the GPU planes of the trace."""
    by_cat = collections.Counter()
    by_op = collections.Counter()
    busy = span = 0.0
    for events in _device_events(trace_dir).values():
        for name, s, e in events:
            by_cat[classify(name)] += e - s
            by_op[name] += e - s
        busy += _union_ns((s, e) for _, s, e in events)
        span += max(e for *_, e in events) - min(s for _, s, _ in events)
    return {
        "busy_ms": busy / 1e6,
        "span_ms": span / 1e6,
        "idle_share": 1.0 - busy / span if span else None,
        "by_category_ms": {k: v / 1e6 for k, v in by_cat.most_common()},
        "top_ops_ms": [(k, v / 1e6) for k, v in by_op.most_common(5)],
    }


def ppermute_overlap(trace_dir: str) -> dict | None:
    """How much collective time is covered by the SAME card's compute —
    the ring schedule's claim that the next rotation's panel exchange hides
    under the current rotation's kernels (parallel/ring.py).  None when the
    trace holds no collectives (D=1: XLA compiles the self-permute away).
    Per plane: pooling planes would credit another card's compute on a
    phase-staggered ring."""
    total = covered = nev = 0.0
    for events in _device_events(trace_dir).values():
        coll = sorted((s, e) for n, s, e in events
                      if classify(n) == "collective (NCCL)")
        if not coll:
            continue
        merged = []
        for s, e in sorted((s, e) for n, s, e in events
                           if classify(n) not in ("collective (NCCL)",
                                                  "memcpy/memset")):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        nev += len(coll)
        total += sum(e - s for s, e in coll)
        for s, e in coll:
            for ms, me in merged:
                if me > s and ms < e:
                    covered += min(e, me) - max(s, ms)
    if nev == 0:
        return None
    return {
        "collective_ms": total / 1e6,
        "overlapped_ms": covered / 1e6,
        "overlap_fraction": covered / max(total, 1),
        "num_events": int(nev),
    }


def report(tag, stats):
    print(f"\n== {tag} ==")
    print(f"  device busy {stats['busy_ms']:.2f} ms of a "
          f"{stats['span_ms']:.2f} ms span: idle share "
          f"{stats['idle_share']:.4f}")
    for k, v in stats["by_category_ms"].items():
        share = 100.0 * v / max(stats["busy_ms"], 1e-9)
        print(f"    {k:38s} {v:10.2f} ms  {share:5.1f}% of busy")
    print("  top ops:")
    for k, v in stats["top_ops_ms"]:
        print(f"    {v:10.2f} ms  {k[:100]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default=os.path.join(
        tempfile.gettempdir(), "cuking_traces"))
    args = ap.parse_args()

    from cuking_tpu.utils.compile_cache import enable_compile_cache
    from cuking_tpu.utils.device import NoGpuError, nvidia_smi_line, require_gpu

    enable_compile_cache()
    try:
        require_gpu()
    except NoGpuError as e:
        print(f"trace_report.py: {e}", file=sys.stderr)
        return 1
    import jax

    from cuking_tpu.models.king import KingConfig, KingEngine, PanelStorage
    from cuking_tpu.ops.bitset import PlaneLayout
    from cuking_tpu.parallel.submatrix import Submatrix

    print(f"card: {nvidia_smi_line()}")
    num_samples, num_sites, panel = 16384, 100_000, 1024
    layout = PlaneLayout.create(num_sites)
    storage = PanelStorage(layout, Submatrix.create(num_samples, 1, 0), panel)
    rng = np.random.default_rng(0)
    storage.planes[:] = rng.integers(0, 2**32, storage.planes.shape,
                                     dtype=np.uint32)
    cfg = KingConfig(kin_threshold=0.9, panel=panel, sweep_batch=16)
    engine = KingEngine(storage, cfg)
    engine.run()  # warm-up/compile

    d1 = os.path.join(args.outdir, "engine_hitfree")
    with jax.profiler.trace(d1):
        t0 = time.perf_counter()
        engine.run()
        dt = time.perf_counter() - t0
    print(f"hit-free run: {dt*1e3:.1f} ms (traced)")
    report("engine sweep, hit-free (0.9 threshold)", analyze(d1))

    # hitful: clone 8-sample families (the bench's hit pattern)
    family, members = 512, 8
    for fam in range(family):
        src = fam * members
        storage.planes[:, src + 1:src + members] = storage.planes[:, src:src + 1]
    storage.mark_mutated()
    engine.config = dataclasses.replace(engine.config, kin_threshold=0.0884)
    engine.run()  # warm-up hit path
    d2 = os.path.join(args.outdir, "engine_hitful")
    with jax.profiler.trace(d2):
        t0 = time.perf_counter()
        rs = engine.run()
        dt = time.perf_counter() - t0
    print(f"hitful run: {dt*1e3:.1f} ms, {len(rs)} hits (traced)")
    report("engine sweep, hitful (default threshold)", analyze(d2))

    # 1-device ring (sub-tiled triangle + compaction; the ppermute is a
    # no-op at D=1 — tools/scaling_bench.py traces the multi-GPU ring).
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from cuking_tpu.models.king import _resolve_kernel
    from cuking_tpu.parallel.ring import all_pairs_presharded

    mesh = Mesh(np.array(jax.devices()[:1]), axis_names=("samples",))
    planes_sharded = jax.device_put(
        storage.planes, NamedSharding(mesh, P(None, "samples", None))
    )
    rk = _resolve_kernel(cfg)
    ring_args = dict(kin_threshold=0.0884, capacity_per_device=1 << 20,
                     sub_panel=panel)
    out = all_pairs_presharded(planes_sharded, num_samples, mesh, rk,
                               **ring_args)
    jax.block_until_ready(out.counts)
    d3 = os.path.join(args.outdir, "ring_1dev")
    with jax.profiler.trace(d3):
        t0 = time.perf_counter()
        out = all_pairs_presharded(planes_sharded, num_samples, mesh, rk,
                                   **ring_args)
        jax.block_until_ready(out.counts)
        dt = time.perf_counter() - t0
    print(f"ring 1-dev run: {dt*1e3:.1f} ms (traced)")
    report("ring sweep, 1 device, hitful", analyze(d3))
    return 0


if __name__ == "__main__":
    sys.exit(main())
