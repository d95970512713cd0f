"""tools/trace_report.py's reduction from device events to the numbers
PERF.md quotes, on hand-made events (a CPU trace has no GPU planes)."""

import importlib

import pytest

tr = importlib.import_module("tools.trace_report")

EVENTS = {
    "/device:GPU:0": [
        ("sm90_xmma_gemm_i8i32_i8i32_i32_tn_n", 0, 100),
        ("input_concatenate_fusion", 50, 150),  # overlaps the GEMM
        ("ncclDevKernel_SendRecv", 120, 220),   # 30 of 100 ns under compute
        ("wrapped_add", 300, 400),
    ],
    "/device:GPU:1": [("memcpy128", 0, 10), ("wrapped_add", 10, 20)],
}


@pytest.fixture
def events(monkeypatch):
    monkeypatch.setattr(tr, "_device_events", lambda trace_dir: EVENTS)


def test_analyze_busy_idle_and_categories(events):
    stats = tr.analyze("unused")
    # GPU:0 busy = union [0, 220) + [300, 400) = 320 of a 400 span;
    # GPU:1 busy 20 of 20.
    assert stats["busy_ms"] == pytest.approx(340 / 1e6)
    assert stats["span_ms"] == pytest.approx(420 / 1e6)
    assert stats["idle_share"] == pytest.approx(1 - 340 / 420)
    cats = stats["by_category_ms"]
    assert cats["int8 GEMM (cuBLAS)"] == pytest.approx(100 / 1e6)
    assert cats["collective (NCCL)"] == pytest.approx(100 / 1e6)
    assert cats["fusion (unpack/accumulate/epilogue)"] == pytest.approx(210 / 1e6)
    assert cats["memcpy/memset"] == pytest.approx(10 / 1e6)
    assert stats["top_ops_ms"][0] == ("wrapped_add", pytest.approx(110 / 1e6))


def test_ppermute_overlap_counts_same_card_compute_only(events):
    got = tr.ppermute_overlap("unused")
    assert got["num_events"] == 1
    assert got["collective_ms"] == pytest.approx(100 / 1e6)
    assert got["overlapped_ms"] == pytest.approx(30 / 1e6)
    assert got["overlap_fraction"] == pytest.approx(0.3)
