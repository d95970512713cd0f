"""tools/capacity_plan.py: the multi-GPU planner must agree with the
runtime device-memory model (utils/hbm.py) it is derived from."""

from __future__ import annotations

import importlib
import json

import pytest

from cuking_tpu.parallel.ring import default_capacity_per_device
from cuking_tpu.utils.hbm import _worst_ring_shard_bytes

cp = importlib.import_module("tools.capacity_plan")
H100 = "NVIDIA H100 80GB HBM3"


def test_plan_fits_at_scale():
    plan = cp.build_plan(150_000, 1_000_000, H100, 64)
    assert plan["fits"] and plan["split_factor"] == 1
    assert plan["worst_shard_gib_per_chip"] < plan["chip_hbm_usable_gib"]
    assert plan["pairs_total"] == 150_000 * 149_999 // 2


def test_minimal_split_factor_is_minimal_and_sufficient():
    """The prescribed k fits the worst shard; k-1 must not."""
    samples, words, devices = 200_000, 31360, 4
    limit = 2 << 30  # artificially tight: forces k > 1
    k = cp.minimal_split_factor(samples, words, devices, limit)
    assert k is not None and k > 1
    capacity = default_capacity_per_device(10 << 20, devices)
    assert _worst_ring_shard_bytes(
        samples, k, words, 1024, devices, capacity, 10 << 20
    ) <= limit
    assert _worst_ring_shard_bytes(
        samples, k - 1, words, 1024, devices, capacity, 10 << 20
    ) > limit


def test_plan_reports_unfittable():
    # Hit buffers alone exceed a 1 MiB device: no split factor can help.
    plan = cp.build_plan(100_000, 1_000_000, H100, 2)
    assert plan["fits"]
    k = cp.minimal_split_factor(100_000, 31360, 2, 1 << 20)
    assert k is None


def test_rate_model_matches_measured_regimes():
    """The peak rate at the measured share reproduces the measured engine
    sweep at 100k sites (PERF.md: 246.0 M pairs/s on an H100) and scales
    with the padded site count to the 1M-site regime."""
    r100k = cp.pairs_per_sec_per_chip(H100, 100_000)
    r1m = cp.pairs_per_sec_per_chip(H100, 1_000_000)
    assert 240e6 < r100k < 252e6
    assert r1m == pytest.approx(
        r100k * cp.padded_words(100_000) / cp.padded_words(1_000_000))


def test_h100_entry_matches_data_sheet():
    """The H100 entry is keyed by the device_kind JAX reports and carries
    NVIDIA's published dense int8 peak and memory size."""
    spec = cp.device_spec(H100)
    assert spec == {"int8_tops": 1979e12, "hbm_bytes": 80 * 10**9}


def test_unknown_device_kind_is_an_error():
    with pytest.raises(ValueError, match="unknown device kind"):
        cp.build_plan(1000, 1000, "AMD Instinct MI300X", 1)
    with pytest.raises(SystemExit):
        cp.main(["--device-kind", "AMD Instinct MI300X"])


def test_cli_emits_json_line(capsys):
    rc = cp.main(["--samples", "120000", "--devices", "16"])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    plan = json.loads(line)
    assert plan["devices"] == 16 and plan["fits"]


def test_cli_unfittable_exit_code(capsys, monkeypatch):
    monkeypatch.setitem(
        cp.DEVICES, H100, {"int8_tops": 1979e12, "hbm_bytes": 64 << 20}
    )
    rc = cp.main(["--samples", "500000", "--devices", "2"])
    assert rc == 1
    plan = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert plan["fits"] is False
