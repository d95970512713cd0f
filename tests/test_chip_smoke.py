"""chip_smoke.py and bench.py on the CPU: both refuse to run without a GPU,
and chip_smoke's output checkers accept a correct engine sweep of a tiny
planted cohort and reject a wrong one."""

import os
import subprocess
import sys

import numpy as np
import pytest

from cuking_tpu.utils.device import NoGpuError, require_gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_cpu_only_run(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, script)],
                       capture_output=True, text=True, env=env, timeout=120,
                       cwd=REPO)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout and '"value"' not in r.stdout


def test_require_gpu_names_what_jax_found():
    with pytest.raises(NoGpuError, match="platform 'cpu'"):
        require_gpu()


@pytest.fixture(scope="module")
def tiny_sweep():
    """128 samples × 2,000 sites, 4 planted families of 4, panel 32."""
    storage, planes, layout = chip_smoke.build_cohort(
        128, 2000, families=4, members=4, panel=32, seed=5)
    results, _, _ = chip_smoke.engine_sweep(storage, repeats=1)
    return results, planes, layout


def test_checkers_accept_engine_sweep(tiny_sweep):
    results, planes, layout = tiny_sweep
    chip_smoke.check_hit_set(results, chip_smoke.planted_pairs(4, 4))
    with chip_smoke._pool() as pool:
        chip_smoke.check_rows_against_oracle(
            results, chip_smoke.plane_genotype_row(planes, layout), pool)
    assert len(results) == 4 * 6
    assert (results.kin == np.float32(0.5)).all()


def test_hit_checker_rejects_missing_pair(tiny_sweep):
    results, _, _ = tiny_sweep
    with pytest.raises(chip_smoke.PhaseError, match="1 missing"):
        chip_smoke.check_hit_set(
            results, chip_smoke.planted_pairs(4, 4) | {(100, 101)})


@pytest.mark.parametrize("field", ["kin", "ibs1"])
def test_row_checker_rejects_wrong_row(tiny_sweep, field):
    results, planes, layout = tiny_sweep
    import dataclasses

    bad = dataclasses.replace(results, **{field: getattr(results, field).copy()})
    col = getattr(bad, field)
    col[3] = np.nextafter(col[3], np.float32(1)) if field == "kin" else col[3] + 1
    with chip_smoke._pool() as pool, pytest.raises(
            chip_smoke.PhaseError, match="1 of 24 rows"):
        chip_smoke.check_rows_against_oracle(
            bad, chip_smoke.plane_genotype_row(planes, layout), pool)


def test_results_equal_is_byte_exact(tiny_sweep):
    import dataclasses

    results, _, _ = tiny_sweep
    assert chip_smoke.results_equal(results, dataclasses.replace(results))
    kin = results.kin.copy()
    kin[0] = -kin[0]
    assert not chip_smoke.results_equal(
        results, dataclasses.replace(results, kin=kin))


def test_phase_kernel_parity_tiny_slabs():
    """Phase 1's comparison on CPU at tiny widths (an off-diagonal and a
    diagonal slab, each with an all-missing sample)."""
    with chip_smoke._pool() as pool:
        chip_smoke.phase_kernel_parity(
            "cpu", pool, cases=((3000, 16, 24, False, 1), (5000, 16, 16, True, 2)))


def test_phase_cli_tiny_input():
    """Phase 3 on CPU: the golden fixture bit for bit and a small
    Hail-shaped input through the CLI against the oracle."""
    with chip_smoke._pool() as pool:
        chip_smoke.phase_cli("cpu", pool, n=64, sites=2000)
