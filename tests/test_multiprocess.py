"""True multi-process --distributed coverage: two OS processes, a real
jax.distributed coordinator, cross-process ring collectives, host-sharded
ingest, per-process output partitions (tools/multiprocess_smoke.py).

Everything else in the suite runs the multi-host code single-process ("all
devices local"); this is the one test where process_index() genuinely
differs between participants."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_smoke(extra=()):
    env = dict(os.environ)
    # The workers manage their own device counts / platform; scrub the
    # test-session forcing so subprocesses start clean.
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "multiprocess_smoke.py"),
         *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=570,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["multiprocess_smoke"] == "ok"
    assert result["pairs"] > 0
    return result


def test_two_process_distributed_cli():
    result = run_smoke()
    assert result["processes"] == 2 and result["devices"] == 8
    assert result["partitions"] == [
        "part-00000.snappy.parquet", "part-00001.snappy.parquet"
    ]


def test_three_process_odd_ring_distributed_cli():
    """Odd D = 9: the triangular ring has NO wrap step — a topology branch
    the even-D smoke never executes (VERDICT r2 #6a)."""
    result = run_smoke(["--num-processes", "3", "--devices-per-process", "3"])
    assert result["processes"] == 3 and result["devices"] == 9
    assert result["partitions"] == [
        f"part-{k:05d}.snappy.parquet" for k in range(3)
    ]


def test_distributed_split_factor_composition():
    """--distributed --split_factor 2 across two REAL processes: every
    shard's ranges host-sharded, swept by the offset-triangular or
    rectangular ring over the cross-process mesh, one partition per
    (shard, host); merged output bit-exact vs the oracle."""
    result = run_smoke(["--split-factor", "2"])
    assert result["split_factor"] == 2
    assert result["partitions"] == [
        f"part-{k:05d}.snappy.parquet" for k in range(6)
    ]


def test_skewed_overflow_cross_process_auto_retry():
    """A family cluster inside one device's row block + capacity 8 forces
    the overflow auto-retry across processes (VERDICT r2 #6b): every host
    must take the identical retry decision from the all-gathered counts
    (divergence desynchronizes the collective program and fails the run),
    and the merged output stays bit-exact vs the oracle."""
    result = run_smoke(["--skew"])
    assert result["skew"] is True
    assert result["pairs"] >= 28  # the cloned family alone
