"""Whole runs of tiny copies of the cells on the CPU, past the harness's look for a card.

A tiny cell is the real cell's files with its traffic mix cut to a few
frames (``conftest.tiny_cell``).  These runs show the result line's shape,
that a cell added as files alone runs, and that the check's ``correct``
comes out false with the control or a fault in the program's place.
"""

import json
import subprocess
import sys
import time

import pytest

from conftest import BENCH_DIR, CHECKOUT, tiny_cell
from port_bench.lib.faults import FAULTS
from port_bench.lib.harness import run_cell

CELLS = sorted(p.stem for p in (BENCH_DIR / "workloads").glob("*.json"))
BIG_SEED = 2 ** 31 + 977


def run(root, cell, **kw):
    kw.setdefault("trace", False)
    return run_cell(cell, seed=kw.pop("seed", BIG_SEED), seconds=kw.pop("seconds", 0.05),
                    device="cpu", t_start=time.perf_counter(), root=root, **kw)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(bench_copy, cell, trace):
    result = run(bench_copy, f"tiny-{cell}", trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device on the CPU: a share of the device is left out, never 0
        assert not any(name.startswith("device_idle") for name in result["metrics"])
    else:
        assert "setup_s" in result["metrics"]
        for m in result["metrics"].values():
            assert m["value"] > 0 and m["unit"]
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(result)


def test_a_cell_added_as_files_alone_runs(bench_copy):
    name = tiny_cell(bench_copy, "ods20-combined-bulk", "added-pointcloud-20hz",
                     pipeline="pointcloud")
    result = run(bench_copy, name)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"}
    assert set(result["checks"]) == {"det_mismatch", "angle_mismatch"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(bench_copy, cell):
    result = run(bench_copy, f"tiny-{cell}", control=True)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_each_fault_is_not_correct(bench_copy, cell, fault):
    result = run(bench_copy, f"tiny-{cell}", fault=fault)
    assert result["correct"] is False, result["checks"]


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                           "ods20-combined-bulk", "--seed", str(BIG_SEED), "--seconds", "1",
                           "--trace", "0"], cwd=CHECKOUT, capture_output=True, text=True,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                               "HOME": str(CHECKOUT)}, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
