"""The comparison that decides ``correct`` fails a broken program: each
fault a cell can have, planted in the program underneath a whole run (the
harness's look for a chip skipped: the CPU, smoke size)."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from bench.tests._smoke import run_ranks, run_smoke

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SERIAL = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]
MULTI = [w["name"] for w in BENCH["workloads"] if w["chips"] > 1]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", SERIAL)
def test_a_fault_in_a_serial_cell_is_not_correct(name, fault):
    out = run_smoke(name, fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_exchange"])
@pytest.mark.parametrize("name", MULTI)
def test_a_fault_in_a_multi_chip_cell_is_not_correct(name, fault, tmp_path):
    out, _ = run_ranks(name, 2, tmp_path, fault=fault)
    assert not out["correct"], out["checks"]
