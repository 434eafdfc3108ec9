"""The control and the planted faults, on a card at each cell's own size:
the reference computed in TF32 (the precision below the configuration's
f32 with TF32 off), half of each batch left out, and on a cell of several
chips the exchange between them left out (rank 0's rows alone), each in
the program's place, fail the cell's limits on three seeds.  The
benchmark's own runs do not run this; on the card:

    python3 -m pytest bench/tests/test_bench_control_gpu.py -m gpu
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from bench import check, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there, and the "
                    "control runs at the cell's own size")
    return torch.device("cuda")


def _kinds(w: dict) -> dict:
    batch = harness.find_cell(w["name"]).traffic["batch"]
    kinds = {"control_tf32": {"use_tf32": True},
             "half_batch": {"rows": batch // 2}}
    if w["chips"] > 1:
        kinds["exchange_left_out"] = {"rows": batch // w["chips"]}
    return kinds


@pytest.mark.gpu
@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_the_control_and_the_faults_are_not_correct(w, card):
    cell = harness.find_cell(w["name"])
    ref, cfg, opt = cell.family, cell.config, cell.config["optimizer"]
    B, pool = cell.traffic["batch"], cell.traffic["pool"]
    for seed in SEEDS:
        p0 = ref.init_params(cfg, seed, card)
        batches = ref.make_batches(cfg, B, pool, seed,
                                   card)[:check.CHECK_STEPS]
        want = check.reference_readings(ref.loss, cfg, p0, batches, opt)
        for kind, kw in _kinds(w).items():
            got = check.reference_readings(ref.loss, cfg, p0, batches, opt,
                                           **kw)
            checks = check.verdict(check.compare(got, want),
                                   cell.limits["limits"])
            assert not check.passes(checks), (kind, seed, checks)
