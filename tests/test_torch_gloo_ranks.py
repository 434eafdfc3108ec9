"""The report of the process-mesh tests' rank harness (``tests/_gloo_ranks.py``):
it says "timed out" only when the deadline passed, and otherwise names the
rank that failed first and marks the ranks it killed as killed after it."""
import pytest

import _gloo_ranks

# rank 1 fails at once; the others would run for a minute
WORKER = ("import sys, time\n"
          "sys.exit(3) if sys.argv[1] == '1' else time.sleep(60)\n")


def _report(tmp_path, world, worker):
    with pytest.raises(pytest.fail.Exception) as info:
        _gloo_ranks.run_ranks(worker, world, tmp_path, "")
    return str(info.value)


def test_report_names_the_rank_that_failed_first(tmp_path):
    report = _report(tmp_path, 3, WORKER)
    assert report.startswith("gloo run of 3 ranks: rank 1 failed first")
    assert "timed out" not in report
    assert "--- rank 1: exit code 3 (after " in report
    for r in (0, 2):
        assert f"--- rank {r}: exit code -9 (killed after rank 1 failed)" \
            in report


def test_report_says_timed_out_only_at_the_deadline(tmp_path, monkeypatch):
    monkeypatch.setattr(_gloo_ranks, "DEADLINE_S", 1)
    report = _report(tmp_path, 2, "import time; time.sleep(60)")
    assert report.startswith("gloo run of 2 ranks: timed out after 1 s")
    assert report.count("(killed at the deadline)") == 2
