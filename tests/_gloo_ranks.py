"""Run a worker script as ``world`` CPU processes over gloo, for the port's
process-mesh tests (``tests/test_torch_dist.py``,
``tests/test_torch_wire_dist.py``).

Rank r runs ``python -c <worker> r world <init file> <tmp dir>`` and
rendezvouses through ``file://<tmp>/init``.  Its output goes to
``<tmp>/rank<r>.log``, a file rather than a pipe, so no rank can block on a
full pipe while the others wait for it in a collective, and what each rank
printed survives it.  Gloo binds the loopback interface
(``GLOO_SOCKET_IFNAME=lo``), so its rendezvous does not depend on how the
host's name resolves.  All ranks share one deadline; a rank that exits
with an error ends the run at once (the others would wait for it in their
next collective until gloo's own 30-minute timeout).  A failed run reports
every rank's exit code, run time and the tail of its log.
"""
import os
import subprocess
import sys
import time

import pytest

DEADLINE_S = 600   # the whole run; alone it takes 5-20 s on a CPU
TAIL_LINES = 40


def run_ranks(worker, world, tmp_path, src):
    """Run ``worker`` as ``world`` ranks; return when all exited with 0,
    else fail the test with each rank's exit code and log tail."""
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    logs = [tmp_path / f"rank{r}.log" for r in range(world)]
    t0 = time.monotonic()
    procs = []
    for r in range(world):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", worker, str(r), str(world),
                 str(tmp_path / "init"), str(tmp_path)],
                env=env, stdout=f, stderr=subprocess.STDOUT))
    ended = [None] * world
    try:
        while time.monotonic() - t0 < DEADLINE_S:
            for r, p in enumerate(procs):
                if ended[r] is None and p.poll() is not None:
                    ended[r] = time.monotonic() - t0
            if all(e is not None for e in ended) or any(
                    p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if all(p.returncode == 0 for p in procs):
        return
    why = (f"timed out after {DEADLINE_S} s" if any(e is None for e in ended)
           else "a rank failed")
    report = [f"gloo run of {world} ranks: {why}"]
    for r, p in enumerate(procs):
        tail = logs[r].read_text(errors="replace").splitlines()[-TAIL_LINES:]
        took = "killed" if ended[r] is None else f"after {ended[r]:.1f} s"
        report.append(f"--- rank {r}: exit code {p.returncode} ({took})")
        report.extend(tail)
    pytest.fail("\n".join(report), pytrace=False)
