"""Run a worker script as ``world`` CPU processes over gloo, for the port's
process-mesh tests (``tests/test_torch_dist.py``,
``tests/test_torch_wire_dist.py``, ``tests/test_torch_cluster.py``), and a
command that starts processes of its own under one deadline
(:func:`run_group`: the cluster CLI, whose supervisor spawns workers).

Rank r runs ``python -c <worker> r world <init file> <tmp dir>`` and
rendezvouses through ``file://<tmp>/init``.  Its output goes to
``<tmp>/rank<r>.log``, a file rather than a pipe, so no rank can block on a
full pipe while the others wait for it in a collective, and what each rank
printed survives it.  Gloo binds the loopback interface
(``GLOO_SOCKET_IFNAME=lo``), so its rendezvous does not depend on how the
host's name resolves.  All ranks share one deadline (``deadline_s``,
:data:`DEADLINE_S` unless the caller sizes it to its run); a rank that exits
with an error ends the run at once (the others would wait for it in their
next collective until gloo's own 30-minute timeout).  A failed run says
whether the deadline passed or which rank failed first, and reports every
rank's exit code, run time (or that the harness killed it) and the tail of
its log.
"""
import os
import signal
import subprocess
import sys
import time

import pytest

DEADLINE_S = 600   # the whole run; alone it takes 5-20 s on a CPU
TAIL_LINES = 40


def run_ranks(worker, world, tmp_path, src, deadline_s=None):
    """Run ``worker`` as ``world`` ranks; return when all exited with 0,
    else fail the test with each rank's exit code and log tail."""
    deadline_s = DEADLINE_S if deadline_s is None else deadline_s
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
    first_failed = None          # the rank whose failure ended the run
    timed_out = False
    try:
        while True:
            if time.monotonic() - t0 >= deadline_s:
                timed_out = True
                break
            for r, p in enumerate(procs):
                if ended[r] is None and p.poll() is not None:
                    ended[r] = time.monotonic() - t0
                    if p.returncode != 0 and first_failed is None:
                        first_failed = r
            if all(e is not None for e in ended) or first_failed is not None:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if all(p.returncode == 0 for p in procs):
        return
    if timed_out:
        why, killed = (f"timed out after {deadline_s} s",
                       "killed at the deadline")
    else:
        why, killed = (f"rank {first_failed} failed first",
                       f"killed after rank {first_failed} failed")
    report = [f"gloo run of {world} ranks: {why}"]
    for r, p in enumerate(procs):
        tail = logs[r].read_text(errors="replace").splitlines()[-TAIL_LINES:]
        took = killed if ended[r] is None else f"after {ended[r]:.1f} s"
        report.append(f"--- rank {r}: exit code {p.returncode} ({took})")
        report.extend(tail)
    pytest.fail("\n".join(report), pytrace=False)


def run_group(cmd, env, timeout_s):
    """Run ``cmd`` in a session of its own and return its
    ``CompletedProcess`` (text output).  Past ``timeout_s`` the whole
    session is killed, the processes the command started among them, and
    the test fails with the output so far."""
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"{' '.join(cmd[:4])} ... timed out after {timeout_s} "
                    f"s (its session killed)\n--- stdout\n{out[-3000:]}"
                    f"\n--- stderr\n{err[-3000:]}", pytrace=False)
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)
