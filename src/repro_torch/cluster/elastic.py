"""Elastic supervisor (``repro.cluster.elastic``): detect a dead worker,
re-form over the survivors, resume.

Synchronous SGD has no partial-failure mode: one dead member wedges every
survivor inside the next collective (gloo waits for the missing peer).  So
the unit of recovery is the whole group: the supervisor detects the failure
(a process exit, seen by ``poll`` within one poll interval, or heartbeat
staleness for a wedged-but-alive group), kills the survivors, and relaunches
the SAME worker command at the smaller world size on a fresh rendezvous
port.  The relaunched workers re-plan the mesh and the bucket layout for
the new world size themselves (``MeshSpec(cluster=True)`` sizes the pod
axis from the live process group) and resume from the latest checkpoint:
``checkpoint.replan`` re-strips the zero1 optimizer state from the old
world's layout, so nothing is lost beyond the last checkpoint.  A change
of world size also deletes the run's ``comm="auto"`` plan cache
(``launcher.invalidate_autotune_cache``): its constants describe the old
topology.

The §3.4 update does not depend on G (the strip update equals the serial
optimizer's), so a run that loses a member mid-flight follows the same
trajectory as one launched at the surviving world size from the start; the
chaos test holds exactly that.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from repro_torch.cluster.launcher import (
    WorkerHandle,
    invalidate_autotune_cache,
    kill_workers,
    result_path,
    sigkill,
    spawn_workers,
)


@dataclass
class ChaosSpec:
    """Fault injection for the chaos harness: SIGKILL ``worker`` once its
    heartbeat reaches ``at_step`` (first attempt only — the point is to
    watch the recovery, not to kill the cluster forever)."""
    at_step: int
    worker: int = 1


@dataclass
class ElasticResult:
    """What the supervisor saw across a run's life."""
    final_world: int
    attempts: int
    result: Optional[dict]          # worker 0's result.json (final attempt)
    history: List[dict] = field(default_factory=list)


def _read_result(run_dir: str) -> Optional[dict]:
    try:
        with open(result_path(run_dir)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _failure(handles: Sequence[WorkerHandle], spawned_at: float,
             heartbeat_timeout: float) -> Optional[dict]:
    """None while the group is healthy; else {dead: [...], reason: str}."""
    dead = [h.process_id for h in handles
            if not h.alive() and h.proc.returncode != 0]
    if dead:
        return {"dead": dead, "reason": "exit"}
    # heartbeat fallback: every process alive, but someone stopped making
    # progress (wedged in a collective whose peer is gone, deadlock, ...).
    # WorkerHandle.staleness tracks payload-content change on the
    # supervisor's own monotonic clock (immune to wall-clock jumps; measured
    # from spawn until the first beat, so that the first step does not count
    # as a hang).
    now = time.monotonic()
    stale = []
    for h in handles:
        if not h.alive():   # clean exit (returncode 0): not a beat source
            continue
        if h.staleness(now, spawned_at) > heartbeat_timeout:
            stale.append(h.process_id)
    if stale and len(stale) == sum(h.alive() for h in handles):
        # only declare a hang when the WHOLE live group is stale —
        # synchronous SGD means one straggler stalls everyone, so a
        # genuine hang is always collective
        return {"dead": [], "reason": "heartbeat"}
    return None


def run_elastic(worker_argv: Sequence[str], run_dir: str,
                num_processes: int, local_devices: int = 1,
                max_restarts: int = 2,
                heartbeat_timeout: float = 120.0,
                poll_interval: float = 0.25,
                chaos: Optional[ChaosSpec] = None,
                grow_back: bool = False,
                log=print) -> ElasticResult:
    """Supervise ``worker_argv`` at ``num_processes`` of ``local_devices``
    members each, shrinking the world and relaunching on failure (at most
    ``max_restarts`` times).  A shrink drops processes and keeps each
    one's members and model ways.
    ``grow_back`` relaunches every failed attempt at the FULL
    ``num_processes`` instead of shrinking — the recovery policy for
    transient failures (preempted-then-returned hosts) rather than lost
    ones.

    Returns the :class:`ElasticResult` on success; raises ``RuntimeError``
    when the restart budget is exhausted or the final attempt fails.
    """
    world = num_processes
    history: List[dict] = []
    chaos_armed = chaos is not None
    for attempt in range(max_restarts + 1):
        log(f"[elastic] attempt {attempt}: world={world}")
        handles = spawn_workers(world, worker_argv, run_dir,
                                attempt=attempt,
                                local_devices=local_devices)
        spawned_at = time.monotonic()
        fail = None
        try:
            while True:
                if chaos_armed:
                    target = handles[min(chaos.worker, world - 1)]
                    hb = target.heartbeat()
                    if hb is not None and hb.step >= chaos.at_step:
                        log(f"[elastic] chaos: SIGKILL worker "
                            f"{target.process_id} at step {hb.step}")
                        sigkill(target)
                        chaos_armed = False
                if all(not h.alive() and h.proc.returncode == 0
                       for h in handles):
                    break   # clean group exit
                fail = _failure(handles, spawned_at, heartbeat_timeout)
                if fail is not None:
                    break
                time.sleep(poll_interval)
        finally:
            kill_workers(handles)
        if fail is None:
            res = _read_result(run_dir)
            history.append({"attempt": attempt, "world": world,
                            "outcome": "ok"})
            return ElasticResult(final_world=world, attempts=attempt + 1,
                                 result=res, history=history)
        # a negative code is the signal that ended the worker (-9: SIGKILL)
        codes = {h.process_id: h.proc.returncode for h in handles
                 if h.process_id in fail["dead"]}
        log(f"[elastic] attempt {attempt} failed: {fail['reason']} "
            f"(dead workers: {fail['dead'] or 'none detected'}; exit codes "
            f"{codes})")
        for h in handles:
            if h.process_id in fail["dead"] and h.log_file:
                tail = h.tail_log()
                if tail:
                    log(f"[elastic] -- worker {h.process_id} log tail --\n"
                        f"{tail}")
        history.append({"attempt": attempt, "world": world,
                        "outcome": fail["reason"], "dead": fail["dead"]})
        # re-form over the survivors (or back at full strength under
        # grow_back); a pure hang (no dead process) keeps the world size —
        # there is no one to exclude
        new_world = num_processes if grow_back \
            else max(1, world - len(fail["dead"]))
        if new_world != world and invalidate_autotune_cache(run_dir):
            log(f"[elastic] world {world} -> {new_world}: invalidated the "
                "stale autotune plan cache")
        world = new_world
    raise RuntimeError(
        f"elastic run failed after {max_restarts + 1} attempts: "
        f"{history}")
