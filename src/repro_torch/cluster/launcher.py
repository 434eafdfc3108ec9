"""Localhost multi-process launcher of the cluster subsystem
(``repro.cluster.launcher``).

Spawns N worker processes, each a fresh ``python -m
repro_torch.launch.cluster`` interpreter with the
:class:`~repro_torch.cluster.spec.ClusterSpec` variables set (and gloo on
the loopback interface, ``GLOO_SOCKET_IFNAME=lo``, unless the caller chose
one: the workers of a localhost cluster talk over it).  Worker 0 inherits
the launcher's stdout (live progress); the others write to log files in the
run directory, printed back on failure.

Liveness is tracked two ways, for ``cluster.elastic``:

  * the OS process itself (``Popen.poll``: a crash or a SIGKILL chaos
    injection shows within one poll interval);
  * a per-worker heartbeat file, written by a telemetry listener on the
    training loop's "step" span (``make_heartbeat_listener`` on
    ``run.telemetry``), which catches a worker that is alive but wedged in
    a collective whose peer died.

The heartbeat is JSON ``{"step": n, "mono": t}``: the step and the worker's
OWN monotonic time.  The supervisor never compares that time with its own
clock (monotonic clocks are not shared across processes); it tracks when the
payload last CHANGED on its own monotonic clock
(``WorkerHandle.staleness``), so that a wall-clock jump can neither fake
nor hide a stall.  A plain-int heartbeat file (step only) still parses and
falls back to the file's mtime.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional, Sequence

from repro_torch.cluster.spec import ClusterSpec
from repro_torch.telemetry.autotune import ENV_AUTOTUNE_CACHE

ENV_HEARTBEAT_FILE = "REPRO_HEARTBEAT_FILE"
ENV_RESULT_FILE = "REPRO_RESULT_FILE"


class Heartbeat(NamedTuple):
    """One parsed heartbeat: last completed step, the worker's own monotonic
    timestamp (None for legacy plain-int files), and the file mtime (the
    legacy fallback liveness signal)."""
    step: int
    mono: Optional[float]
    mtime: float


def write_heartbeat(path: str, step: int, mono: float) -> None:
    """Atomically publish a heartbeat (tmp + rename — a reader never sees a
    half-written payload)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps({"step": step, "mono": mono}))
    os.replace(tmp, path)


def parse_heartbeat(path: str) -> Optional[Heartbeat]:
    """Read ``path`` as a :class:`Heartbeat`; None before the first beat.
    Accepts both the JSON payload and the legacy bare-int format."""
    try:
        with open(path) as f:
            txt = f.read().strip()
        mtime = os.path.getmtime(path)
    except OSError:
        return None
    try:
        d = json.loads(txt or "0")
    except ValueError:
        return None
    if isinstance(d, dict):
        try:
            return Heartbeat(int(d["step"]), float(d["mono"]), mtime)
        except (KeyError, TypeError, ValueError):
            return None
    if isinstance(d, (int, float)):
        return Heartbeat(int(d), None, mtime)
    return None


def make_heartbeat_listener(path: str) -> Callable[[dict], None]:
    """A telemetry listener that beats ``path`` on every completed "step"
    span — attach to ``run.telemetry.add_listener``.  The beat carries the
    span's end timestamp (``t1``, the worker's monotonic clock) and step."""
    def listener(ev: dict) -> None:
        if ev.get("kind") == "step" and ev.get("ph") == "span":
            try:
                write_heartbeat(path, int(ev.get("step", 0)),
                                float(ev["t1"]))
            except OSError:
                pass   # a failed beat must never kill the training step
    return listener


def free_port() -> int:
    """An OS-assigned free TCP port for the coordinator (bind-to-0 probe)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@dataclass
class WorkerHandle:
    """One spawned worker: its process, identity, and liveness files."""
    proc: subprocess.Popen
    process_id: int
    hb_file: str
    log_file: Optional[str]
    _seen_beat: Optional[tuple] = None   # last observed (step, mono) payload
    _seen_at: Optional[float] = None     # SUPERVISOR monotonic time of that
    #                                      observation — staleness compares
    #                                      like-with-like on one clock

    def heartbeat(self) -> Optional[Heartbeat]:
        """The worker's last published :class:`Heartbeat`, or None before
        the first beat."""
        return parse_heartbeat(self.hb_file)

    def staleness(self, now: float, spawned_at: float) -> float:
        """Seconds since this worker last demonstrably made progress, as of
        supervisor-monotonic ``now``.  New-format beats are judged by when
        their (step, mono) payload last CHANGED on the supervisor's own
        clock — immune to NTP wall-clock jumps on either side.  Legacy
        bare-int files fall back to the mtime comparison (wall clock
        offset-corrected).  Never negative; measured from ``spawned_at``
        until the first beat, so that the first step (kernel builds) does
        not count as a hang."""
        hb = self.heartbeat()
        if hb is None:
            return max(0.0, now - spawned_at)
        if hb.mono is not None:
            beat = (hb.step, hb.mono)
            if beat != self._seen_beat:
                self._seen_beat = beat
                self._seen_at = now
            return max(0.0, now - max(spawned_at, self._seen_at))
        # legacy path: hb files carry wall-clock mtimes
        wall_off = time.time() - now
        return max(0.0, now - max(spawned_at, hb.mtime - wall_off))

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self, grace: float = 3.0) -> None:
        """Terminate (then SIGKILL) this worker and reap it."""
        if self.proc.poll() is not None:
            return
        self.proc.terminate()
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline and self.proc.poll() is None:
            time.sleep(0.05)
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()

    def tail_log(self, nbytes: int = 4000) -> str:
        if not self.log_file or not os.path.exists(self.log_file):
            return ""
        with open(self.log_file, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - nbytes))
            return f.read().decode(errors="replace")


def _worker_env(spec: ClusterSpec, hb_file: str,
                result_file: Optional[str],
                run_dir: Optional[str] = None) -> dict:
    env = dict(os.environ)
    env.update(spec.env())
    env[ENV_HEARTBEAT_FILE] = hb_file
    if result_file:
        env[ENV_RESULT_FILE] = result_file
    if run_dir:
        # every worker shares one comm="auto" plan cache a run; a relaunch
        # at the same topology skips the probes (telemetry.autotune)
        env[ENV_AUTOTUNE_CACHE] = autotune_cache_path(run_dir)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    return env


def result_path(run_dir: str) -> str:
    return os.path.join(run_dir, "result.json")


def autotune_cache_path(run_dir: str) -> str:
    return os.path.join(run_dir, "autotune_cache.json")


def invalidate_autotune_cache(run_dir: str) -> bool:
    """Drop the persisted comm="auto" plan (True if one was removed): the
    elastic supervisor calls it whenever the world size changes, since the
    cached constants describe the old topology."""
    try:
        os.remove(autotune_cache_path(run_dir))
        return True
    except OSError:
        return False


def spawn_workers(num_processes: int, worker_argv: Sequence[str],
                  run_dir: str, attempt: int = 0,
                  local_devices: int = 1,
                  coordinator: Optional[str] = None,
                  ) -> List[WorkerHandle]:
    """Spawn ``num_processes`` workers of ``python -m
    repro_torch.launch.cluster <worker_argv>``, ``local_devices`` members
    each, and return their handles.  ``attempt`` namespaces the heartbeat
    files so a relaunched cluster never reads a dead generation's beats."""
    os.makedirs(run_dir, exist_ok=True)
    coordinator = coordinator or f"localhost:{free_port()}"
    handles: List[WorkerHandle] = []
    for pid in range(num_processes):
        spec = ClusterSpec(coordinator=coordinator,
                           num_processes=num_processes,
                           process_id=pid, local_devices=local_devices)
        hb = os.path.join(run_dir, f"hb_a{attempt}_w{pid}")
        env = _worker_env(spec, hb,
                          result_path(run_dir) if pid == 0 else None,
                          run_dir)
        log = None
        out = None
        if pid != 0:
            # worker 0 narrates to the launcher's stdout; the rest log to
            # files (printed back on failure)
            log = os.path.join(run_dir, f"worker_a{attempt}_w{pid}.log")
            out = open(log, "wb")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.cluster"]
            + list(worker_argv),
            env=env, stdout=out, stderr=subprocess.STDOUT if out else None)
        if out is not None:
            out.close()   # the child owns the fd now
        handles.append(WorkerHandle(proc=proc, process_id=pid,
                                    hb_file=hb, log_file=log))
    return handles


def kill_workers(handles: Sequence[WorkerHandle]) -> None:
    for h in handles:
        h.kill()


def sigkill(handle: WorkerHandle) -> None:
    """Hard-kill one worker (the chaos injection: no cleanup, no goodbye —
    exactly what a node loss looks like to the rest of the cluster)."""
    if handle.proc.poll() is None:
        handle.proc.send_signal(signal.SIGKILL)
