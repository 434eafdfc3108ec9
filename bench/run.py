"""The benchmark of the PyTorch / CUDA port (``repro_torch``), one run of
one cell::

    python3 bench/run.py --workload vgg_a.serial.b256 --seed 7 --seconds 30 \\
        --trace 0

from the root of a checkout.  It loads, warms up, measures for
``--seconds``, checks the first steps against the plain reference, and
prints the result as the last line of standard output (``harness``).  A
cell on four chips starts its four ranks itself, one process a card over
NCCL (the ``REPRO_*`` variables of ``repro_torch.cluster.spec`` and a
free rendezvous port); rank 0 prints the line.  Without a card (or with
fewer cards than the cell asks for) it exits with code 2 and prints no
result; it never runs on the CPU.
"""
import time

T0 = time.time()     # the run's start, before anything heavy is imported

import argparse  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# build and kernel caches at fixed paths inside the checkout (the port's
# own CUDA libraries are built into src/repro_torch/kernels/_build/)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, str(ROOT / ".bench_cache" / sub))
ENV_T0 = "BENCH_HARNESS_T0"      # the first process's start, for its ranks
RANK_DEADLINE_S = 1150           # a first run builds the kernels


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def finish(out) -> int:
    """Refuse a process that loaded JAX or the JAX package; else print the
    result (rank 0)."""
    from bench.harness import forbidden_modules, report
    bad = forbidden_modules()
    if bad:
        print(f"the benchmark's process loaded {bad}: no result",
              file=sys.stderr)
        return 3
    if out is not None:
        report(out)
    return 0


def _pin(rank: int, world: int) -> None:
    """Keep this rank's threads on its own share of the cores, so that the
    ranks' hosts do not take time from each other."""
    cores = sorted(os.sched_getaffinity(0))
    per = len(cores) // world
    if per:
        os.sched_setaffinity(0, cores[rank * per:(rank + 1) * per])


def worker(args) -> int:
    """One rank of a multi-chip cell, started by :func:`spawn`."""
    from repro_torch.cluster.spec import ClusterSpec, initialize
    spec = ClusterSpec.from_env()
    _pin(spec.process_id, spec.num_processes)

    from bench.harness import find_cell, run_rank
    cell = find_cell(args.workload)
    print(initialize(spec), file=sys.stderr)
    return finish(run_rank(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", float(os.environ[ENV_T0])))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(chips: int, script: str = __file__, argv=None) -> int:
    """Start ``script`` once a card (``argv``: this process's arguments),
    rank 0 on this process's standard output and error, the others into
    logs in a temporary directory; wait for all, ending the rest when one
    fails; print the others' log tails on a failure."""
    from repro_torch.cluster.spec import ClusterSpec
    logs = Path(tempfile.mkdtemp(prefix="bench-ranks-"))
    base = dict(os.environ, **ClusterSpec(
        coordinator=f"localhost:{_free_port()}", num_processes=chips).env())
    base[ENV_T0] = repr(T0)
    # one compute thread a rank, as torchrun sets it: a host busy issuing a
    # step is what the ranks wait on
    base.setdefault("OMP_NUM_THREADS", "1")
    procs, files = [], []
    for r in range(chips):
        env = dict(base, REPRO_PROCESS_ID=str(r))
        log = None if r == 0 else open(logs / f"rank{r}.log", "w")
        files.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(script).resolve()),
             *(sys.argv[1:] if argv is None else argv)],
            env=env, stdout=log, stderr=subprocess.STDOUT if log else None,
            start_new_session=True))

    def end_all(*_):
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
        for p in procs:
            p.wait()
    signal.signal(signal.SIGTERM, lambda *a: (end_all(), sys.exit(143)))
    deadline = time.time() + RANK_DEADLINE_S
    while True:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            break
        if any(c not in (None, 0) for c in codes) or time.time() > deadline:
            end_all()
            break
        time.sleep(0.2)
    codes = [p.returncode for p in procs]
    for f in files:
        if f is not None:
            f.close()
    if any(codes):
        print(f"rank exit codes {codes}", file=sys.stderr)
        for r in range(1, chips):
            tail = (logs / f"rank{r}.log").read_text()[-3000:]
            print(f"--- rank {r} ---\n{tail}", file=sys.stderr)
    for r in range(1, chips):
        (logs / f"rank{r}.log").unlink()
    logs.rmdir()
    return 1 if any(codes) else 0


def main(argv=None) -> int:
    args = parse(argv)
    if ENV_T0 in os.environ:
        return worker(args)
    from bench.harness import find_cell
    cell = find_cell(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s), this machine "
              f"has {have}: no result", file=sys.stderr)
        return 2
    if cell.chips > 1:
        return spawn(cell.chips)
    from bench.harness import run_rank
    return finish(run_rank(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T0))


if __name__ == "__main__":
    sys.exit(main())
