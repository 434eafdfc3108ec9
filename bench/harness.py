"""One rank's run of a cell: set-up, the measured window, the traced
stretch, and the comparison with the plain reference.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by the name ``BENCHMARK.json`` gives it:
``bench/configs/<config>.json`` (its ``family`` names the plain reference
``bench/configs/<family>.py`` and the program's form of the sizes
``bench/configs/<family>_port.py``), ``bench/traffic/<traffic>.json``,
``bench/limits/<workload>.json`` and ``bench/metrics/<metric>.py``.

The order of a run:

1. set-up: the port's run (``compile_run`` with the forward on the port's
   kernel, ``use_kernel``), the initial parameters and a pool of distinct
   batches made on the card from the seed; the parameters handed to the
   run (``Run.load_params``); the first three steps through ``Run.step``
   on three different batches, which build and warm every kernel and give
   the readings the reference checks;
2. the window: ``Run.step`` on the pool, in turn, until ``seconds`` have
   passed on the host clock (on several ranks, rank 0's clock decides,
   over a gloo group of the benchmark's own); a CUDA event after every
   step, read after the window, so that nothing waits inside it; the
   window ends on a device sync;
3. with ``trace``: bursts of steps issued right after a sync (the host's
   cost to issue a step, unblocked by a full launch queue), then a
   stretch of steps under ``torch.profiler``;
4. the peak memory; the program's state freed; on rank 0 the reference's
   three steps from the same parameters on the same batches (``check``).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
BURSTS, BURST_STEPS = 8, 2       # host cost of a step: steps after a sync
TRACE_STEPS = 20                 # the profiled stretch
STOP_EVERY = 4                   # window steps between the ranks' agreements


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    family: object          # the plain reference
    port: object            # the program's form of the configuration
    end_to_end: list        # the metric entries this cell reports
    per_layer: list         # (metric entry, reader module)


def _applies(metric: dict, name: str) -> bool:
    return name in metric.get("workloads", [name])


def find_cell(name: str, bench: dict = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``)."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; it has "
                         f"{sorted(by_name)}")
    w = by_name[name]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    fam = config["family"]
    return Cell(
        name=name, chips=w["chips"], config=config,
        traffic=json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        limits=json.loads((BENCH / "limits" / f"{name}.json").read_text()),
        family=load_module(BENCH / "configs" / f"{fam}.py",
                           f"bench_reference_{fam}"),
        port=load_module(BENCH / "configs" / f"{fam}_port.py",
                         f"bench_port_{fam}"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[(m, load_module(BENCH / "metrics" / f"{m['name']}.py",
                                   f"bench_metric_{m['name']}"))
                   for m in bench["per_layer"] if _applies(m, name)])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def build_run(cell: Cell, device):
    """The port's run of the cell: ``compile_run`` of the configuration
    file's sizes, the family's momentum SGD at the file's rate, a constant
    schedule and the file's clip, serial or zero1 over the ranks of the
    live process group (``MeshSpec(cluster=True)``, the cluster's default
    comm); the forward on the port's kernel (``use_kernel``).  On a card
    ``compile_run`` holds f32 (TF32 off)."""
    from repro_torch.api import MeshSpec, RunSpec, compile_run
    from repro_torch.api.assemble import default_comm
    from repro_torch.launch.paper_cnn_training import use_kernel
    opt, t = cell.config["optimizer"], cell.traffic
    cluster = t["parallel"] != "serial"
    spec = RunSpec(
        arch=cell.port.port_config(cell.config), parallel=t["parallel"],
        mesh=MeshSpec(cluster=cluster),
        comm=default_comm(t["parallel"], cluster=True) if cluster else None,
        optimizer="sgd", lr=opt["lr"], momentum=opt["momentum"],
        weight_decay=opt["weight_decay"], schedule=opt["schedule"],
        grad_clip=opt["grad_clip"], batch=t["batch"], steps=10 ** 9)
    return use_kernel(compile_run(spec, device=device))


class Clock:
    """Marks on the device's timeline: CUDA events on a card, the host
    clock after a wait elsewhere (the CPU tests)."""

    def __init__(self, device):
        import torch
        self.torch, self.cuda = torch, device.type == "cuda"
        self.device = device

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def gaps_ms(self, marks: list) -> list:
        """ms between consecutive marks (after ``sync``)."""
        if not self.cuda:
            return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


class Group:
    """The ranks' host-side agreement, over a gloo group of the
    benchmark's own (nothing waits for the card): whether the window has
    ended, and every rank's numbers for rank 0 to report."""

    def __init__(self):
        import torch.distributed as dist
        self.dist = dist
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.pg = dist.new_group(backend="gloo") if self.world > 1 else None
        self.asked = 0

    def done(self, t0: float, seconds: float) -> bool:
        """True once ``seconds`` have passed since ``t0`` on rank 0; on
        several ranks asked of rank 0 every ``STOP_EVERY`` calls only, so
        that the ranks' hosts wait for rank 0's no oftener."""
        over = float(time.perf_counter() - t0 >= seconds)
        if self.world == 1:
            return bool(over)
        self.asked += 1
        if self.asked % STOP_EVERY:
            return False
        import torch
        t = torch.tensor([over])
        self.dist.broadcast(t, src=0, group=self.pg)
        return bool(t.item())

    def gather(self, values: list) -> list:
        """Every rank's ``values`` (floats, as many on each), by rank."""
        import torch
        if self.world == 1:
            return [values]
        out = [torch.zeros(len(values), dtype=torch.float64)
               for _ in range(self.world)]
        self.dist.all_gather(out, torch.tensor(values, dtype=torch.float64),
                             group=self.pg)
        return [o.tolist() for o in out]

    def close(self):
        if self.world > 1:
            self.dist.destroy_process_group()


def _rows(batches: list, lo: int, hi: int) -> list:
    return [{k: v[lo:hi].contiguous() for k, v in b.items()} for b in batches]


def first_steps(run, pool: list, p0: dict, lr: float):
    """The run's first ``check.CHECK_STEPS`` steps through ``Run.step`` on
    distinct batches of ``pool``, from the parameters ``p0`` it was
    handed; their ``check.Readings``."""
    from bench import check
    losses = []
    for k in range(check.CHECK_STEPS):
        losses.append(run.step(pool[k % len(pool)], k)["loss"])
        if k == 0:
            grad = check.leaf_norms(run.full_params(), p0, 1.0 / lr)
    return check.Readings([float(x) for x in losses], grad,
                          check.leaf_norms(run.full_params(), p0))


def run_rank(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, log=print) -> dict:
    """This rank's part of one run (module docstring).  ``t0``: the
    wall-clock time the run's first process started.  Returns the result
    line's object on rank 0, None on the others.  ``device``: "cuda" (a
    card a rank, as ``launch.mesh`` places them) or "cpu" (the tests)."""
    import torch

    from bench import check, flops

    group = Group()
    clock_dev = torch.device(device)
    run = build_run(cell, None if clock_dev.type == "cuda" and group.world > 1
                    else clock_dev)
    dev = run.device
    clock = Clock(dev)
    stage = lambda what: log(f"rank {group.rank}: {what} at "  # noqa: E731
                             f"{time.time() - t0:.3f} s", file=sys.stderr)
    stage("run built")
    ref, cfg, opt = cell.family, cell.config, cell.config["optimizer"]
    B, pool_n = cell.traffic["batch"], cell.traffic["pool"]
    lo, hi = group.rank * B // group.world, (group.rank + 1) * B // group.world

    # -- set-up: parameters and the pool from the seed, the first steps
    p0 = ref.init_params(cfg, seed, dev)
    if sorted(p0) != sorted(run.full_params()):
        raise RuntimeError(f"the reference's leaves {sorted(p0)} are not the "
                           f"program's {sorted(run.full_params())}")
    run.load_params(p0)
    pool = _rows(ref.make_batches(cfg, B, pool_n, seed, dev), lo, hi)
    stage("parameters and batches made")
    got = first_steps(run, pool, p0, opt["lr"])
    del p0
    stage("first steps done")
    k = check.CHECK_STEPS

    # -- the window
    clock.sync()
    t_win = time.perf_counter()
    setup_s = time.time() - t0
    marks, window_losses, issue_ms = [clock.mark()], [], []
    while not group.done(t_win, seconds):
        h = time.perf_counter()
        window_losses.append(run.step(pool[k % pool_n], k)["loss"])
        issue_ms.append((time.perf_counter() - h) * 1e3)
        marks.append(clock.mark())
        k += 1
    clock.sync()
    wall_s = time.perf_counter() - t_win
    step_ms = clock.gaps_ms(marks)
    steps = len(step_ms)
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum()) \
        if window_losses else 0
    log(f"rank {group.rank}: {steps} steps in {wall_s:.3f} s, set-up "
        f"{setup_s:.3f} s", file=sys.stderr)
    for r, row in enumerate(group.gather(_tail(step_ms) + _tail(issue_ms))):
        log(f"rank {r}: window step ms median {row[0]:.3f} max {row[1]:.3f}, "
            f"{row[2]:.0f} over 1.5x the median; host ms a step median "
            f"{row[3]:.3f} max {row[4]:.3f}", file=sys.stderr)

    obs = {"cell": cell, "batch": B, "rows": hi - lo, "chips": group.world,
           "steps": steps, "wall_s": wall_s, "step_ms": step_ms,
           "setup_s": setup_s, "flops": flops}
    summary = None
    if trace:
        host_ms = []
        for _ in range(BURSTS):
            clock.sync()
            for _ in range(BURST_STEPS):
                h = time.perf_counter()
                run.step(pool[k % pool_n], k)
                host_ms.append((time.perf_counter() - h) * 1e3)
                k += 1
        obs["host_ms"] = host_ms
        summary = _profile(run, pool, k, clock)
        obs["trace"] = summary
    peak = float(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0.0
    ranks = group.gather([peak] + ([summary.busy_s, summary.window_s]
                                   if summary else []))
    peak = max(r[0] for r in ranks)             # the fullest card's
    if summary:                                 # the cards' mean
        busy, window = (statistics.fmean(r[i] for r in ranks) for i in (1, 2))
    del run, pool, window_losses, marks
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    group.close()
    if group.rank != 0:
        return None

    # -- the reference, once the program's state is freed
    p0 = ref.init_params(cfg, seed, dev)
    batches = ref.make_batches(cfg, B, pool_n, seed, dev)[:check.CHECK_STEPS]
    want = check.reference_readings(ref.loss, cfg, p0, batches, opt)
    del p0, batches
    checks = check.verdict(check.compare(got, want), cell.limits["limits"])

    metrics = {}
    if trace:
        for entry, reader in cell.per_layer:
            value = reader.read(obs)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
    else:
        metrics = {m["name"]: {"value": E2E[m["name"]](obs), "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": group.world, "memory_peak_bytes": int(peak)}
    out = {"correct": check.passes(checks) and failed == 0,
           "attempted": steps, "failed": failed, "metrics": metrics,
           "device": device_info}
    if trace:
        device_info.update(busy_s=busy, window_s=window)
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
    out["checks"] = checks
    return out


def _profile(run, pool, k, clock):
    """``TRACE_STEPS`` steps under ``torch.profiler`` with device activity
    alone, for the seconds in which an operation ran on the card (the
    host's profiling would slow a step the host sets); then as many with
    the host's ops too, for the classes and the breakdown, which need the
    op that launched each kernel.  ``trace.summarize`` of both."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from bench.trace import STEP_SPAN, summarize

    def stretch(acts, k):
        with profile(activities=acts) as prof:
            clock.sync()
            t = time.perf_counter()
            for j in range(TRACE_STEPS):
                with record_function(STEP_SPAN):
                    run.step(pool[(k + j) % len(pool)], k + j)
            clock.sync()
            window_s = time.perf_counter() - t
        return prof.events(), window_s

    device = [ProfilerActivity.CUDA] if clock.cuda else []
    lean = stretch(device, k) if device else ([], 0.0)
    full = stretch([ProfilerActivity.CPU] + device, k + TRACE_STEPS)
    return summarize(full[0], TRACE_STEPS, *lean)


def _tail(ms: list) -> list:
    """[median, max, count over 1.5x the median] of ``ms``."""
    med = statistics.median(ms)
    return [med, max(ms), float(sum(x > 1.5 * med for x in ms))]


def _p90(values: list) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[8]


# the end-to-end metrics, all taken here from the host clock and the
# window's CUDA events (``BENCHMARK.json``'s ``end_to_end``)
E2E = {
    "samples_per_s": lambda o: o["steps"] * o["batch"] / o["wall_s"],
    "step_ms_p90": lambda o: _p90(o["step_ms"]),
    "setup_s": lambda o: o["setup_s"],
}


def report(out: dict, log=print) -> None:
    """The numbers compared beside their limits as the last lines of
    standard error, then the result as the last line of standard output."""
    log(f"correct {out['correct']}, {out['failed']} of {out['attempted']} "
        "window steps with a loss that is not finite", file=sys.stderr)
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}",
            file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
