"""Where a benchmark cell's train step spends the card's time, by the
port's own spans (``forward``, ``backward``, ``clip``, ``update`` and the
§3.4 update's ``reduce``, ``apply``, ``broadcast``).

    python3 tools/phase_split.py --workload cd_dnn.serial.b1024 --seed 7 \\
        --out phases/

The cell of ``BENCHMARK.json`` is set up as ``bench/run.py`` sets it up
(``bench.harness.build_run``, the reference's parameters and a pool of
batches from ``--seed``, three warm steps).  Then:

- the host's cost of one span of the run's recorder, entered and left,
  with no profiler, under one of the device's activity alone, and under
  one that traces the host's ops too;
- ``ROUNDS`` rounds of ``bench.harness.TRACE_STEPS`` steps each: timed
  with CUDA events and no profiler; under ``torch.profiler`` with device
  activity alone (the stretch's time and busy seconds); and with the
  host's ops too, reduced by ``bench.trace.summarize`` (the classes and
  the breakdown) and ``bench.spans.summarize`` (device ms a step by span,
  the launches and the synchronizing calls inside ``step``).

``--src DIR`` imports the program from another tree's ``src`` (a parent
commit's, to time the stretches without the spans).  A four-card cell
starts a process a card as ``bench/run.py`` does.  Each rank writes
``<out>/<workload>.<change|parent>.<seed>.r<rank>.json``; rank 0 prints a
summary line.  Needs the cell's cards; prints the card's name and power
limit first.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench import run as bench_run  # noqa: E402  (puts src/ on the path)

ROUNDS = 3
SPAN_REPS = 20000


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--src", default=None)
    ap.add_argument("--out", required=True)
    return ap.parse_args(argv)


def span_cost_us(rec) -> dict:
    """Host us of one ``rec.span`` entered and left: no profiler, under a
    profiler of the device's activity alone, and of the host's ops too."""
    from torch.profiler import ProfilerActivity, profile

    def loop():
        t = time.perf_counter()
        for _ in range(SPAN_REPS):
            with rec.span("cost"):
                pass
        return (time.perf_counter() - t) / SPAN_REPS * 1e6
    out = {"off": loop()}
    for name, acts in (("device_only", [ProfilerActivity.CUDA]),
                       ("profiled", [ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])):
        with profile(activities=acts):
            out[name] = loop()
    return out


def one_round(run, pool, k, n, dev):
    """The three stretches of a round (module docstring), from step ``k``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from bench import spans, trace

    def batch(j):
        return pool[(k + j) % len(pool)]

    torch.cuda.synchronize(dev)
    marks = [torch.cuda.Event(enable_timing=True)]
    marks[0].record()
    for j in range(n):
        run.step(batch(j), k + j)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    torch.cuda.synchronize(dev)
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    k += n

    def stretch(acts):
        nonlocal k
        with profile(activities=acts) as prof:
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            for j in range(n):
                with record_function(trace.STEP_SPAN):
                    run.step(batch(j), k + j)
            torch.cuda.synchronize(dev)
            window_s = time.perf_counter() - t
        k += n
        return prof.events(), window_s

    lean, lean_s = stretch([ProfilerActivity.CUDA])
    full, full_s = stretch([ProfilerActivity.CPU, ProfilerActivity.CUDA])
    t = trace.summarize(full, n, lean, lean_s)
    s = spans.summarize(full, n)
    per = lambda x: x / n * 1e3  # noqa: E731   s -> ms a step
    return k, {
        "step_ms_median": statistics.median(step_ms),
        "lean_ms_per_step": per(lean_s), "busy_ms_per_step": per(t.busy_s),
        "idle_share": 100.0 * (1.0 - t.busy_s / lean_s),
        "full_ms_per_step": per(full_s),
        "class_ms": {c: per(v) for c, v in sorted(t.class_s.items())},
        "idle_gaps": t.idle_gaps, "device_ops": t.device_ops,
        "span_count": s.count,
        "span_ms": {c: per(v) for c, v in sorted(s.device_s.items())},
        "update_ms": s.ms_per_step(*spans.UPDATE),
        "outside_ms": per(s.outside_s), "unmatched_ms": per(s.unmatched_s),
        "device_ms": per(s.total_s),
        "launches_per_step": s.launches_per_step(),
        "step_sync_ms": s.sync_ms_per_step(),
        "sync_ms_by_span": {c: per(v) for c, v in sorted(s.sync_s.items())},
    }


def rank_main(args) -> int:
    import torch
    import torch.distributed as dist

    from bench.harness import TRACE_STEPS, build_run, find_cell
    cell = find_cell(args.workload)
    label = "parent" if args.src else "change"
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    run = build_run(cell, None if world > 1 else torch.device("cuda"))
    dev = run.device
    ref, cfg = cell.family, cell.config
    B, pool_n = cell.traffic["batch"], cell.traffic["pool"]
    lo, hi = rank * B // world, (rank + 1) * B // world
    run.load_params(ref.init_params(cfg, args.seed, dev))
    pool = [{k: v[lo:hi].contiguous() for k, v in b.items()}
            for b in ref.make_batches(cfg, B, pool_n, args.seed, dev)]
    for k in range(3):
        run.step(pool[k % pool_n], k)
    out = {"workload": args.workload, "label": label, "rank": rank,
           "world": world, "seed": args.seed, "steps": TRACE_STEPS,
           "torch": torch.__version__, "card": torch.cuda.get_device_name(dev),
           "span_cost_us": span_cost_us(run.telemetry), "rounds": []}
    k = 3
    for _ in range(ROUNDS):
        k, r = one_round(run, pool, k, TRACE_STEPS, dev)
        out["rounds"].append(r)
    path = Path(args.out) / f"{args.workload}.{label}.{args.seed}.r{rank}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    if rank == 0:
        keys = ("step_ms_median", "lean_ms_per_step", "full_ms_per_step",
                "idle_share", "update_ms", "launches_per_step",
                "step_sync_ms")
        brief = {key: [r[key] for r in out["rounds"]] for key in keys}
        brief["span_ms"] = out["rounds"][-1]["span_ms"]
        brief["comm_ms"] = [r["class_ms"].get("comm")
                            for r in out["rounds"]]
        print(json.dumps({"workload": args.workload, "label": label,
                          "span_cost_us": out["span_cost_us"], **brief}),
              flush=True)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    if args.src:
        sys.path.insert(0, str(Path(args.src).resolve()))
    if bench_run.ENV_T0 in os.environ:
        from repro_torch.cluster.spec import ClusterSpec, initialize
        spec = ClusterSpec.from_env()
        bench_run._pin(spec.process_id, spec.num_processes)
        initialize(spec)
        return rank_main(args)
    from bench.harness import find_cell
    chips = find_cell(args.workload).chips
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if chips > 1:
        return bench_run.spawn(chips, script=__file__)
    return rank_main(args)


if __name__ == "__main__":
    sys.exit(main())
