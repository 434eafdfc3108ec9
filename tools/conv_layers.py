"""The conv kernel's device time in a benchmark cell's train step, layer by
layer.

    python3 tools/conv_layers.py --workload vgg_a.serial.b256 --seed 7

The one-card cell of ``BENCHMARK.json`` is set up as ``bench/run.py`` sets
it up (``bench.harness.build_run``, the reference's parameters and a pool
of batches from ``--seed``, three warm steps); then ``--steps`` steps run
under ``torch.profiler`` with the device's activity alone.  Every device
operation whose name holds ``conv2d_nhwc_kernel`` (the ``conv_kernel``
class of ``bench/kernels.json``) is taken in launch order, a weight split
with the launch that follows it, which gives each step's forward convs in
the model's order.  Prints, as one JSON line, the device ms a step of each
conv (its launches' names and their ms), their sum, and the wrapper's
launch counters over the profiled steps (``launches_ws`` null where the
program has none).  ``--src DIR`` imports the program from another tree's
``src`` (a parent commit's).  Needs one card; prints its name and power
limit first.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench import run as bench_run  # noqa: E402,F401  (puts src/ on the path)

KERNEL = "conv2d_nhwc_kernel"
SPLIT = "split_w"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--src", default=None)
    return ap.parse_args(argv)


def layers(names_us, steps):
    """[(names, us)] of each conv call of the profiled stretch, a weight
    split joined to the launch after it, split into ``steps`` equal steps:
    per step the list of (names, us)."""
    calls, pending = [], None
    for name, us in names_us:
        if SPLIT in name:
            pending = (name, us)
            continue
        names, total = [name], us
        if pending:
            names, total = [pending[0], name], us + pending[1]
            pending = None
        calls.append((names, total))
    if len(calls) % steps:
        raise RuntimeError(f"{len(calls)} conv calls in {steps} steps")
    per = len(calls) // steps
    return [calls[i * per:(i + 1) * per] for i in range(steps)]


def main(argv=None) -> int:
    args = parse(argv)
    if args.src:
        sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench.harness import build_run, find_cell
    from repro_torch.kernels import conv2d as kconv
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cell = find_cell(args.workload)
    if cell.chips != 1:
        raise SystemExit(f"{args.workload} takes {cell.chips} cards; this "
                         "tool runs one-card cells")
    run = build_run(cell, torch.device("cuda"))
    ref, cfg = cell.family, cell.config
    B, pool_n = cell.traffic["batch"], cell.traffic["pool"]
    run.load_params(ref.init_params(cfg, args.seed, run.device))
    pool = ref.make_batches(cfg, B, pool_n, args.seed, run.device)
    for k in range(3):
        run.step(pool[k % pool_n], k)
    torch.cuda.synchronize()
    before = (kconv.launches, getattr(kconv, "launches_ws", None))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for k in range(3, 3 + args.steps):
            run.step(pool[k % pool_n], k)
        torch.cuda.synchronize()
    ops = sorted((e.time_range.start, e.name, e.time_range.end
                  - e.time_range.start) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and KERNEL in e.name)
    steps = layers([(name, us) for _, name, us in ops], args.steps)
    convs = []
    for i in range(len(steps[0])):
        ms = [s[i][1] / 1e3 for s in steps]
        convs.append({"conv": i + 1, "kernels": steps[0][i][0],
                      "ms": statistics.fmean(ms), "ms_min": min(ms),
                      "ms_max": max(ms)})
    ws = getattr(kconv, "launches_ws", None)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "steps": args.steps,
        "label": "parent" if args.src else "change",
        "card": torch.cuda.get_device_name(0),
        "conv_ms_per_step": sum(c["ms"] for c in convs),
        "launches": kconv.launches - before[0],
        "launches_ws": None if ws is None else ws - before[1],
        "convs": convs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
