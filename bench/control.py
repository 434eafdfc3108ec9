"""The readings a cell's limits are set from, on the chip at the cell's
own size (``check``):

* the program's first three steps against the reference on ``--seeds``
  (the lower readings);
* on ``--control-seeds``, in the program's place: the reference in TF32
  (the control: the precision below the configuration's f32 with TF32
  off), and the reference with faults planted: half of each batch left out
  (the mean taken over the rest), and on a cell of several chips the
  exchange between them left out (rank 0's own rows alone).  A step that
  returns its state unchanged reads 1 by construction and is not run.

    python3 bench/control.py --workload vgg_a.serial.b256 \\
        --seeds 11,12,13 --control-seeds 21,22,23

Each reading is one JSON line; the last line holds, for each kind and
number, the largest and the smallest reading.  A cell on several chips
starts its ranks as ``run.py`` does; the reference runs on rank 0.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _zero_state(state):
    """Every tensor of the optimizer's state to zero (momentum SGD's state
    as a fresh run has it)."""
    import torch
    if isinstance(state, torch.Tensor):
        state.zero_()
    elif isinstance(state, dict):
        for v in state.values():
            _zero_state(v)
    elif isinstance(state, (tuple, list)):
        for v in state:
            _zero_state(v)


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, required=True)
    args = ap.parse_args(argv)
    from bench import run as bench_run
    from bench.harness import find_cell
    cell = find_cell(args.workload)
    if bench_run.ENV_T0 not in os.environ and cell.chips > 1:
        return bench_run.spawn(cell.chips, __file__, sys.argv[1:])
    if bench_run.ENV_T0 in os.environ:
        from repro_torch.cluster.spec import ClusterSpec, initialize
        print(initialize(ClusterSpec.from_env()), file=sys.stderr)
    readings(cell, args.seeds, args.control_seeds)
    return 0


def readings(cell, seeds, control_seeds, device="cuda", out=print):
    import torch

    from bench import check
    from bench.harness import Group, _rows, build_run, first_steps
    group = Group()
    run = build_run(cell, None if device == "cuda" and group.world > 1
                    else torch.device(device))
    dev = run.device
    ref, cfg, opt = cell.family, cell.config, cell.config["optimizer"]
    B, pool_n = cell.traffic["batch"], cell.traffic["pool"]
    lo, hi = group.rank * B // group.world, (group.rank + 1) * B // group.world
    got = {}
    for seed in seeds:
        p0 = ref.init_params(cfg, seed, dev)
        run.load_params(p0)
        _zero_state(run.opt_state)
        pool = _rows(ref.make_batches(cfg, B, pool_n, seed, dev), lo, hi)
        got[seed] = first_steps(run, pool, p0, opt["lr"])
        del p0, pool
    del run
    gc.collect()
    torch.cuda.empty_cache()
    group.close()
    if group.rank != 0:
        return None
    kinds = {"program": [(s, {}) for s in seeds],
             "control_tf32": [(s, {"use_tf32": True}) for s in control_seeds],
             "half_batch": [(s, {"rows": B // 2}) for s in control_seeds]}
    if group.world > 1:
        kinds["exchange_left_out"] = [(s, {"rows": B // group.world})
                                      for s in control_seeds]
    summary = {}
    for kind, todo in kinds.items():
        for seed, kw in todo:
            p0 = ref.init_params(cfg, seed, dev)
            batches = ref.make_batches(cfg, B, pool_n, seed,
                                       dev)[:check.CHECK_STEPS]
            want = check.reference_readings(ref.loss, cfg, p0, batches, opt)
            cand = got[seed] if kind == "program" else \
                check.reference_readings(ref.loss, cfg, p0, batches, opt, **kw)
            gaps = check.compare(cand, want)
            out(json.dumps({"kind": kind, "seed": seed, "gaps": gaps,
                            "leaves": check.leaf_gaps(cand, want),
                            "losses": cand.losses,
                            "ref_losses": want.losses}))
            for name, v in gaps.items():
                lo_hi = summary.setdefault(kind, {}).setdefault(name, [v, v])
                lo_hi[0], lo_hi[1] = min(lo_hi[0], v), max(lo_hi[1], v)
            del p0, batches
    out(json.dumps({"workload": cell.name, "min_max": summary,
                    "device": torch.cuda.get_device_name(dev)
                    if dev.type == "cuda" else "cpu"}))
    return summary


if __name__ == "__main__":
    sys.exit(main())
