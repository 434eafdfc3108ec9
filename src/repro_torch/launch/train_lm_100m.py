"""End-to-end LM training (``examples/train_lm_100m.py``): train a
~100M-parameter LM with the full substrate: declarative ``RunSpec``
assembly, the data pipeline with background prefetch, AdamW +
warmup-cosine, periodic checkpoints, auto-resume and ``history.csv``.

Default model: ``llama-100m`` at full width (100.7M params, llama3-family
blocks; ``--arch xlstm-125m`` trains the assigned SSM config instead).
``--use-kernel`` puts every attention forward on the flash kernel, as the
training CLI's flag does (``launch.paper_cnn_training.use_kernel``).

    PYTHONPATH=src python -m repro_torch.launch.train_lm_100m --steps 300
    PYTHONPATH=src python -m repro_torch.launch.train_lm_100m --steps 30 \\
        --use-kernel --ckpt-dir /tmp/lm100m          # on the card
    PYTHONPATH=src python -m repro_torch.launch.train_lm_100m --steps 2 \\
        --batch 2 --seq 32 --device cpu

Run it again with the same ``--ckpt-dir`` and it resumes from the latest
checkpoint; past ``--steps`` it trains nothing.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.api import RunSpec, compile_run
from repro_torch.checkpoint import save
from repro_torch.core.params import tree_leaves
from repro_torch.launch.paper_cnn_training import use_kernel


def spec_from_args(args) -> RunSpec:
    return RunSpec(arch=args.arch, steps=args.steps, batch=args.batch,
                   seq=args.seq, lr=args.lr, weight_decay=0.1,
                   log_every=10, ckpt_dir=args.ckpt_dir,
                   ckpt_every=max(args.steps // 3, 50))


def main(argv=None):
    """Train (or resume); returns the history of the steps trained."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm100m"))
    ap.add_argument("--arch", default="llama-100m")
    ap.add_argument("--use-kernel", action="store_true",
                    help="attention forwards on the flash kernel")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    run = compile_run(spec_from_args(args), device=args.device)
    if args.use_kernel:
        use_kernel(run)
    n = sum(x.numel() for x in tree_leaves(run.params))
    print(f"training {run.cfg.name}: {n / 1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.batch} x seq {args.seq}")

    # Run.fit auto-resumes from the latest ckpt_dir checkpoint: the params
    # and optimizer state are restored and the seeded data stream is
    # fast-forwarded, so the trajectory goes on where it stopped
    hist = run.fit()
    run.close()
    if not hist:
        # resumed past --steps (or the source ran dry before any log):
        # nothing trained, so no new checkpoint at args.steps and the
        # recorded loss history stays
        print("nothing to train; checkpoint and history left as-is")
        return hist
    if hist[-1]["step"] == args.steps:
        # completed: capture the end state (the final step always logs)
        save(args.ckpt_dir, args.steps, params=run.params,
             opt_state=run.opt_state)
    else:
        # stopped short: the params are ahead of the last logged step, so
        # keep the periodic checkpoints only
        print(f"stopped at step {hist[-1]['step']} < {args.steps}; "
              "keeping periodic checkpoints only")
    print(f"loss: {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    # append on resume: hist covers only the steps after the restored
    # checkpoint, and mode "w" would wipe the earlier rows
    path = os.path.join(args.ckpt_dir, "history.csv")
    resumed = hist[0]["step"] > 1 and os.path.exists(path)
    with open(path, "a" if resumed else "w") as f:
        if not resumed:
            f.write("step,loss\n")
        for h in hist:
            f.write(f"{h['step']},{h['loss']}\n")
    return hist


if __name__ == "__main__":
    main()
