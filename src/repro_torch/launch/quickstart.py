"""Quickstart (``examples/quickstart.py``): train a reduced LLaMA-3-family
model for 30 steps, then generate from it, from spec to training through
``repro_torch.api``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart            # card
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.api import RunSpec, compile_run
from repro_torch.core.params import tree_leaves
from repro_torch.serve.decode import generate


def spec(steps: int = 30) -> RunSpec:
    """The example's run: smoke llama3-8b, the reference's knobs."""
    return RunSpec(arch="llama3-8b", smoke=True, steps=steps, batch=8,
                   seq=64, lr=3e-3, warmup_steps=5, weight_decay=0.01,
                   log_every=5)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    run = compile_run(spec(args.steps), device=args.device)
    n_params = sum(x.numel() for x in tree_leaves(run.params))
    print(f"arch: {run.cfg.name}  layers={run.cfg.num_layers} "
          f"d={run.cfg.d_model} params={n_params:,}")

    hist = run.fit()
    run.close()
    assert hist[-1]["loss"] < hist[0]["loss"]

    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, run.cfg.vocab_size, (2, 8),
                           generator=gen).to(run.device)
    out = generate(run.params, run.cfg, run.ctx, prompt, 16,
                   temperature=0.0)
    print("generated:", out[0].tolist())
    return hist, out


if __name__ == "__main__":
    main()
