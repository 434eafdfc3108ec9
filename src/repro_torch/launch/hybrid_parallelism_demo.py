"""Hybrid-parallelism demo (``examples/hybrid_parallelism_demo.py``): the
paper's core idea, end to end, on one device.

1. Uses the §3 balance equations to pick the optimal group count G for the
   CD-DNN layers (model parallel within a group, data parallel across).
2. Trains the smoke CD-DNN on a ``{data: 4, model: 2}`` local mesh: each
   FC layer on its model member's own columns (``core.sharding``), the
   §3.4 part-reduce / part-broadcast update over the 4 data members
   (``optim.dist``), and checks that the loss curve and the params track
   serial SGD from the same params and batches: the paper's Fig-5
   property.

    PYTHONPATH=src python -m repro_torch.launch.hybrid_parallelism_demo
    PYTHONPATH=src python -m repro_torch.launch.hybrid_parallelism_demo \\
        --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.api import MeshSpec, RunSpec, compile_run
from repro_torch.comm import CommConfig
from repro_torch.configs import get_config
from repro_torch.configs.base import ConvLayerSpec
from repro_torch.core import balance
from repro_torch.data.pipeline import make_placer

N_NODES = 8
MINIBATCH = 32
STEPS = 10
LR = 0.05


def group_counts(cfg):
    """Step 1's lines: the §3.3 G* and the §3.2 rule for every layer."""
    dims = [(cfg.input_dim, cfg.hidden_dim)] \
        + [(cfg.hidden_dim, cfg.hidden_dim)] * (cfg.num_hidden - 1) \
        + [(cfg.hidden_dim, cfg.output_dim)]
    lines = []
    for i, (fin, fout) in enumerate(dims):
        g = balance.optimal_group_count(N_NODES, MINIBATCH, fout)
        mp = balance.model_parallel_preferred(
            ConvLayerSpec("fc", ifm=fin, ofm=fout, kernel=1, out_hw=1),
            in_hw=1, minibatch=MINIBATCH)
        lines.append(f"  layer {i}: {fin:5d}->{fout:5d}  G*={g}  "
                     f"model-parallel preferred: {mp}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    print(f"paper §3.3 optimal G per CD-DNN layer (N={N_NODES}, "
          f"minibatch={MINIBATCH}):")
    for line in group_counts(get_config("cd-dnn")):
        print(line)

    base = RunSpec(arch="cd-dnn", smoke=True, steps=STEPS, batch=MINIBATCH,
                   lr=LR, schedule="constant", grad_clip=0.0, seed=0)
    serial = compile_run(base, device=args.device)
    hybrid = compile_run(base.replace(
        parallel="zero1", comm=CommConfig(backend="pallas-ring"),
        mesh=MeshSpec(members_per_device=4, model_ways=2)),
        device=args.device)
    print(f"\nmesh: {hybrid.mesh.shape}  (G=4 data-parallel groups x "
          f"2-way model parallel)")
    stream = serial.family.stream(serial.cfg, MINIBATCH, 0, 1)
    place = make_placer(serial.device)
    print("step   serial-loss  dist-loss   max|Δparam|")
    for step in range(STEPS):
        batch = place(next(stream))
        l_s = serial.step(batch, step)["loss"]
        l_d = hybrid.step(batch, step)["loss"]
        full = hybrid.full_params()
        delta = max(float((serial.params[k] - full[k]).detach().abs().max())
                    for k in full)
        print(f"{step:4d}  {float(l_s):10.4f} {float(l_d):10.4f}"
              f"   {delta:.2e}")
    if not delta < 1e-4:
        raise SystemExit(f"the hybrid run left serial SGD: max|Δparam| "
                         f"{delta}")
    print("\nsynchronous-SGD identity verified: the hybrid model-parallel "
          "forward and the paper's part-reduce/part-broadcast update match "
          "serial SGD (Fig 5 property).")
    return delta


if __name__ == "__main__":
    main()
