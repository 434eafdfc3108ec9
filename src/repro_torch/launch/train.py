"""Training launcher of the port (``repro.launch.train``):
``python -m repro_torch.launch.train --arch <id> [--smoke]``.

A thin argparse layer over the run-assembly API: the flags build a
``RunSpec``, ``compile_run`` assembles it and ``Run.fit`` trains.  The flags
and their choices are the reference's, plus ``--device`` and
``--use-kernel`` (the family's forward on the port's Hopper kernel, as
``launch.paper_cnn_training`` has it; the reference's launcher keeps its
XLA route); what the port
does not run yet (``--parallel dp|zero1-gspmd``, ``--model-ways > 1``)
parses and then raises in ``compile_run``.  ``--parallel`` defaults to
``serial``, since the reference's default (``dp``) is not ported.

    # the paper's §3.4 strip update on the ring kernels, each bucket's
    # reduce issued inside backprop (one member a pod, on one card)
    python -m repro_torch.launch.train --arch vgg-a --smoke \\
        --parallel zero1 --pods 2 --comm-backend pallas-ring --overlap

    # full-width VGG-A zero1 on the card, the forward convs on the
    # direct-conv kernel, checkpointed every 2 steps (run it again to resume)
    python -m repro_torch.launch.train --arch vgg-a --parallel zero1 \
        --comm-backend pallas-ring --batch 64 --steps 4 --use-kernel \
        --ckpt-dir /tmp/vgg-ckpt --ckpt-every 2

    # on the CPU (the kernels' plain versions)
    python -m repro_torch.launch.train --arch vgg-a --smoke --device cpu \\
        --parallel zero1 --pods 2 --comm-backend pallas-ring

    # bounded staleness on the ring, the gossip partner exchange, and the
    # measured comm plan (comm="auto")
    python -m repro_torch.launch.train --arch vgg-a --smoke --device cpu \\
        --parallel stale-sync --pods 2 --comm-backend pallas-ring
    python -m repro_torch.launch.train --arch vgg-a --smoke --device cpu \\
        --parallel gossip --pods 2
    python -m repro_torch.launch.train --arch vgg-a --smoke --device cpu \\
        --parallel zero1 --pods 2 --comm auto

A ``--ckpt-dir`` run writes checkpoints and resumes: the same command again
takes up from the latest saved step (params, optimizer strips and the data
stream's position).  Runs over processes: ``repro_torch.launch.cluster``.
"""
from __future__ import annotations

import argparse

from repro_torch.api import (
    MODE_CAPS,
    PARALLEL_MODES,
    SCHEDULES,
    MeshSpec,
    RunSpec,
    compile_run,
)
from repro_torch.comm import COLLECTIVE_BACKENDS, WIRE_FORMATS, CommConfig
from repro_torch.configs import ARCHS

MIB = 2 ** 20
WIRE_DTYPES = {"fp32": "float32", "bf16": "bfloat16"}


def comm_flags_set(args) -> bool:
    """True when any explicit bucketed-collectives flag departs from its
    default (these need a comm-capable ``--parallel``: ``MODE_CAPS``)."""
    return (args.bucket_mb is not None or args.wire_dtype != "fp32"
            or args.overlap or args.comm_backend != "lax"
            or args.cross_backend is not None
            or args.wire_format is not None)


def spec_from_args(args, cluster: bool = False) -> RunSpec:
    """The ``RunSpec`` of the parsed flags (the reference's rules);
    ``cluster`` builds the mesh over the live process group."""
    comm = None
    if getattr(args, "comm", None) == "auto":
        comm = "auto"
    elif comm_flags_set(args):
        caps = MODE_CAPS[args.parallel]
        bucket_mb = 4.0 if args.bucket_mb is None else args.bucket_mb
        # the default "lax" means "the mode's default backend"
        backend = args.comm_backend
        if backend == "lax" and caps.default_backend is not None:
            backend = caps.default_backend
        hierarchical = ((args.pods > 1 or cluster)
                        and args.parallel != "gossip")
        comm = CommConfig(bucket_bytes=int(bucket_mb * MIB),
                          reduce_dtype=WIRE_DTYPES[args.wire_dtype],
                          hierarchical=hierarchical,
                          overlap=args.overlap,
                          backend=backend,
                          cross_backend=args.cross_backend or "lax",
                          wire_format=args.wire_format,
                          topk_ratio=args.topk_ratio)
    ckpt_every = 0
    if args.ckpt_dir:
        ckpt_every = args.ckpt_every if args.ckpt_every \
            else max(args.steps // 5, 1)
    return RunSpec(
        arch=args.arch, smoke=args.smoke, parallel=args.parallel,
        mesh=MeshSpec(pods=args.pods, model_ways=args.model_ways,
                      cluster=cluster, members_per_device=args.pods),
        comm=comm, optimizer=args.optimizer, lr=args.lr,
        schedule=args.schedule,
        steps=args.steps, batch=args.batch, seq=args.seq, seed=args.seed,
        log_every=5, ckpt_every=ckpt_every, ckpt_dir=args.ckpt_dir,
        telemetry=getattr(args, "trace_dir", None))


def add_run_args(ap: argparse.ArgumentParser,
                 parallel_default: str = "serial", cluster: bool = False):
    """The training-run flags, shared with ``repro_torch.launch.cluster``
    so that a cluster run is configured with exactly the flags of a
    one-process run.  ``cluster`` leaves ``--comm-backend`` unset (None):
    the cluster CLI resolves it per mode."""
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="warmup_cosine",
                    choices=list(SCHEDULES),
                    help="LR schedule; linear-scale-warmup is Goyal et "
                         "al.'s large-batch recipe (peak = lr x the "
                         "data-parallel ways, gradual warmup from lr)")
    ap.add_argument("--parallel", default=parallel_default,
                    choices=list(PARALLEL_MODES),
                    help="serial | zero1 (explicit bucketed §3.4 strips) | "
                         "stale-sync (the strips reduced a step earlier) | "
                         "gossip (a rotating partner exchange) run in the "
                         "port; dp and zero1-gspmd parse and are not ported "
                         f"yet (default {parallel_default})")
    ap.add_argument("--pods", type=int, default=1,
                    help="pod axis extent (>1 adds the cross-pod "
                         "hierarchical hop)")
    ap.add_argument("--model-ways", type=int, default=1)
    ap.add_argument("--bucket-mb", type=float, default=None,
                    help="fusion-buffer size in MiB for --parallel zero1 "
                         "(default 4)")
    ap.add_argument("--wire-dtype", default="fp32", choices=list(WIRE_DTYPES),
                    help="gradient part-reduce wire dtype (zero1)")
    ap.add_argument("--wire-format", default=None,
                    choices=list(WIRE_FORMATS),
                    help="gradient bytes-on-wire encoding: fp32/bf16 "
                         "(dense), int8 (per-message scales, f32 "
                         "accumulate per hop), topk ((values, indices) "
                         "sparse messages + error-feedback residual; "
                         "zero1 only).  Default: derived from --wire-dtype")
    ap.add_argument("--topk-ratio", type=float, default=0.05,
                    help="fraction of entries kept per message under "
                         "--wire-format topk")
    ap.add_argument("--overlap", action="store_true",
                    help="issue each bucket's part-reduce inside the "
                         "backward pass (§3.1 bubble schedule) instead of "
                         "reducing after the backward (zero1)")
    ring = (" (default under --parallel zero1 and stale-sync: pallas-ring, "
            "so that the "
            "sums stay on the card; over gloo the plain reduce-scatter of a "
            "card's buffers would run in host memory, and is refused)"
            if cluster else " (default lax)")
    ap.add_argument("--comm-backend", default=None if cluster else "lax",
                    choices=list(COLLECTIVE_BACKENDS),
                    help="collective implementation for the zero1 "
                         "schedules: lax (the plain collectives) or "
                         "pallas-ring (the paper's explicit §3.4 ring on the "
                         "port's kernels; in-pod only under a pod axis, "
                         "the cross-pod hop follows --cross-backend)" + ring)
    ap.add_argument("--cross-backend", default=None,
                    choices=list(COLLECTIVE_BACKENDS),
                    help="collective implementation for the CROSS-POD hop "
                         "of the hierarchical schedule" + ring)
    ap.add_argument("--comm", default=None, choices=["auto"],
                    help="comm='auto': the measured bucket-size, backend "
                         "and wire-format autotuner (telemetry.autotune)")
    ap.add_argument("--trace-dir", default=None,
                    help="write a per-process telemetry trace (JSONL) and a "
                         "merged Chrome trace (trace.json, load in "
                         "chrome://tracing or Perfetto) to this directory")
    ap.add_argument("--optimizer", default=None,
                    choices=["adamw", "sgd"],
                    help="default: family choice (momentum SGD for the "
                         "paper's CNN/DNN, AdamW for transformers)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint period in steps (default: steps/5 "
                         "when --ckpt-dir is set)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on "
                         "the CPU, over gloo ranks for a cluster)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="run the family's forward on the port's Hopper "
                         "kernel (a CNN's convs, a DNN's products, an LM's "
                         "attention; on the CPU its plain version)")
    return ap


def record_launches(recorder) -> None:
    """This process's kernel launches as the recorder's
    ``launches/<kernel>`` counters (the kernels that launched), so that a
    trace's closing metrics say which kernels the run went through."""
    from repro_torch.kernels import launch_counts
    for name, n in launch_counts().items():
        if n:
            recorder.count(f"launches/{name}", n)


def compile_from_args(args, cluster: bool = False):
    """``compile_run`` of the parsed flags, on ``--device``, the forward on
    the kernel under ``--use-kernel``."""
    run = compile_run(spec_from_args(args, cluster=cluster),
                      device=args.device)
    if args.use_kernel:
        from repro_torch.launch.paper_cnn_training import use_kernel
        use_kernel(run)
    return run


def check_run_args(ap: argparse.ArgumentParser, args) -> None:
    """Flag compatibility, read off ``MODE_CAPS``: the table ``RunSpec``
    validates against, so the launcher and the API agree on what a mode
    supports."""
    caps = MODE_CAPS[args.parallel]
    commful = [m for m, c in MODE_CAPS.items() if c.comm]
    if getattr(args, "comm", None) == "auto":
        if comm_flags_set(args):
            ap.error("--comm auto autotunes the bucket size and backend "
                     "from measurement; it cannot be combined with the "
                     "explicit comm flags (--bucket-mb / --wire-dtype / "
                     "--overlap / --comm-backend / --cross-backend)")
        if not caps.comm:
            ap.error("--comm auto measures the explicit bucketed "
                     f"collectives, which --parallel {args.parallel} does "
                     f"not use; pick one of {commful}")
    if comm_flags_set(args) and not caps.comm:
        ap.error("--bucket-mb / --wire-dtype / --overlap / --comm-backend "
                 "/ --cross-backend configure the explicit bucketed "
                 f"collectives, which --parallel {args.parallel} does not "
                 f"use; pick one of {commful}")
    if args.overlap and not caps.overlap:
        overlappy = [m for m, c in MODE_CAPS.items() if c.overlap]
        ap.error("--overlap (the §3.1 backward-pass reduce schedule) is "
                 f"only supported by {overlappy}, not --parallel "
                 f"{args.parallel}")
    if (caps.backends is not None and args.comm_backend != "lax"
            and args.comm_backend not in caps.backends):
        ap.error(f"--comm-backend {args.comm_backend} is not valid under "
                 f"--parallel {args.parallel}; this mode supports "
                 f"{list(caps.backends)}")
    if (args.wire_format is not None and caps.wire_formats is not None
            and args.wire_format not in caps.wire_formats):
        ap.error(f"--wire-format {args.wire_format} is not valid under "
                 f"--parallel {args.parallel}; this mode supports "
                 f"{list(caps.wire_formats)}")
    if args.wire_format == "topk" and args.overlap:
        ap.error("--wire-format topk cannot run with --overlap: the "
                 "backward-pass reduce taps are stateless, so the "
                 "error-feedback residual has nowhere to live")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_run_args(ap)
    args = ap.parse_args(argv)
    check_run_args(ap, args)

    run = compile_from_args(args)
    print(f"arch: {run.cfg.name}  parallel={run.spec.parallel}  "
          f"overlap={run.comm.overlap if run.comm else False}  "
          f"backend={run.comm.backend if run.comm else 'lax'}  "
          f"mesh={run.mesh}  device={run.device}  "
          f"kernel={args.use_kernel}")
    hist = run.fit()   # resumes from the latest --ckpt-dir checkpoint
    record_launches(run.telemetry)
    run.close()
    if hist:
        print(f"final loss: {hist[-1]['loss']:.4f}")
    else:
        print("checkpoint already at or past --steps; nothing to train")
    return hist


if __name__ == "__main__":
    main()
