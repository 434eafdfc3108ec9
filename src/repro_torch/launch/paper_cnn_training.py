"""The paper's own workload: VGG-A training with momentum SGD (reduced size),
assembled through ``repro_torch.api`` — the family
adapter picks the CNN loss and stream and the paper's optimizer;
``--use-kernel`` swaps the forward convs onto the Hopper direct-conv kernel
(on the CPU, onto its plain version).  :func:`use_kernel` dispatches by the
run's config class, so the same switch puts a CD-DNN run's forward products
on the blocked-GEMM kernel and a transformer LM run's attention forwards on
the flash-attention kernel.

    PYTHONPATH=src python -m repro_torch.launch.paper_cnn_training --use-kernel
    PYTHONPATH=src python -m repro_torch.launch.paper_cnn_training --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.api import Run, RunSpec, compile_run
from repro_torch.configs.base import DNNConfig, ModelConfig
from repro_torch.core.sharding import ShardingCtx
from repro_torch.models import cnn, dnn, transformer
from repro_torch.telemetry.events import NULL_RECORDER
from repro_torch.train import make_overlapped_train_step, make_train_step


def kernel_loss(cfg, ctx: ShardingCtx = ShardingCtx()):
    """The family's loss on its kernel: a CNN's forward convs on the
    direct-conv kernel, a DNN's forward products on the blocked GEMM
    (``forward(use_kernel=True)``), an LM's attention forwards on the flash
    kernel (``lm_loss(use_kernel=True)``); under a model axis one launch
    per model member's block or heads (``ctx``).  The backward is
    PyTorch's (for attention, ``attention_ref``'s gradient)."""
    if isinstance(cfg, ModelConfig):
        return lambda p, b: transformer.lm_loss(p, cfg, ctx, b,
                                                use_kernel=True)
    model = dnn if isinstance(cfg, DNNConfig) else cnn
    return lambda p, b: model.loss_fn(p, cfg, b, use_kernel=True, ctx=ctx)


def use_kernel(run: Run) -> Run:
    """Swap ``run``'s loss for :func:`kernel_loss`; the rest of the
    assembly (optimizer, schedule, data, trainer, the overlapped or
    monolithic update, the spans' recorder) is untouched."""
    run.loss_fn = kernel_loss(run.cfg, run.ctx)
    rec = run.telemetry or NULL_RECORDER
    if run.comm is not None and run.comm.overlap:
        run.train_step = make_overlapped_train_step(
            run.loss_fn, run.lr_schedule, run.mesh, run.mesh.data_axes,
            run.comm, run.dist_update, grad_clip=run.spec.grad_clip,
            recorder=rec)
    else:
        run.train_step = make_train_step(run.loss_fn, run.optimizer,
                                         run.lr_schedule,
                                         grad_clip=run.spec.grad_clip,
                                         dist_update=run.dist_update,
                                         recorder=rec)
    return run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--use-kernel", action="store_true",
                    help="route forward convs through the direct-conv kernel")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    spec = RunSpec(arch="vgg-a", smoke=True, steps=args.steps,
                   batch=args.batch, lr=5e-3, schedule="constant",
                   log_every=10)
    run = compile_run(spec, device=args.device)  # default optimizer: SGD
    if args.use_kernel:
        use_kernel(run)
    with run:
        hist = run.fit()
    print(f"{run.cfg.name} loss {hist[0]['loss']:.3f} -> "
          f"{hist[-1]['loss']:.3f} (kernel={args.use_kernel}, "
          f"device={run.device})")
    return hist


if __name__ == "__main__":
    main()
