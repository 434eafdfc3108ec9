"""``compile_run``: RunSpec -> Run, ``compile_serve``: ServeSpec -> Server
(``repro.api.assemble``).  The one place run and deployment assembly
happens.

Training resolves, in the reference's order: arch id -> config (optionally
its smoke variant) -> family adapter -> mesh (none for ``serial``) -> params
on the device -> optimizer and LR schedule -> update path -> train step.
The update path is the serial ``optimizer.update`` or, for
``parallel="zero1"``, the explicit bucketed §3.4 pipeline of ``repro_torch.comm``
and ``optim.dist.make_distributed_update`` over the G members of a local
mesh (``MeshSpec.members_per_device``) on the run's device.  What is not
ported yet raises before anything is allocated.  ``wire_format="topk"``
takes the error-feedback update (``optim.dist.make_topk_ef_update``); int8
rides the plain zero1 pipeline through the bound backend.  ``comm.overlap``
takes the §3.1 backprop-overlapped step
(``train.make_overlapped_train_step`` over ``optim.dist.
make_overlapped_update``), under every wire format but top-k, which
``RunSpec`` refuses with overlap.
"""
from __future__ import annotations

from repro_torch.api.families import FamilyAdapter, adapter_for
from repro_torch.api.run import Run
from repro_torch.api.serve import Server
from repro_torch.api.spec import RunSpec, ServeSpec
from repro_torch.comm.bucketer import CommConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import transformer
from repro_torch.models.transformer import ATTN_KINDS
from repro_torch.optim import (
    AdamW,
    MomentumSGD,
    constant,
    linear_scale_warmup,
    warmup_cosine,
)
from repro_torch.optim.dist import (
    make_distributed_update,
    make_overlapped_update,
    make_topk_ef_update,
)
from repro_torch.train import make_overlapped_train_step, make_train_step

#: the parallel modes compile_run assembles
PORTED_MODES = ("serial", "zero1")


def _resolve_config(spec):
    cfg = get_config(spec.arch) if isinstance(spec.arch, str) else spec.arch
    return smoke_variant(cfg) if spec.smoke else cfg


def _make_optimizer(spec: RunSpec, family: FamilyAdapter):
    name = spec.optimizer or family.default_optimizer
    wd = spec.weight_decay
    if name == "adamw":
        return AdamW(weight_decay=0.01 if wd is None else wd)
    return MomentumSGD(momentum=spec.momentum,
                       weight_decay=0.0 if wd is None else wd)


def _make_schedule(spec: RunSpec, data_ways: int = 1):
    if spec.schedule == "constant":
        return constant(spec.lr)
    warmup = spec.warmup_steps if spec.warmup_steps is not None \
        else max(spec.steps // 20, 1)
    if spec.schedule == "linear-scale-warmup":
        # Goyal et al.: the peak LR scales with the data-parallel ways
        return linear_scale_warmup(spec.lr, data_ways, warmup, spec.steps)
    return warmup_cosine(spec.lr, warmup, spec.steps)


def _check_ported(spec: RunSpec) -> None:
    """Raise for what the port does not run yet, before any allocation."""
    def missing(what):
        raise NotImplementedError(f"{what} is not ported yet: the port runs "
                                  f"parallel in {PORTED_MODES}")
    if spec.parallel not in PORTED_MODES:
        missing(f"parallel={spec.parallel!r}")
    if spec.parallel == "serial":
        return
    if spec.comm == "auto":
        missing("comm='auto' (the collective autotuner)")
    if spec.mesh.model_ways > 1:
        missing(f"model_ways={spec.mesh.model_ways}")
    if spec.mesh.cluster:
        missing("mesh.cluster (compile_run over processes)")


def compile_run(spec: RunSpec, device=None, recorder=None) -> Run:
    """Assemble a ready-to-train :class:`Run` from ``spec``.

    ``device`` defaults to the GPU and raises when none is visible; pass
    ``device="cpu"`` to run on the CPU.  ``recorder`` receives the
    trainer's spans and counts (None: no-op).
    """
    _check_ported(spec)
    dev = resolve_device(device)
    cfg = _resolve_config(spec)
    family = adapter_for(cfg)
    loss_fn = family.make_loss(cfg)
    mesh = None
    if spec.parallel != "serial":
        mesh = make_local_mesh(spec.mesh.members_per_device,
                               pods=spec.mesh.pods, device=dev)
    params = family.init(cfg, spec.seed, dev)
    optimizer = _make_optimizer(spec, family)
    lr_schedule = _make_schedule(spec, 1 if mesh is None else mesh.size)
    dist_update = comm = train_step = None
    if spec.parallel == "zero1":
        axes = mesh.axis_names
        comm = spec.comm if spec.comm is not None \
            else CommConfig(hierarchical=len(axes) == 2)
        if comm.overlap:
            # §3.1: each bucket's reduce is issued inside the backward pass
            # (spec validation keeps topk off this path)
            init_fn, dist_update = make_overlapped_update(
                optimizer, mesh, data_axes=axes, comm=comm)
            train_step = make_overlapped_train_step(
                loss_fn, lr_schedule, mesh, axes, comm, dist_update,
                grad_clip=spec.grad_clip)
        else:
            # the error-feedback residual of topk needs the state carry of
            # the EF composition (spec validation pinned topk to monolithic
            # zero1)
            make_update = make_topk_ef_update \
                if comm.wire_format == "topk" else make_distributed_update
            init_fn, dist_update = make_update(optimizer, mesh,
                                               data_axes=axes, comm=comm)
        opt_state = init_fn(params)
    else:
        opt_state = optimizer.init(params)
    if train_step is None:
        train_step = make_train_step(loss_fn, optimizer, lr_schedule,
                                     grad_clip=spec.grad_clip,
                                     dist_update=dist_update)
    return Run(spec=spec, cfg=cfg, family=family, device=dev,
               loss_fn=loss_fn, optimizer=optimizer, lr_schedule=lr_schedule,
               train_step=train_step, params=params, opt_state=opt_state,
               mesh=mesh, comm=comm, dist_update=dist_update,
               telemetry=recorder)


def compile_serve(spec: ServeSpec, params=None, device=None,
                  recorder=None) -> Server:
    """Assemble a live :class:`~repro_torch.api.serve.Server` from ``spec``.

    ``params`` serves given weights (e.g. the reference's, carried over by
    ``interop.params_from_numpy``); ``None`` initializes fresh ones from
    ``spec.seed``.  ``device`` defaults to the GPU and raises when none is
    visible; pass ``device="cpu"`` to run on the CPU.  ``recorder`` receives
    prefill/decode spans and preempt events.  The archs the reference
    rejects are rejected here with the same reasons, and so are MoE configs,
    which the port does not serve yet — before any buffer is allocated.
    """
    cfg = get_config(spec.arch) if isinstance(spec.arch, str) else spec.arch
    if not isinstance(cfg, ModelConfig):
        raise ValueError(
            f"compile_serve needs a token LM ModelConfig, got "
            f"{type(cfg).__name__} — serving covers the transformer family "
            "only")
    cfg = smoke_variant(cfg) if spec.smoke else cfg
    bad = [k for k in cfg.block_pattern if k not in ATTN_KINDS]
    if bad:
        raise ValueError(
            f"paged decode serves attention blocks only ({ATTN_KINDS}); "
            f"{cfg.name!r} has {bad} in its pattern")
    if cfg.frontend is not None or cfg.num_codebooks or cfg.mrope:
        raise ValueError(
            f"{cfg.name!r} uses a modality frontend / codebook heads / "
            "M-RoPE — token-in/token-out archs only for serving")
    if cfg.num_experts:
        raise ValueError(f"{cfg.name!r} is a MoE config: MoE blocks are not "
                         "ported yet")

    dev = resolve_device(device)
    if params is None:
        params = transformer.init_params(cfg, spec.seed, dev)
    return Server(spec=spec, cfg=cfg, params=params, device=dev,
                  recorder=recorder)
