"""``compile_run``: RunSpec -> Run, ``compile_serve``: ServeSpec -> Server
(``repro.api.assemble``).  The one place run and deployment assembly
happens.

Training resolves, in the reference's order: arch id -> config (optionally
its smoke variant) -> family adapter -> recorder (``telemetry.
make_recorder(spec.telemetry)``) -> mesh (none for ``serial``) -> params
on the device -> optimizer and LR schedule -> update path -> train step.
Params are placed by the logical-axis sharding rules
(``core.sharding.ShardingCtx``), for every family: under a model axis each
model member holds its own block of every model-sharded leaf (a CNN's or
DNN's "ff" columns; an LM's heads, kv heads, ff columns, vocab rows,
experts and SSM dims), and the family's loss runs its blocks on them.  The
update path is the serial ``optimizer.update``; or the reference's two
GSPMD modes,
``optim.dist.GspmdUpdate``:

* ``dp``: the optimizer on each member's own shard of params and state,
  the gradient the mean over the data axes;
* ``zero1-gspmd``: the state sharded as ``train.zero1_state_shardings``
  places it, each leaf's gradient reduce-scattered to its strip, the strip
  updated and the params all-gathered back;

or, for the explicit bucketed modes, the §3.4 pipeline of
``repro_torch.comm`` and ``optim.dist`` over the G data members of a local
mesh (``MeshSpec.members_per_device``) on the run's device, or, under
``MeshSpec(cluster=True)``, over the ranks of the live
``torch.distributed`` group, ``REPRO_LOCAL_DEVICES`` members a process and
their model ways (``launch.mesh.make_cluster_mesh``; each rank trains on
its pod's rows of the batch).  Under a model axis the pipeline runs on full leaves over the
mesh's data view, and each member keeps its columns
(``optim.dist.ModelGatheredUpdate``), as the reference's shard_map with
params ``P()`` does:

* ``zero1``: ``make_distributed_update``, the monolithic reduce, apply and
  broadcast; ``wire_format="topk"`` takes the error-feedback update
  (``make_topk_ef_update``), int8 rides the plain pipeline through the
  bound backend, and ``comm.overlap`` the §3.1 backprop-overlapped step
  (``train.make_overlapped_train_step`` over ``make_overlapped_update``),
  under every wire format but top-k, which ``RunSpec`` refuses with
  overlap;
* ``stale-sync``: ``make_stale_sync_update``, the same pipeline with the
  reduce applied one step late;
* ``gossip``: ``make_distributed_update`` with the reduce phase on the
  GossipGraD partner exchange (``MODE_CAPS["gossip"].default_backend``),
  on a flat schedule by default, so that the rotation spans the whole
  group.

``comm=None`` takes the mode's default: hierarchical iff the mesh has a pod
axis, and on a cluster mesh the pallas-ring backend at both levels, as the
reference's cluster CLI makes it (over gloo the plain reduce-scatter would
sum a card's buffers in host memory, and ``core.collectives.part_reduce``
refuses that); gossip stays flat.  ``comm="auto"`` is resolved first, before
``init_fn``, since the strip layout depends on the bucket plan: the
autotuner (``telemetry.autotune``) times the real collectives on the live
mesh and picks the bucket size, backend and wire format from the §3.2
balance model with the measured constants.  On a card the run holds f32
(``device.hold_f32``: no TF32 in cuDNN or cuBLAS).  The reference's refusal
of ``comm.overlap`` with model ways raises before anything is allocated.
"""
from __future__ import annotations

import os

from repro_torch.api.families import FamilyAdapter, adapter_for
from repro_torch.api.run import Run
from repro_torch.api.serve import Server
from repro_torch.api.spec import MODE_CAPS, RunSpec, ServeSpec
from repro_torch.comm.bucketer import CommConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sharding import ShardingCtx
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.device import hold_f32, resolve_device
from repro_torch.launch.mesh import make_cluster_mesh, make_local_mesh
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
    GspmdUpdate,
    make_distributed_update,
    make_model_gathered,
    make_overlapped_update,
    make_stale_sync_update,
    make_topk_ef_update,
)
from repro_torch.telemetry import ENV_AUTOTUNE_CACHE, autotune_comm, \
    make_recorder
from repro_torch.train import make_overlapped_train_step, make_train_step

#: the parallel modes compile_run assembles
PORTED_MODES = ("serial", "dp", "zero1", "zero1-gspmd", "stale-sync",
                "gossip")


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


def _check_ported(spec: RunSpec, model_ways=None) -> None:
    """Raise for what the port does not run yet, before any allocation
    (``model_ways``: a caller-built mesh's, else ``spec.mesh``'s)."""
    if spec.parallel not in PORTED_MODES:
        raise NotImplementedError(
            f"parallel={spec.parallel!r} is not ported yet (ROADMAP.md "
            f"Queue A item 9): the port runs parallel in {PORTED_MODES}")
    M = spec.mesh.model_ways if model_ways is None else model_ways
    if spec.parallel == "serial" or M == 1:
        return
    if isinstance(spec.comm, CommConfig) and spec.comm.overlap:
        raise ValueError(
            "CommConfig.overlap runs the whole step inside a shard_map over "
            "the data axes with a mesh-free loss — a model axis would be "
            "silently replicated (full redundant compute per model member), "
            "so overlap currently requires model_ways == 1 "
            f"(got model_ways={M})")


def default_comm(parallel: str, cluster: bool = False,
                 two_level: bool = False) -> CommConfig:
    """The ``CommConfig`` a run of ``parallel`` takes when its spec leaves
    ``comm`` unset, and the base of ``comm="auto"``'s probes: gossip flat on
    its own backend (a hierarchical schedule would scope the partner
    rotation to each pod); on a cluster the two-level schedule with the pallas-ring backend at both
    levels (module docstring); else the lax backend, two-level iff the mesh
    has a pod axis (``two_level``)."""
    if parallel == "gossip":
        return CommConfig(backend=MODE_CAPS[parallel].default_backend,
                          hierarchical=False)
    if cluster:
        return CommConfig(hierarchical=True, backend="pallas-ring",
                          cross_backend="pallas-ring")
    return CommConfig(hierarchical=two_level)


def _resolve_comm(spec: RunSpec, params, mesh, recorder) -> CommConfig:
    """The run's ``CommConfig``: the spec's, the mode's default for None,
    or the autotuner's measured plan for ``"auto"`` (module docstring)."""
    caps = MODE_CAPS[spec.parallel]
    axes = mesh.data_axes
    default = default_comm(spec.parallel, spec.mesh.cluster, len(axes) == 2)
    if spec.comm is None:
        return default
    if spec.comm != "auto":
        return spec.comm
    reps = getattr(spec.telemetry, "autotune_reps", 2)
    with recorder.span("autotune", mode=spec.parallel):
        return autotune_comm(
            params, mesh, axes, default, recorder=recorder,
            backends=caps.backends, reps=reps,
            wire_formats=caps.wire_formats,
            cache_path=os.environ.get(ENV_AUTOTUNE_CACHE))


def compile_run(spec: RunSpec, device=None, recorder=None,
                mesh=None) -> Run:
    """Assemble a ready-to-train :class:`Run` from ``spec``.

    ``device`` defaults to the GPU (under ``cluster``, rank r's
    ``cuda:(r % cards)``) and raises when none is visible; pass
    ``device="cpu"`` to run on the CPU.  On a card it turns TF32 off for
    the process (``device.hold_f32``).  ``recorder`` receives the
    trainer's, the train step's and the update phases' spans and the
    trainer's counts; None builds ``make_recorder(spec.telemetry)``.  ``mesh`` replaces the mesh ``spec.mesh`` describes with
    one the caller built (``launch.mesh.make_process_mesh`` over the live
    process group, model ways and all), on its device.
    """
    cfg = _resolve_config(spec)
    _check_ported(spec, None if mesh is None else mesh.model_ways)
    dev = resolve_device(device)
    family = adapter_for(cfg)
    if recorder is None:
        recorder = make_recorder(spec.telemetry)
    if mesh is not None:
        dev = mesh.device
    elif spec.parallel != "serial":
        if spec.mesh.cluster:
            mesh = make_cluster_mesh(spec.mesh.model_ways, device=device)
            dev = mesh.device
        else:
            mesh = make_local_mesh(spec.mesh.members_per_device,
                                   pods=spec.mesh.pods,
                                   model_ways=spec.mesh.model_ways,
                                   device=dev)
    ctx = ShardingCtx(mesh)
    loss_fn = family.make_loss(cfg, ctx)
    hold_f32(dev)
    specs = family.param_specs(cfg)
    params = ctx.place(family.init(cfg, spec.seed, dev), specs)
    optimizer = _make_optimizer(spec, family)
    lr_schedule = _make_schedule(spec,
                                 1 if mesh is None else mesh.data_size)
    dist_update = comm = train_step = None
    if spec.parallel in ("dp", "zero1-gspmd"):
        dist_update = GspmdUpdate(optimizer, mesh, ctx, specs,
                                  zero1=spec.parallel == "zero1-gspmd")
        opt_state = dist_update.init_fn(params)
    elif spec.parallel != "serial":
        axes = mesh.data_axes
        comm = _resolve_comm(spec, ctx.full(params, specs),
                             mesh.data_view(), recorder)
        if spec.parallel == "stale-sync":
            make_update = make_stale_sync_update
        elif comm.overlap:
            # §3.1: each bucket's reduce is issued inside the backward pass
            # (spec validation keeps topk off this path; _check_ported
            # model ways)
            init_fn, dist_update = make_overlapped_update(
                optimizer, mesh, data_axes=axes, comm=comm,
                recorder=recorder)
            train_step = make_overlapped_train_step(
                loss_fn, lr_schedule, mesh, axes, comm, dist_update,
                grad_clip=spec.grad_clip, recorder=recorder)
        else:
            # the error-feedback residual of topk needs the state carry of
            # the EF composition (spec validation pinned topk to monolithic
            # zero1)
            make_update = make_topk_ef_update \
                if comm.wire_format == "topk" else make_distributed_update
        if train_step is None:
            init_fn, dist_update = make_model_gathered(
                make_update, optimizer, mesh, ctx, specs, data_axes=axes,
                comm=comm, recorder=recorder)
        opt_state = init_fn(params)
    else:
        opt_state = optimizer.init(params)
    if train_step is None:
        train_step = make_train_step(loss_fn, optimizer, lr_schedule,
                                     grad_clip=spec.grad_clip,
                                     dist_update=dist_update,
                                     recorder=recorder)
    return Run(spec=spec, cfg=cfg, family=family, device=dev,
               loss_fn=loss_fn, optimizer=optimizer, lr_schedule=lr_schedule,
               train_step=train_step, params=params, opt_state=opt_state,
               mesh=mesh, comm=comm, dist_update=dist_update,
               telemetry=recorder, ctx=ctx)


def compile_serve(spec: ServeSpec, params=None, device=None,
                  recorder=None) -> Server:
    """Assemble a live :class:`~repro_torch.api.serve.Server` from ``spec``.

    ``params`` serves given weights (e.g. the reference's, carried over by
    ``interop.params_from_numpy``); ``None`` initializes fresh ones from
    ``spec.seed``.  ``device`` defaults to the GPU and raises when none is
    visible; pass ``device="cpu"`` to run on the CPU.  ``recorder`` receives
    prefill/decode spans and preempt events.  The archs the reference
    rejects are rejected here with the same reasons, before any buffer is
    allocated.
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

    dev = resolve_device(device)
    if params is None:
        params = transformer.init_params(cfg, spec.seed, dev)
    return Server(spec=spec, cfg=cfg, params=params, device=dev,
                  recorder=recorder)
