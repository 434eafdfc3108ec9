"""Declarative run and serving descriptions of the port
(``repro.api.spec``): ``RunSpec`` is WHAT to train, ``ServeSpec`` WHAT to
serve.

``RunSpec`` accepts every parallel mode name of the reference and validates
it, its ``MeshSpec`` and its ``CommConfig`` as the reference does
(``MODE_CAPS``); ``compile_run`` assembles every mode, with model ways on
every family (on a cluster mesh they raise "not ported yet", ROADMAP Queue
A item 9d).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Optional, Tuple, Union

from repro_torch.comm.bucketer import CommConfig


@dataclass(frozen=True)
class ModeCaps:
    """What one parallel mode supports (the reference's table): does it
    take the ``comm`` knobs, does it run the overlapped step, which
    collective backends and wire formats its reduce phase accepts."""
    comm: bool = False
    overlap: bool = False
    backends: Optional[Tuple[str, ...]] = None
    default_backend: Optional[str] = None
    wire_formats: Optional[Tuple[str, ...]] = None


MODE_CAPS = {
    "serial": ModeCaps(),
    "dp": ModeCaps(),
    "zero1": ModeCaps(comm=True, overlap=True,
                      backends=("lax", "pallas-ring"),
                      wire_formats=("fp32", "bf16", "int8", "topk")),
    "zero1-gspmd": ModeCaps(),
    "stale-sync": ModeCaps(comm=True, backends=("lax", "pallas-ring"),
                           wire_formats=("fp32", "bf16", "int8")),
    "gossip": ModeCaps(comm=True, backends=("gossip",),
                       default_backend="gossip",
                       wire_formats=("fp32", "bf16")),
}

PARALLEL_MODES = tuple(MODE_CAPS)
# the modes that take the explicit bucketed ``comm`` knobs
COMM_MODES = tuple(m for m, c in MODE_CAPS.items() if c.comm)
OPTIMIZERS = ("adamw", "sgd")
SCHEDULES = ("warmup_cosine", "constant", "linear-scale-warmup")


@dataclass(frozen=True)
class TelemetrySpec:
    """Telemetry knobs of a run (``RunSpec.telemetry``).

    trace_dir:       write per-process JSONL event files here (one
                     ``trace_p<i>.jsonl`` per cluster process) and a merged
                     Chrome trace ``trace.json`` at ``Run.close`` (by the
                     supervisor for cluster runs).  ``None`` keeps the
                     events in memory: listeners (the cluster heartbeat)
                     still see them, nothing touches the disk.
    autotune_reps:   timed repetitions per probe buffer when
                     ``RunSpec.comm="auto"`` measures the collectives.
    """
    trace_dir: Optional[str] = None
    autotune_reps: int = 2

    def __post_init__(self):
        if self.autotune_reps < 1:
            raise ValueError(
                f"autotune_reps must be >= 1, got {self.autotune_reps}")


@dataclass(frozen=True)
class MeshSpec:
    """Member topology of the parallel modes: axes ``("pod", "data",
    "model")`` when ``pods > 1``, ``("data", "model")`` otherwise (the
    reference's).

    members_per_device: the G data-parallel members, all on the run's one
                        device along a leading member dimension
                        (``launch.mesh.LocalMesh``); the data extent is
                        ``members_per_device / pods``.  The reference takes
                        its G from the visible (forced host) devices instead;
                        a card cannot be split by a flag.
    pods:               pods of the hierarchical schedule.
    model_ways:         model-parallel ways within each data member (paper
                        §3.3): the local mesh holds members_per_device x
                        model_ways members, each model member the columns
                        of every "ff"-sharded leaf (``core.sharding``); the
                        CNN and DNN families (> 1 on an LM or a cluster
                        raises in ``compile_run``).
    cluster:            one member per process of the live
                        ``torch.distributed`` group
                        (``launch.mesh.make_cluster_mesh``): the pod axis is
                        the process boundary, ``(world, 1)`` members, one
                        member a process; at world 1 a one-member local
                        mesh.  ``members_per_device`` is then unused.
    """
    pods: int = 1
    model_ways: int = 1
    cluster: bool = False
    members_per_device: int = 1

    def __post_init__(self):
        if self.pods < 1 or self.model_ways < 1:
            raise ValueError(f"pods/model_ways must be >= 1, got "
                             f"{self.pods}/{self.model_ways}")
        if self.members_per_device < 1 or self.members_per_device % self.pods:
            raise ValueError(
                f"members_per_device={self.members_per_device} must be a "
                f"positive multiple of pods={self.pods}")


@dataclass(frozen=True)
class RunSpec:
    """Declarative description of one training run.

    arch:       registry id or a concrete config object of a ported family.
    smoke:      reduce the config to the family's CPU-sized smoke variant.
    parallel:   one of ``PARALLEL_MODES``, all ported.
    mesh:       member topology of the non-serial modes (ignored for
                ``serial``).
    comm:       the explicit bucketed modes' communication knobs: a
                ``CommConfig``, ``None`` (the mode's default: hierarchical
                iff the mesh has a pod axis, gossip flat), or ``"auto"``
                (the measured plan of ``telemetry.autotune``).
    optimizer:  ``"adamw"`` / ``"sgd"``; ``None`` = family default (momentum
                SGD for the paper's CNNs).
    ckpt_every / ckpt_dir: a checkpoint every ``ckpt_every`` steps into
                ``ckpt_dir`` (``checkpoint.ckpt``); ``Run.fit`` resumes
                from the latest one there.
    telemetry:  a ``TelemetrySpec``, a trace-dir string, or ``None``.
    """
    arch: Union[str, Any]
    smoke: bool = False
    parallel: str = "serial"
    mesh: MeshSpec = field(default_factory=MeshSpec)
    comm: Union[CommConfig, str, None] = None
    # optimizer + schedule
    optimizer: Optional[str] = None
    lr: float = 1e-3
    weight_decay: Optional[float] = None   # None = optimizer default
    momentum: float = 0.9
    schedule: str = "warmup_cosine"
    warmup_steps: Optional[int] = None     # None = steps // 20 (min 1)
    grad_clip: float = 1.0
    # trainer / data
    steps: int = 50
    batch: int = 8
    seq: int = 128
    seed: int = 0
    log_every: int = 5
    ckpt_every: int = 0                    # 0 = disabled
    ckpt_dir: Optional[str] = None
    telemetry: Union[TelemetrySpec, str, None] = None

    def __post_init__(self):
        if self.parallel not in PARALLEL_MODES:
            raise ValueError(f"parallel must be one of {PARALLEL_MODES}, "
                             f"got {self.parallel!r}")
        if self.optimizer is not None and self.optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer must be one of {OPTIMIZERS}, "
                             f"got {self.optimizer!r}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, "
                             f"got {self.schedule!r}")
        if self.steps < 1:
            raise ValueError(f"steps must be >= 1, got {self.steps}")
        caps = MODE_CAPS[self.parallel]
        if isinstance(self.telemetry, str):
            # a bare trace-dir string is the common hand-written case
            object.__setattr__(self, "telemetry",
                               TelemetrySpec(trace_dir=self.telemetry))
        elif self.telemetry is not None and not isinstance(self.telemetry,
                                                           TelemetrySpec):
            raise ValueError(
                "telemetry must be a TelemetrySpec, a trace-dir string or "
                f"None, got {type(self.telemetry).__name__}")
        if isinstance(self.comm, str):
            if self.comm != "auto":
                raise ValueError(
                    f"comm accepts a CommConfig, None, or the string "
                    f"'auto', got {self.comm!r}")
            if not caps.comm:
                raise ValueError(
                    "comm='auto' measures the explicit bucketed collectives "
                    f"— only the comm-capable modes {COMM_MODES} run them; "
                    f"parallel={self.parallel!r} does not")
        elif self.comm is not None:
            if not isinstance(self.comm, CommConfig):
                raise ValueError(
                    f"comm accepts a CommConfig, None, or the string "
                    f"'auto', got {type(self.comm).__name__}")
            if not caps.comm:
                raise ValueError(
                    "comm (bucket size / wire dtype / hierarchical) only "
                    "applies to the explicit bucketed modes "
                    f"{COMM_MODES} — parallel={self.parallel!r} does not take "
                    "it")
            if self.comm.overlap and not caps.overlap:
                overlappy = tuple(m for m, c in MODE_CAPS.items()
                                  if c.overlap)
                raise ValueError(
                    "comm.overlap (the §3.1 backward-pass reduce schedule) "
                    f"is only supported by {overlappy} — "
                    f"parallel={self.parallel!r} does not run the "
                    "overlapped train step")
            name = self.comm.backend
            if caps.backends is not None and name not in caps.backends:
                raise ValueError(
                    f"collective backend {name!r} is not valid under "
                    f"parallel={self.parallel!r}; this mode supports "
                    f"{caps.backends}. The gossip backend changes the "
                    "consistency model, so it is selected by "
                    "parallel='gossip', not as a zero1 backend swap")
            fmt = self.comm.wire_format
            if caps.wire_formats is not None and fmt not in caps.wire_formats:
                raise ValueError(
                    f"wire_format {fmt!r} is not valid under "
                    f"parallel={self.parallel!r}; this mode supports "
                    f"{caps.wire_formats}. The topk format carries an "
                    "error-feedback residual whose semantics are defined "
                    "only for the synchronous zero1 pipeline")
            if fmt == "topk" and self.comm.overlap:
                raise ValueError(
                    "wire_format='topk' cannot run under comm.overlap: the "
                    "backward-pass reduce taps are stateless, so the "
                    "error-feedback residual has nowhere to live (int8 and "
                    "the dense formats overlap fine)")

    def replace(self, **kw) -> "RunSpec":
        return replace(self, **kw)


SCHEDULER_POLICIES = ("static", "continuous")
# "kernel" is the port's name for the reference's "pallas"
PAGED_ATTN_IMPLS = ("gather", "kernel")


@dataclass(frozen=True)
class ServeSpec:
    """One serving deployment: WHAT to serve and under WHICH budgets;
    ``compile_serve`` (``repro_torch.api.assemble``) turns it into a live
    :class:`~repro_torch.api.serve.Server`.

    arch:            registry id or a concrete ``ModelConfig``; a
                     token-in/token-out attention-block transformer.
    smoke:           reduce to the family's CPU-sized smoke variant.
    max_batch:       concurrent decode slots.
    page_size:       tokens per KV page.
    num_pages:       physical pages in each layer's pool (page 0 is the
                     reserved null page) — the cache budget the scheduler
                     admits and preempts against.
    max_prompt:      longest admissible prompt.
    max_new_tokens:  per-request decode budget (requests may ask for less).
    max_queue:       ``submit`` beyond this backlog raises.
    scheduler:       ``"continuous"`` (refill free slots every step) or
                     ``"static"`` (admit a wave, decode until all of it
                     finishes).
    attn_impl:       paged decode attention: ``"kernel"`` (the Hopper
                     kernel; on CPU tensors its plain version) or
                     ``"gather"`` (the plain version everywhere).
    temperature:     0 = greedy, else categorical sampling.
    prefill_bucket:  prompts are right-padded to the next power-of-two
                     bucket >= this.
    """
    arch: Union[str, Any]
    smoke: bool = False
    max_batch: int = 4
    page_size: int = 16
    num_pages: int = 128
    max_prompt: int = 64
    max_new_tokens: int = 32
    max_queue: int = 1024
    scheduler: str = "continuous"
    attn_impl: str = "kernel"
    temperature: float = 0.0
    seed: int = 0
    prefill_bucket: int = 16

    def __post_init__(self):
        if self.scheduler not in SCHEDULER_POLICIES:
            raise ValueError(f"scheduler must be one of {SCHEDULER_POLICIES},"
                             f" got {self.scheduler!r}")
        if self.attn_impl not in PAGED_ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {PAGED_ATTN_IMPLS}, "
                             f"got {self.attn_impl!r}")
        for fld in ("max_batch", "page_size", "max_prompt", "max_new_tokens",
                    "max_queue", "prefill_bucket"):
            if getattr(self, fld) < 1:
                raise ValueError(f"{fld} must be >= 1, "
                                 f"got {getattr(self, fld)}")
        if self.num_pages - 1 < self.pages_per_request:
            raise ValueError(
                f"num_pages={self.num_pages} (1 reserved null page) cannot "
                f"hold even one max-length request "
                f"({self.pages_per_request} pages for "
                f"{self.max_context} tokens @ page_size={self.page_size})")

    @property
    def max_context(self) -> int:
        """Positions one request can occupy: prompt + decode budget."""
        return self.max_prompt + self.max_new_tokens

    @property
    def pages_per_request(self) -> int:
        """Page-table width: logical pages covering ``max_context``."""
        return -(-self.max_context // self.page_size)

    def replace(self, **kw) -> "ServeSpec":
        return replace(self, **kw)
