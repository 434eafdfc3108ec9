"""Declarative run and serving descriptions of the port
(``repro.api.spec``): ``RunSpec`` is WHAT to train, ``ServeSpec`` WHAT to
serve.

``RunSpec`` accepts every parallel mode name of the reference, validated as
the reference validates it, but ``compile_run`` assembles only ``serial`` so
far; the distributed modes and their ``comm`` knobs (``CommConfig``) come
with the §3.4 ring slice.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional, Union

PARALLEL_MODES = ("serial", "dp", "zero1", "zero1-gspmd", "stale-sync",
                  "gossip")
# the modes that take the explicit bucketed ``comm`` knobs
COMM_MODES = ("zero1", "stale-sync", "gossip")
OPTIMIZERS = ("adamw", "sgd")
SCHEDULES = ("warmup_cosine", "constant", "linear-scale-warmup")


@dataclass(frozen=True)
class RunSpec:
    """Declarative description of one training run.

    arch:       registry id or a concrete config object of a ported family.
    smoke:      reduce the config to the family's CPU-sized smoke variant.
    parallel:   one of ``PARALLEL_MODES``; only ``"serial"`` is ported.
    comm:       the explicit bucketed modes' communication knobs: ``None``,
                or ``"auto"`` on a comm mode (``COMM_MODES``).  A
                ``CommConfig`` is not ported yet.
    optimizer:  ``"adamw"`` / ``"sgd"``; ``None`` = family default (momentum
                SGD for the paper's CNNs).
    """
    arch: Union[str, Any]
    smoke: bool = False
    parallel: str = "serial"
    comm: Optional[str] = None
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
        if isinstance(self.comm, str):
            if self.comm != "auto":
                raise ValueError(
                    f"comm accepts a CommConfig, None, or the string "
                    f"'auto', got {self.comm!r}")
            if self.parallel not in COMM_MODES:
                raise ValueError(
                    "comm='auto' measures the explicit bucketed collectives "
                    f"— only the comm-capable modes {COMM_MODES} run them; "
                    f"parallel={self.parallel!r} does not")
        elif self.comm is not None:
            raise NotImplementedError(
                "CommConfig is not ported yet: comm takes None or 'auto'")

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
