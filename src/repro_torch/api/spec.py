"""Declarative serving description of the port (``repro.api.spec.ServeSpec``)."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Union

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
