"""Roofline terms of one member's step (``repro.core.roofline``).

Three terms per (arch x shape x mesh), each in seconds a step on one
device:

    compute    = FLOPs per device / peak FLOP/s
    memory     = bytes per device / HBM bytes/s
    collective = sum over collectives of ring-model bytes / link bytes/s

The reference reads the FLOPs and bytes from XLA's ``cost_analysis`` of
the compiled SPMD module and the collectives from its HLO text
(``parse_collectives``).  The port has no compiler: ``launch.dryrun`` runs
one member's program on ``meta`` tensors and counts it.

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode``'s total (the
  products: ``mm``, ``addmm``, ``bmm``, convolutions, attention).
- Bytes, which the flop counter does not give, by one rule for every pair
  (:class:`ByteCounter`): each aten operator the step dispatches reads
  every tensor operand once and writes every tensor result once, except
  views and allocations, which move nothing.  Eager PyTorch runs the
  operators so, unfused; XLA's fused count is lower.
- Collectives: ``core.collectives.count_collectives``, which every
  collective call of a member reports to while it is active (kind, bytes,
  group size), charged the bandwidth-optimal ring cost of
  :func:`ring_cost`, the reference's:

    all-gather          (n-1)/n * result_bytes     (result = full tensor)
    reduce-scatter      (n-1)/n * operand_bytes
    all-reduce          2*(n-1)/n * result_bytes
    all-to-all          (n-1)/n * result_bytes
    collective-permute  result_bytes

The terms divide by the port's H100 entry for bf16 tensor-core work
(``configs.base.H100_SXM_BF16``: data-sheet constants, so the terms are
modelled, not measured), and :attr:`RooflineReport.mfu` divides by its
peak, where the reference hard-codes the TPU v5e's 197e12.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import H100_SXM_BF16

KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "collective-permute")


def ring_cost(kind: str, nbytes: float, group: int) -> float:
    """Link-traversal bytes of one collective of ``kind`` moving
    ``nbytes`` (the module docstring's table) over ``group`` members."""
    frac = (group - 1) / group if group > 1 else 0.0
    if kind == "all-reduce":
        return 2.0 * frac * nbytes
    if kind == "collective-permute":
        return float(nbytes)
    if kind in KINDS:
        return frac * nbytes
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)
    ring_bytes: float = 0.0      # link-traversal bytes after ring discount

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, nbytes: int, group: int) -> None:
        """Record one collective (:func:`ring_cost`)."""
        self.ring_bytes += ring_cost(kind, nbytes, group)
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


class ByteCounter(TorchDispatchMode):
    """Bytes moved by the aten operators dispatched while it is active, by
    the module docstring's rule: each operator's tensor operands and
    results once, views and allocations none."""

    _SKIP = {torch.ops.aten.empty.memory_format,
             torch.ops.aten.empty_strided.default,
             torch.ops.aten.empty_like.default,
             torch.ops.aten.new_empty.default,
             torch.ops.aten.new_empty_strided.default}

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func in self._SKIP):
            self.bytes += sum(_nbytes(t) for t in tree_leaves(
                (args, kwargs or {}))) + sum(_nbytes(t)
                                             for t in tree_leaves(out))
        return out


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_dev: float
    bytes_per_dev: float
    coll: CollectiveStats
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_total: float
    mem_state_per_dev_bytes: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs summed over devices): below 1 by
        recompute (remat), work the members repeat alike and attention;
        above 1 where the closed form counts weights that no product reads
        (an untied embedding's lookup)."""
        total = self.flops_per_dev * self.n_devices
        return self.model_flops_total / total if total else 0.0

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline-implied step time, at
        the hardware entry's peak."""
        t = self.step_time_s
        if not t:
            return 0.0
        return self.model_flops_total / (
            self.n_devices * H100_SXM_BF16.peak_flops * t)

    def row(self) -> dict:
        """The reference's row keys, with ``mem_state_per_dev_gb`` in place
        of its ``mem_per_dev_gb`` (XLA's ``memory_analysis`` has no
        counterpart: the state one device holds, activations not in
        it)."""
        return dict(
            arch=self.arch, shape=self.shape, mesh=self.mesh,
            devices=self.n_devices,
            flops_per_dev=self.flops_per_dev,
            bytes_per_dev=self.bytes_per_dev,
            coll_bytes=self.coll.total_bytes,
            coll_ring_bytes=self.coll.ring_bytes,
            coll_counts=dict(self.coll.count_by_kind),
            compute_s=self.compute_s, memory_s=self.memory_s,
            collective_s=self.collective_s, dominant=self.dominant,
            model_flops=self.model_flops_total,
            useful_ratio=self.useful_flops_ratio,
            mem_state_per_dev_gb=self.mem_state_per_dev_bytes / 2**30,
            mfu=self.mfu,
        )


def analyze(arch: str, shape: str, mesh_desc: str, n_devices: int,
            flops: float, nbytes: float, coll: CollectiveStats,
            model_flops_total: float,
            mem_state_per_dev_bytes: float = 0.0) -> RooflineReport:
    """The report of one member's counted FLOPs, bytes and collectives."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_desc, n_devices=n_devices,
        flops_per_dev=float(flops), bytes_per_dev=float(nbytes), coll=coll,
        compute_s=flops / H100_SXM_BF16.peak_flops,
        memory_s=nbytes / H100_SXM_BF16.mem_bw,
        collective_s=coll.ring_bytes / H100_SXM_BF16.link_bw,
        model_flops_total=model_flops_total,
        mem_state_per_dev_bytes=mem_state_per_dev_bytes,
    )
