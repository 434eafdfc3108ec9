"""Gradient bucketing (``repro.comm.bucketer``): coalesce a tensor tree into
fixed-byte fusion buffers.

The plan is computed on the host from the leaves' shapes and dtypes alone
(greedy first fit in tree order, a new bucket on each dtype change, like
PyTorch DDP's gradient buckets), so it works on ``device="meta"`` tensors and
equals the reference's plan slot for slot.  Each bucket is padded to a
multiple of the group size G, so that one part-reduce / part-broadcast pair
moves the whole bucket and every member owns an equal 1-D strip of it (the
paper's §3.4 strip scheme, applied per bucket instead of per tensor).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import padded_size
from repro_torch.core.params import tree_leaves

#: gradient wire formats (``CommConfig.wire_format``), as in the reference;
#: the port moves ``fp32`` and ``bf16``, and ``int8`` / ``topk`` raise "not
#: ported yet" when a backend is asked to reduce with them
WIRE_FORMATS = ("fp32", "bf16", "int8", "topk")

#: wire_format implied by each reduce_dtype when ``wire_format`` is unset
_DTYPE_FORMATS = {"float32": "fp32", "bfloat16": "bf16"}


@dataclass(frozen=True)
class CommConfig:
    """Knobs of the gradient-communication subsystem, every field and check
    of the reference's (``repro.comm.bucketer.CommConfig``).

    bucket_bytes:  target fusion-buffer size; ``<= 0`` gives one bucket per
                   tensor.  A tensor larger than the target gets a bucket of
                   its own (buckets never split a tensor).
    reduce_dtype:  wire dtype of the gradient part-reduce, ``"float32"`` or
                   ``"bfloat16"``; f32 accumulate after every stage.
    hierarchical:  two-level in-pod + cross-pod schedule on ``("pod",
                   "data")``.
    overlap:       reduce inside the backward pass (not ported yet).
    backend:       collective backend name (``comm.backends``): ``"lax"``
                   (the plain collectives) or ``"pallas-ring"`` (the §3.4
                   ring on the port's hand-written kernels).  Under the
                   hierarchical schedule it drives the in-pod level.
    cross_backend: backend of the cross-pod hop (default ``"lax"``).
    wire_format:   ``None`` derives it from ``reduce_dtype``.
    topk_ratio:    fraction kept per message under ``wire_format="topk"``.
    """
    bucket_bytes: int = 4 * 2**20
    reduce_dtype: str = "float32"
    hierarchical: bool = False
    overlap: bool = False
    backend: str = "lax"
    cross_backend: str = "lax"
    wire_format: Optional[str] = None
    topk_ratio: float = 0.05

    def __post_init__(self):
        if self.reduce_dtype not in _DTYPE_FORMATS:
            raise ValueError(
                f"reduce_dtype must be one of "
                f"{tuple(sorted(_DTYPE_FORMATS))}, got {self.reduce_dtype!r}")
        if self.wire_format is None:
            object.__setattr__(
                self, "wire_format", _DTYPE_FORMATS[self.reduce_dtype])
        if self.wire_format not in WIRE_FORMATS:
            raise ValueError(
                f"wire_format must be one of {WIRE_FORMATS}, "
                f"got {self.wire_format!r}")
        if (self.reduce_dtype == "bfloat16"
                and self.wire_format != "bf16"):
            raise ValueError(
                f"reduce_dtype='bfloat16' implies wire_format='bf16'; "
                f"got conflicting wire_format={self.wire_format!r}")
        if not (0.0 < self.topk_ratio <= 1.0):
            raise ValueError(
                f"topk_ratio must be in (0, 1], got {self.topk_ratio!r}")
        from repro_torch.comm.backends import COLLECTIVE_BACKENDS
        for fld in ("backend", "cross_backend"):
            if getattr(self, fld) not in COLLECTIVE_BACKENDS:
                raise ValueError(
                    f"{fld} must be one of {COLLECTIVE_BACKENDS}, "
                    f"got {getattr(self, fld)!r}")

    @property
    def wire_dtype(self) -> torch.dtype:
        """The dtype buffers are cast to before ``part_reduce``."""
        return torch.bfloat16 if self.wire_format == "bf16" else torch.float32

    @property
    def compressed(self) -> bool:
        return self.wire_format in ("int8", "topk")


@dataclass(frozen=True)
class LeafSlot:
    """Where one tree leaf lives inside its bucket's packed buffer."""
    index: int                 # leaf position in the flattened tree
    shape: Tuple[int, ...]
    size: int                  # number of elements (== prod(shape))
    offset: int                # element offset inside the bucket buffer
    dtype: Optional[str] = None  # leaf dtype name ("float32", "bfloat16")


@dataclass(frozen=True)
class Bucket:
    slots: Tuple[LeafSlot, ...]
    size: int                  # payload elements (sum of slot sizes)
    padded_size: int           # size rounded up to a multiple of the group


@dataclass(frozen=True)
class BucketPlan:
    buckets: Tuple[Bucket, ...]
    group: int                 # G: members of the part-reduce group
    n_leaves: int

    @property
    def n_collectives(self) -> int:
        return len(self.buckets)

    @property
    def total_elements(self) -> int:
        return sum(b.size for b in self.buckets)

    @property
    def total_padded(self) -> int:
        return sum(b.padded_size for b in self.buckets)


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name for a torch dtype (``torch.float32 -> "float32"``)."""
    return str(dtype).removeprefix("torch.")


def plan_buckets(tree: Any, group: int, bucket_bytes: int,
                 itemsize: int = 4) -> BucketPlan:
    """Greedy first-fit bucket assignment over ``tree``'s leaves in tree
    (sorted-key) order.  Shapes and dtypes only, so meta tensors plan full
    widths without memory.  A dtype change in tree order closes the current
    bucket; ``itemsize`` is only the fallback for leaves with no dtype."""
    leaves = tree_leaves(tree)
    cap = math.inf if bucket_bytes is None else bucket_bytes
    buckets: List[Bucket] = []
    slots: List[LeafSlot] = []
    fill = fill_bytes = 0
    cur_dtype: Optional[str] = None

    def close():
        nonlocal slots, fill, fill_bytes
        if slots:
            buckets.append(Bucket(tuple(slots), fill,
                                  padded_size(fill, group)))
        slots, fill, fill_bytes = [], 0, 0

    for i, leaf in enumerate(leaves):
        shape = tuple(int(d) for d in leaf.shape)
        size = math.prod(shape)
        dt = getattr(leaf, "dtype", None)
        dt_name = None if dt is None else dtype_name(dt)
        isz = itemsize if dt is None else dt.itemsize
        nbytes = size * isz
        if cap <= 0:
            buckets.append(Bucket((LeafSlot(i, shape, size, 0, dt_name),),
                                  size, padded_size(size, group)))
            continue
        if slots and (fill_bytes + nbytes > cap or dt_name != cur_dtype):
            close()
        cur_dtype = dt_name
        slots.append(LeafSlot(i, shape, size, fill, dt_name))
        fill += size
        fill_bytes += nbytes
        if fill_bytes >= cap:
            close()
    close()
    return BucketPlan(tuple(buckets), group, len(leaves))


def pack_bucket(flat_leaves: Sequence[torch.Tensor],
                bucket: Bucket) -> torch.Tensor:
    """Concatenate the bucket's leaves into one padded 1-D fusion buffer.
    A bucket of one leaf that needs no padding is a view of that leaf."""
    parts = [flat_leaves[s.index].reshape(-1) for s in bucket.slots]
    pad = bucket.padded_size - bucket.size
    if len(parts) == 1:
        return F.pad(parts[0], (0, pad)) if pad else parts[0]
    if pad:
        parts.append(parts[0].new_zeros(pad))
    return torch.cat(parts)


def unpack_bucket(buf: torch.Tensor, bucket: Bucket
                  ) -> Iterator[Tuple[int, torch.Tensor]]:
    """(leaf index, leaf view) of each slot of one fusion buffer."""
    for s in bucket.slots:
        yield s.index, buf[s.offset:s.offset + s.size].reshape(s.shape)


def unpack_buckets(buffers: Sequence[torch.Tensor],
                   plan: BucketPlan) -> List[torch.Tensor]:
    """Slice the fusion buffers back into leaves (tree order), restoring
    each leaf's recorded dtype."""
    out: List[torch.Tensor] = [None] * plan.n_leaves
    for buf, bucket in zip(buffers, plan.buckets):
        for s, (i, leaf) in zip(bucket.slots, unpack_bucket(buf, bucket)):
            if s.dtype is not None and dtype_name(leaf.dtype) != s.dtype:
                leaf = leaf.to(getattr(torch, s.dtype))
            out[i] = leaf
    return out
