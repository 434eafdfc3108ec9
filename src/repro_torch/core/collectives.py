"""Paper §3.4 — the two communication primitives, plain
(``repro.core.collectives``).

    part-reduce    = reduce partial tensors over a member group, scatter the
                     result strips  (MPI_Reduce_scatter)
    part-broadcast = every member broadcasts its strip to the group
                     (MPI_Allgather)

The reference calls them inside ``jax.shard_map``, where the mesh is
implicit; here the mesh is an argument (``launch.mesh``), and each
collective gives its two forms to ``mesh.collective``, which runs the one
that fits its layout:

* on a :class:`~repro_torch.launch.mesh.LocalMesh` a member tensor is
  ``(M, N)``, row m member m's buffer: part-reduce sums a group's rows and
  cuts the sum into strips, part-broadcast tiles a group's strips;
* on a :class:`~repro_torch.launch.mesh.ProcessMesh` a member tensor is this
  rank's ``(N,)`` buffer, and the two are ``reduce_scatter_tensor`` /
  ``all_gather_into_tensor`` over the group's process group.

These are the internals of the port's ``lax`` backend, the plain
collectives the ring backend is held against: the same strip ownership
(flat group member i owns chunk i) and the same wire-dtype semantics (they
reduce in the dtype they are handed).  They take the schedules' canonical
1-D buffers (one per member).

The model axis (paper §3.3) adds the functions a column-parallel and a
row-parallel product, expert parallelism and the sequence-sharded decode
need, each a ``torch.autograd.Function`` (``core.sharding.ShardingCtx``):

    copy_to_model     forward the identity, one copy of the input for each
                      model member held here; backward the sum of the
                      members' input gradients over the model group
    gather_model      forward the members' output blocks joined along the
                      last dim; backward each member keeps its own slice
    reduce_from_model forward the sum of the members' partial outputs over
                      the group (the model axis, or the axes a decode
                      cache's sequence is split over); backward the
                      identity to every member
    all_to_all_model  forward: dim 0 split into M blocks, block j sent to
                      model member j; backward the inverse all-to-all
    gather_leaf       forward a model-sharded leaf made whole on every
                      member; backward each member keeps its slice (the
                      leaf must feed a computation every member repeats
                      alike, so that each holds the whole gradient)

and a forward-only ``pmax`` over a group (the decode partials' maximum).

Every ``torch.distributed`` collective of the port goes through
:func:`dist_call` (these functions, ``core.sharding.from_members``, the
process mesh's ``gather_members``, ``optim.dist.GspmdUpdate`` and the
ring's hops).  While :func:`count_collectives` is active it records each
call's kind, bytes and group size (``core.roofline.CollectiveStats``);
otherwise it costs one attribute check.  On ``meta`` tensors, the dry
run's member program (``launch.mesh.ProcessMesh.member_view``), it moves
nothing.
On a local mesh all M model members are here (M copies, a ``cat``, a sum,
a transpose of the ``(M_src, M_dst, ...)`` blocks); on a process mesh the
rank is one of them (``all_reduce``, ``all_gather`` and
``all_to_all_single`` over its model group, staged through host memory
over gloo).  Without a pair, or with one of it doubled, the gradients are
off by a factor M or miss terms, and training still runs.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

AxisNames = Union[str, Tuple[str, ...]]

#: the stats :func:`count_collectives` records into; None when no counter
#: is active
_counter = None


@contextlib.contextmanager
def count_collectives():
    """Record every collective issued inside the block (module docstring):
    yields the ``core.roofline.CollectiveStats`` it fills."""
    from repro_torch.core.roofline import CollectiveStats
    global _counter
    prev, _counter = _counter, CollectiveStats()
    try:
        yield _counter
    finally:
        _counter = prev


def dist_call(kind: str, t: torch.Tensor, n: int, fn, *args, **kw):
    """``fn(*args, **kw)``, a ``torch.distributed`` collective of ``kind``
    (``core.roofline.KINDS``) over a group of ``n`` ranks whose charged
    bytes are ``t``'s (the result, or the operand of a reduce-scatter),
    recorded by the active counter; on a ``meta`` ``t`` nothing runs."""
    if _counter is not None:
        _counter.add(kind, t.numel() * t.element_size(), n)
    if not t.is_meta:
        fn(*args, **kw)


def axes_tuple(axis_name: AxisNames) -> Tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def axis_size(mesh, axis_name: AxisNames) -> int:
    return math.prod(mesh.shape[a] for a in axes_tuple(axis_name))


def group_index(mesh, axis_name: AxisNames, member: int) -> int:
    """Flat member ``member``'s index in its group over ``axis_name``:
    row-major over the axis tuple, THE strip-owner convention every backend
    shares."""
    c = mesh.coords(member)
    i = 0
    for a in axes_tuple(axis_name):
        i = i * mesh.shape[a] + c[a]
    return i


def flat_group_index(mesh, axis_name: AxisNames):
    """Each member's ``group_index``: a tuple with one int per member on a
    local mesh, this rank's int on a process mesh."""
    return mesh.per_member(lambda m: group_index(mesh, axis_name, m))


def _check_1d(x: torch.Tensor, mesh) -> None:
    if x.dim() != 1 + mesh.member_dims:
        raise NotImplementedError(
            "the collectives take one 1-D buffer per member (a (members, N) "
            f"tensor on a local mesh, (N,) on a process mesh); got shape "
            f"{tuple(x.shape)}. Flatten first (flatten_pad).")


def gloo_stages(buf: torch.Tensor, pg) -> bool:
    """True when process group ``pg`` moves ``buf`` through host memory:
    gloo takes host tensors, so a card's buffer is staged (the way ranks
    that share one card talk: NCCL takes one rank per card)."""
    import torch.distributed as dist
    return buf.is_cuda and dist.get_backend(pg) == "gloo"


def staged_for(buf: torch.Tensor, pg) -> torch.Tensor:
    """``buf`` as process group ``pg`` takes it: its host copy when
    :func:`gloo_stages`, else ``buf`` itself.  The one staging of the
    port's process collectives, the ring's hops among them."""
    return buf.cpu() if gloo_stages(buf, pg) else buf


def refuses_plain_reduce(mesh, axis_name: AxisNames) -> bool:
    """True where :func:`part_reduce` refuses the buffers of ``mesh``: a
    process mesh on a card whose group over ``axis_name`` is more than one
    rank over gloo (the test of :func:`gloo_stages`)."""
    axes = axes_tuple(axis_name)
    if mesh.member_dims or axis_size(mesh, axes) <= 1:
        return False
    return gloo_stages(torch.empty(0, device=mesh.device),
                       mesh.group(axes)[0])


def part_reduce(x: torch.Tensor, mesh, axis_name: AxisNames) -> torch.Tensor:
    """Reduce-scatter each member's buffer over the group: member i of the
    group receives the group sum of chunk i.  Paper Fig. 1."""
    _check_1d(x, mesh)
    axes = axes_tuple(axis_name)
    G = axis_size(mesh, axes)
    if x.shape[-1] % G:
        raise ValueError(f"buffer size {x.shape[-1]} not a strip multiple "
                         f"of group {G}")

    def over_ranks(buf):
        import torch.distributed as dist
        pg = mesh.group(axes)[0]
        if G > 1 and gloo_stages(buf, pg):
            raise NotImplementedError(
                "the plain reduce-scatter of a card's buffers over gloo "
                "would sum them in host memory: take the pallas-ring "
                "backend, whose hops add on the card (NCCL, which sums on "
                "the card, takes one rank per card)")
        src = staged_for(buf, pg).contiguous()
        out = src.new_empty(buf.shape[0] // G)
        dist_call("reduce-scatter", src, G, dist.reduce_scatter_tensor,
                  out, src, group=pg)
        return out.to(buf.device)

    return mesh.collective(x, axes, lambda rows: rows.sum(0).reshape(G, -1),
                           over_ranks)


def part_broadcast(x: torch.Tensor, mesh, axis_name: AxisNames
                   ) -> torch.Tensor:
    """All-gather each member's strip over the group: every member ends
    with the group's strips in owner order.  Paper Fig. 2."""
    _check_1d(x, mesh)
    axes = axes_tuple(axis_name)
    G = axis_size(mesh, axes)

    def over_ranks(buf):
        import torch.distributed as dist
        pg = mesh.group(axes)[0]
        src = staged_for(buf, pg).contiguous()
        out = src.new_empty(G * buf.shape[0])
        dist_call("all-gather", out, G, dist.all_gather_into_tensor, out,
                  src, group=pg)
        return out.to(buf.device)

    return mesh.collective(
        x, axes, lambda rows: rows.reshape(1, -1).expand(G, -1), over_ranks)


def psum(x: torch.Tensor, mesh, axis_name: AxisNames) -> torch.Tensor:
    """All-reduce over the group, any member shape."""
    axes = axes_tuple(axis_name)

    def over_ranks(buf):
        import torch.distributed as dist
        out = buf.clone()
        dist_call("all-reduce", out, axis_size(mesh, axes),
                  dist.all_reduce, out, group=mesh.group(axes)[0])
        return out

    return mesh.collective(
        x, axes, lambda rows: rows.sum(0, keepdim=True).expand_as(rows),
        over_ranks)


# ---------------------------------------------------------------------------
# Strip helpers: arbitrary-shaped tensors are flattened and padded so every
# group member owns an equal 1-D strip.
# ---------------------------------------------------------------------------
def padded_size(n: int, group: int) -> int:
    return ((n + group - 1) // group) * group


def flatten_pad(x: torch.Tensor, group: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = padded_size(flat.numel(), group) - flat.numel()
    return F.pad(flat, (0, pad)) if pad else flat


def unflatten(flat: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    return flat[:math.prod(shape)].reshape(shape)


# ---------------------------------------------------------------------------
# The model axis: the two autograd functions of a column-parallel product
# ---------------------------------------------------------------------------
def _model_group(mesh):
    return mesh.group(("model",))


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        n = mesh.model_ways if mesh.member_dims else 1
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        mesh = ctx.mesh
        if mesh.member_dims:
            g = grads[0]
            for other in grads[1:]:
                g = g + other
            return g, None
        import torch.distributed as dist
        g = grads[0]
        pg = _model_group(mesh)[0]
        buf = staged_for(g, pg).clone(memory_format=torch.contiguous_format)
        dist_call("all-reduce", buf, mesh.model_ways, dist.all_reduce,
                  buf, group=pg)
        return buf.to(g.device), None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *ys):
        ctx.mesh = mesh
        if mesh.member_dims:
            ctx.sizes = [y.shape[-1] for y in ys]
            return torch.cat(ys, -1)
        import torch.distributed as dist
        (y,) = ys
        pg, ranks = _model_group(mesh)
        ctx.index, ctx.width = ranks.index(mesh.rank), y.shape[-1]
        src = staged_for(y, pg).contiguous()
        out = src.new_empty(len(ranks) * src.numel())
        dist_call("all-gather", out, len(ranks),
                  dist.all_gather_into_tensor, out, src.reshape(-1),
                  group=pg)
        # (M, ..., c) -> (..., M, c) -> (..., M * c)
        out = out.view(len(ranks), *y.shape).movedim(0, -2)
        return out.reshape(*y.shape[:-1], -1).to(y.device)

    @staticmethod
    def backward(ctx, g):
        if ctx.mesh.member_dims:
            return (None, *(p.contiguous() for p in g.split(ctx.sizes, -1)))
        lo = ctx.index * ctx.width
        return None, g[..., lo:lo + ctx.width].contiguous()


def copy_to_model(x: torch.Tensor, mesh) -> Tuple[torch.Tensor, ...]:
    """The input of a column-parallel product, once per model member held
    here (M on a local mesh, 1 on a process mesh); the backward sums the
    members' gradients over the model group."""
    return _CopyToModel.apply(x, mesh)


def gather_model(ys, mesh) -> torch.Tensor:
    """The model members' output blocks (those held here, in model order)
    joined along the last dim, on every member; the backward hands each
    member its own slice of the output gradient."""
    return _GatherModel.apply(mesh, *ys)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, *ys):
        ctx.n = len(ys)
        if mesh.member_dims:
            out = ys[0]
            for y in ys[1:]:
                out = out + y
            return out
        import torch.distributed as dist
        (y,) = ys
        pg, ranks = mesh.group(axes)
        buf = staged_for(y, pg).clone(memory_format=torch.contiguous_format)
        dist_call("all-reduce", buf, len(ranks), dist.all_reduce, buf,
                  group=pg)
        return buf.to(y.device)

    @staticmethod
    def backward(ctx, g):
        return (None, None, *(g for _ in range(ctx.n)))


def reduce_from_model(ys, mesh, axes: AxisNames = "model") -> torch.Tensor:
    """The sum of the partial outputs ``ys`` of the members held here (in
    group order) over the group of ``axes``, on every member; the backward
    hands every member the whole output gradient.  The sum runs in the
    partials' dtype: a caller that wants one rounding hands f32."""
    return _ReduceFromModel.apply(mesh, axes_tuple(axes), *ys)


@torch.no_grad()
def pmax(ys, mesh, axes: AxisNames = "model") -> torch.Tensor:
    """The elementwise maximum of the members' ``ys`` over the group of
    ``axes``, on every member; forward only (the decode partials)."""
    if mesh.member_dims:
        out = ys[0]
        for y in ys[1:]:
            out = torch.maximum(out, y)
        return out
    import torch.distributed as dist
    (y,) = ys
    pg, ranks = mesh.group(axes_tuple(axes))
    buf = staged_for(y, pg).clone(memory_format=torch.contiguous_format)
    dist_call("all-reduce", buf, len(ranks), dist.all_reduce, buf,
              op=dist.ReduceOp.MAX, group=pg)
    return buf.to(y.device)


def _a2a(xs, mesh):
    """The all-to-all of the members' ``xs`` over the model group: member
    j receives block j of dim 0 of every member's tensor, in member
    order."""
    if mesh.member_dims:
        n = len(xs)
        blocks = [x.chunk(n) for x in xs]
        return tuple(torch.cat([blocks[i][j] for i in range(n)])
                     for j in range(n))
    import torch.distributed as dist
    (x,) = xs
    pg, ranks = _model_group(mesh)
    src = staged_for(x, pg).contiguous()
    out = torch.empty_like(src)
    dist_call("all-to-all", out, len(ranks), dist.all_to_all_single, out,
              src, group=pg)
    return (out.to(x.device),)


class _AllToAllModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return _a2a(xs, mesh)

    @staticmethod
    def backward(ctx, *gs):
        # block j of member i went to member j as its block i: the same
        # exchange sends every gradient block back where it came from
        return (None, *_a2a([g.contiguous() for g in gs], ctx.mesh))


def all_to_all_model(xs, mesh) -> Tuple[torch.Tensor, ...]:
    """``xs`` (one tensor per model member held here, dim 0 a multiple of
    M): dim 0 split into M blocks and block j sent to model member j,
    which gets the M blocks addressed to it in member order.  On a local
    mesh a transpose of the ``(M_src, M_dst, ...)`` blocks; on a process
    mesh ``all_to_all_single`` over the model group.  The backward is the
    inverse all-to-all.  With one model member, ``xs`` itself."""
    if mesh.shape.get("model", 1) == 1:
        return tuple(xs)
    return _AllToAllModel.apply(mesh, *xs)


class _GatherLeafRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, spec, mesh):
        from repro_torch.core.sharding import from_members
        ctx.spec, ctx.mesh = spec, mesh
        return from_members(w, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core.sharding import to_members
        return to_members(g, ctx.spec, ctx.mesh), None, None


def gather_leaf(w: torch.Tensor, spec, mesh) -> torch.Tensor:
    """Member-layout leaf ``w`` (held spec ``spec``) made whole on every
    member.  Its backward keeps each member's slice of the whole gradient,
    so the computation that reads it must be one every member of the group
    repeats alike on the same inputs (the gradient is then whole and equal
    on every member).  On a local mesh a differentiable re-layout (autograd
    sums the members' uses before it splits the gradient); on a process
    mesh an ``all_gather`` over the model group."""
    if mesh.member_dims:
        from repro_torch.core.sharding import full_shape, join_blocks
        return join_blocks(w, spec, full_shape(w, spec, mesh), mesh)
    return _GatherLeafRanks.apply(w, spec, mesh)
