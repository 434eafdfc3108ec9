"""Logical-axis sharding rules, divisibility-safe (``repro.core.sharding``),
and the member layouts that realize them on the port's meshes.

Every parameter names its dims with *logical* axes ("batch", "ff",
"heads", ...).  A rule table maps logical axes to mesh axes; the resolver
drops a rule whenever the dim does not divide by the mesh axes' extent, so
one table serves every architecture.  The table IS the paper's §3.3 hybrid
assignment: "batch" on the data-parallel group axes (pod, data), the
feature-like axes ("ff", "heads", "vocab", ...) on the in-group "model"
axis.  :meth:`ShardingRules.spec` returns a plain tuple, the reference's
``PartitionSpec`` entries (``None``, an axis name, or a tuple of names);
it takes any mesh with ``axis_names`` and ``shape``.

The reference hands a spec to GSPMD.  The port holds each leaf in a
*member layout* instead (:func:`to_members`, :func:`from_members`):

* on a :class:`~repro_torch.launch.mesh.LocalMesh` one tensor with a
  leading dim for every mesh axis the spec uses, in mesh-axis order, then
  the block a member holds: a ``(k, k, ifm, ofm)`` conv weight on
  ``P(None, None, None, "model")`` is ``(M, k, k, ifm, ofm / M)``, so that
  model member m's block ``w[m]`` is contiguous;
* on a :class:`~repro_torch.launch.mesh.ProcessMesh` the rank's block.

Params take their spec's model entries only (:func:`held_spec`): a
data-axis entry of a param (``"embed_fsdp"``, FSDP) is placement metadata
here, and every data member holds its params whole.  :class:`ShardingCtx`
is the models' seam, the port's counterpart of ``constrain``: it places a
tree in its member layout, gathers it back, and runs a layer on each model
member's blocks with the model-axis collectives of ``core.collectives``:

* :meth:`ShardingCtx.column`: a column-parallel layer, the members'
  outputs joined along the last dim;
* :meth:`ShardingCtx.row`: a row-parallel product of a replicated input,
  each member on its own slice of the input and its rows of the leaf, the
  partial products summed;
* :meth:`ShardingCtx.members` and :meth:`ShardingCtx.reduce` /
  :meth:`ShardingCtx.gather`: any block run once per model member on its
  own blocks of several leaves (attention's heads: ``wq``/``wk``/``wv``
  by column, ``wo`` by row), every replicated input and whole leaf handed
  to it through ``copy_to_model``, so that its gradient sums over the
  members;
* :meth:`ShardingCtx.gather_leaf`: a leaf made whole for a block whose
  held blocks do not line up with its computation, which every member
  then repeats alike.

On a mesh whose model axis is 1 (or no mesh) each of these is the plain
call.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.params import Spec, map_tree, tree_leaves

MeshAxes = Optional[Tuple[str, ...]]   # mesh axes one logical axis maps to

# Paper-faithful hybrid-parallel rules (the reference's DESIGN.md §2).
DEFAULT_RULES: Dict[str, MeshAxes] = {
    # data-parallel group axes (the paper's G groups)
    "batch": ("pod", "data"),
    # model-parallel (within-group) axes
    "ff": ("model",),
    "moe_ff": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model",),
    "ssm_inner": ("model",),
    "ssm_heads": ("model",),
    "experts": ("model",),        # falls back to moe_ff when E % 16 != 0
    "moe_out": ("model",),        # moe_down_rs: shard down-proj output d
    # replicated by default
    "embed": None,
    "embed_fsdp": ("data",),      # FSDP weight sharding (mixtral etc.)
    "seq": None,
    "seq_res": ("model",),        # seq_shard_carry: residual stream seq dim
    "kernel": None,
    "head_dim": None,
    "ssm_state": None,
    "codebooks": None,
    "cache_seq": None,            # long_500k: overridden to ("data",)
}

DATA_AXES = ("pod", "data")


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name, or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class ShardingRules:
    rules: Dict[str, MeshAxes] = field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def with_overrides(self, **over: MeshAxes) -> "ShardingRules":
        r = dict(self.rules)
        r.update(over)
        return ShardingRules(r)

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Sequence[int], mesh) -> tuple:
        """Resolve logical axes to spec entries, honoring divisibility and
        never assigning one mesh axis twice; trailing Nones dropped."""
        used = set()
        parts: List[Any] = []
        for name, dim in zip(logical_axes, shape):
            assignment = None
            if name is not None:
                cand = self.rules.get(name)
                if cand:
                    axes = tuple(a for a in cand if a in mesh.axis_names
                                 and a not in used)
                    extent = 1
                    for a in axes:
                        extent *= mesh.shape[a]
                    if axes and extent > 1 and dim % extent == 0:
                        assignment = axes if len(axes) > 1 else axes[0]
                        used.update(axes)
            parts.append(assignment)
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)


def held_spec(spec: Sequence) -> tuple:
    """A param's spec as the port holds it: its model entries only (module
    docstring), trailing Nones dropped."""
    parts = ["model" if "model" in entry_axes(e) else None for e in spec]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def used_axes(spec: Sequence, mesh) -> Tuple[str, ...]:
    """The mesh axes ``spec`` shards over, in mesh-axis order."""
    axes = {a for e in spec for a in entry_axes(e)}
    return tuple(a for a in mesh.axis_names if a in axes)


def _split(spec: Sequence, shape: Sequence[int], mesh):
    """(split shape, permutation) taking a full tensor, viewed with every
    sharded dim split into (its axes' extents..., block), to its local
    member layout."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    split, pos, block = [], {}, []
    for entry, dim in zip(spec, shape):
        axes = entry_axes(entry)
        n = math.prod(mesh.shape[a] for a in axes)
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {axes} ({n})")
        for a in axes:
            pos[a] = len(split)
            split.append(mesh.shape[a])
        block.append(len(split))
        split.append(dim // n)
    return split, [pos[a] for a in used_axes(spec, mesh)] + block


def block_index(spec: Sequence, mesh, member: int) -> List[int]:
    """Member ``member``'s block index along each dim of ``spec``: row-major
    over the entry's axes, as the reference's tuple entries shard."""
    c = mesh.coords(member)
    out = []
    for entry in spec:
        i = 0
        for a in entry_axes(entry):
            i = i * mesh.shape[a] + c[a]
        out.append(i)
    return out


@torch.no_grad()
def to_members(full: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """The member layout of ``full`` under ``spec`` (module docstring): a
    new contiguous tensor, or ``full`` itself when ``spec`` shards
    nothing.  Outside autograd, as :func:`from_members`."""
    if not used_axes(spec, mesh):
        return full
    if mesh.member_dims:
        split, perm = _split(spec, full.shape, mesh)
        return full.reshape(split).permute(perm).contiguous()
    idx = block_index(spec, mesh, mesh.member)
    sl = []
    for entry, dim, i in zip(spec, full.shape, idx):
        b = dim // math.prod(mesh.shape[a] for a in entry_axes(entry))
        sl.append(slice(i * b, (i + 1) * b))
    return full[tuple(sl)].clone(memory_format=torch.contiguous_format)


def full_shape(x: torch.Tensor, spec: Sequence, mesh) -> Tuple[int, ...]:
    """The full shape of member-layout tensor ``x`` under ``spec``."""
    block = x.shape[len(used_axes(spec, mesh)) if mesh.member_dims else 0:]
    spec = tuple(spec) + (None,) * (len(block) - len(spec))
    return tuple(b * math.prod(mesh.shape[a] for a in entry_axes(e))
                 for b, e in zip(block, spec))


@torch.no_grad()
def from_members(x: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """The full tensor of member-layout ``x`` under ``spec``: a copy, or
    ``x`` itself when ``spec`` shards nothing.  On a process mesh an
    all-gather over the spec's axes (every rank of those groups calls it),
    staged through host memory over gloo."""
    used = used_axes(spec, mesh)
    if not used:
        return x
    shape = full_shape(x, spec, mesh)
    if not mesh.member_dims:
        import torch.distributed as dist

        from repro_torch.core.collectives import dist_call, staged_for
        pg, ranks = mesh.group(used)
        src = staged_for(x, pg).contiguous()
        out = src.new_empty(len(ranks) * src.numel())
        dist_call("all-gather", out, len(ranks),
                  dist.all_gather_into_tensor, out, src.reshape(-1),
                  group=pg)
        x = out.view(*(mesh.shape[a] for a in used), *x.shape).to(x.device)
    return join_blocks(x, spec, shape, mesh)


def join_blocks(x: torch.Tensor, spec: Sequence, shape: Sequence[int],
                mesh) -> torch.Tensor:
    """The full tensor (``shape``) of ``x``, its blocks under ``spec``
    stacked on leading dims in the order of the spec's mesh axes (a local
    mesh's member layout): one reshape, permute and reshape, so it is
    differentiable."""
    split, perm = _split(spec, shape, mesh)
    inv = sorted(range(len(perm)), key=perm.__getitem__)
    return x.reshape([split[p] for p in perm]).permute(inv).reshape(shape)


def map_specs(fn: Callable, specs, tree):
    """``fn(spec_leaf, leaf)`` over two trees of one structure (the spec
    tree's leaves taken in ``map_tree`` order)."""
    it = iter(tree_leaves(specs))
    return map_tree(lambda leaf: fn(next(it), leaf), tree)


@dataclass(frozen=True)
class ShardingCtx:
    """The models' sharding seam (module docstring); a no-op when ``mesh``
    is None or its model axis is 1."""
    mesh: Any = None
    rules: ShardingRules = field(default_factory=ShardingRules)

    @property
    def model_ways(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape.get("model", 1)

    def spec(self, s: Spec) -> tuple:
        """Leaf ``s``'s resolved spec on this mesh (``()`` without one)."""
        if self.mesh is None:
            return ()
        return self.rules.spec(s.axes, s.shape, self.mesh)

    def held(self, s: Spec) -> tuple:
        """Leaf ``s``'s spec as the port holds it (:func:`held_spec`)."""
        return held_spec(self.spec(s))

    def sharded(self, s: Spec) -> bool:
        """True when leaf ``s`` is split over the model axis."""
        return self.model_ways > 1 and "model" in self.held(s)

    def place(self, tree, specs):
        """The full ``tree`` (``specs``: its ``Spec`` tree) in member
        layout."""
        if self.model_ways == 1:
            return tree
        return map_specs(lambda s, x: to_members(x, self.held(s), self.mesh),
                         specs, tree)

    def full(self, tree, specs):
        """The full tree of member-layout ``tree`` (a collective on a
        process mesh)."""
        if self.model_ways == 1:
            return tree
        return map_specs(
            lambda s, x: from_members(x, self.held(s), self.mesh), specs,
            tree)

    def model_members(self) -> List[int]:
        """The model indices of the members held here, in model order:
        all M on a local mesh, this rank's on a process mesh."""
        if self.model_ways == 1:
            return [0]
        if self.mesh.member_dims:
            return list(range(self.model_ways))
        return [self.mesh.coords(self.mesh.member)["model"]]

    def members(self, fn: Callable, xs: Sequence[torch.Tensor],
                leaves: Sequence[torch.Tensor] = (),
                specs: Sequence[Optional[Spec]] = ()) -> list:
        """``[fn(m, *xs_m, *leaves_m) for m in model_members()]``: each
        model member held here runs ``fn`` on its own block of every
        model-sharded leaf (``specs[i]`` its ``Spec``; None for a leaf to
        hand whole, such as one :meth:`gather_leaf` made whole), while the
        replicated inputs ``xs`` and the whole leaves go through
        ``copy_to_model``, so that their gradients sum over the members.
        Combine the outputs with :meth:`reduce` (partial sums) or
        :meth:`gather` (column blocks)."""
        if self.model_ways == 1:
            return [fn(0, *xs, *leaves)]
        from repro_torch.core.collectives import copy_to_model
        mesh = self.mesh
        cols = [copy_to_model(x, mesh) for x in xs]
        for w, s in zip(leaves, specs):
            cols.append(mesh.model_blocks(w) if s is not None
                        and self.sharded(s) else copy_to_model(w, mesh))
        return [fn(m, *(c[i] for c in cols))
                for i, m in enumerate(self.model_members())]

    def reduce(self, outs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of the members' partial outputs over the model group
        (``reduce_from_model``), added in f32 and cast back to the
        partials' dtype: one rounding of the whole sum."""
        if self.model_ways == 1:
            return outs[0]
        from repro_torch.core.collectives import reduce_from_model
        return reduce_from_model([o.float() for o in outs],
                                 self.mesh).to(outs[0].dtype)

    def summed(self, fn: Callable, xs: Sequence[torch.Tensor],
               leaves: Sequence[torch.Tensor],
               specs: Sequence[Optional[Spec]]) -> torch.Tensor:
        """:meth:`reduce` of :meth:`members`: a block whose output is the
        sum of its members' partial outputs over their blocks of the
        model-sharded leaves (an MLP: ``w_gate``/``w_up`` by column,
        ``w_down`` by row).  With no leaf sharded, ``fn(0, *xs, *leaves)``
        once."""
        if not any(s is not None and self.sharded(s) for s in specs):
            return fn(0, *xs, *leaves)
        return self.reduce(self.members(fn, xs, leaves, specs))

    def gather(self, outs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The members' column blocks joined along the last dim
        (``gather_model``)."""
        if self.model_ways == 1:
            return outs[0]
        from repro_torch.core.collectives import gather_model
        return gather_model(outs, self.mesh)

    def gather_leaf(self, w: torch.Tensor, s: Spec) -> torch.Tensor:
        """Leaf ``w`` (``Spec`` ``s``) whole on every member
        (``core.collectives.gather_leaf``); ``w`` itself when it is not
        model-sharded."""
        if not self.sharded(s):
            return w
        from repro_torch.core.collectives import gather_leaf
        return gather_leaf(w, self.held(s), self.mesh)

    def row(self, x: torch.Tensor, leaves: Sequence[torch.Tensor],
            specs: Sequence[Spec], fn: Callable) -> torch.Tensor:
        """``fn(x, *leaves)`` for a product whose leaves shard their first
        dim (the input features) over the model axis and whose input ``x``
        every member holds whole: each member computes ``fn`` on its slice
        of ``x``'s last dim and its rows of every leaf, and the partial
        products are summed (:meth:`reduce`).  Unsharded leaves:
        ``fn(x, *leaves)`` once."""
        flags = [self.sharded(s) for s in specs]
        if not any(flags):
            return fn(x, *leaves)
        if not all(flags):
            raise ValueError(
                f"a row-parallel product needs every leaf on the model "
                f"axis or none: {[s.axes for s in specs]} over {self.mesh}")
        n = x.shape[-1] // self.model_ways

        def one(m, xm, *blocks):
            return fn(xm[..., m * n:(m + 1) * n], *blocks)
        return self.reduce(self.members(one, [x], leaves, specs))

    def column(self, x: torch.Tensor, leaves: Sequence[torch.Tensor],
               specs: Sequence[Spec], fn: Callable) -> torch.Tensor:
        """``fn(x, *leaves)`` for a layer whose leaves shard their last
        ("ff") dim over the model axis: each model member computes
        ``fn`` on its own columns of every leaf (``copy_to_model`` hands it
        ``x``), and ``gather_model`` joins the members' outputs along the
        last dim.  Unsharded leaves: ``fn(x, *leaves)`` once."""
        flags = [self.sharded(s) for s in specs]
        if not any(flags):
            return fn(x, *leaves)
        if not all(flags):
            raise ValueError(
                f"a column-parallel layer needs every leaf on the model "
                f"axis or none: {[s.axes for s in specs]} over {self.mesh}")
        return self.gather(self.members(lambda m, xm, *b: fn(xm, *b), [x],
                                        leaves, specs))


def zero1_state_spec(axes: Sequence[Optional[str]], shape: Sequence[int],
                     mesh, rules: ShardingRules) -> tuple:
    """The zero1-gspmd spec of one optimizer-state leaf of a param with
    logical ``axes`` and full ``shape``: the param's spec plus the data
    axes not used yet, on the first dim that is unsharded and divides by
    their extent (``repro.train.zero1_state_shardings``'s ``one``)."""
    spec = list(rules.spec(axes, shape, mesh))
    spec += [None] * (len(shape) - len(spec))
    used = {a for entry in spec for a in entry_axes(entry)}
    extra = tuple(a for a in DATA_AXES
                  if a in mesh.axis_names and a not in used)
    extent = math.prod(mesh.shape[a] for a in extra)
    if extra and extent > 1:
        for i, (ax, dim) in enumerate(zip(spec, shape)):
            if ax is None and dim % extent == 0:
                spec[i] = extra if len(extra) > 1 else extra[0]
                break
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)
