"""The executable product of ``compile_run`` (``repro.api.run``): params,
state, step, data, fit, checkpoints.

A :class:`Run` owns what a training loop needs, already assembled and on
its device: the ``train_step``, the ``params`` and ``opt_state``, a lazily
started prefetching ``data`` iterator, and ``fit()``.  The reference's
``jit_step`` (one jit cache, buffers donated) becomes the eager
``train_step``, which updates ``params`` and ``opt_state`` in place.
Under the explicit bucketed modes (``zero1``, ``stale-sync``, ``gossip``)
the run carries its member ``mesh``, its ``comm`` and the ``dist_update``
its train step calls (under ``comm.overlap`` the apply-and-broadcast
``local_update``), and ``opt_state`` is the strip state (under stale-sync
and top-k, wrapped with its carry or residual).

Under a model axis (``MeshSpec.model_ways > 1``) ``params`` are in the
member layout of ``ctx`` (``core.sharding``); :meth:`Run.full_params` is
the full tree, gathered over the model axis.  Under ``dp`` and
``zero1-gspmd`` the ``dist_update`` is ``optim.dist.GspmdUpdate`` and
``opt_state`` the optimizer's state in its member layout.

A run with a ``ckpt_dir`` writes a checkpoint every ``ckpt_every`` steps
and resumes from the latest one there (``fit``), in the reference's file
format (``checkpoint.ckpt``): every leaf at its full shape, whatever the
model ways, so that a checkpoint resumes at other model ways too; a zero1
checkpoint saved at another world size is re-planned
(``checkpoint.replan``), whichever package wrote it.  A stale-sync or
top-k run also resumes a bare zero1 checkpoint, its carry or residual
restarting at zero.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.core.params import map_tree, tree_leaves
from repro_torch.core.sharding import (
    ShardingCtx,
    from_members,
    full_shape,
    to_members,
)
from repro_torch.data.pipeline import Prefetcher, make_placer
from repro_torch.telemetry.events import NULL_RECORDER
from repro_torch.train.trainer import Trainer, TrainerConfig


@dataclass
class Run:
    """An assembled training run.  ``fit`` and ``step`` advance
    ``params`` and ``opt_state`` in place."""
    spec: Any                       # the RunSpec this run was compiled from
    cfg: Any                        # resolved (possibly smoke) family config
    family: Any                     # FamilyAdapter
    device: torch.device
    loss_fn: Callable
    optimizer: Any
    lr_schedule: Callable
    train_step: Callable            # (params, opt_state, step, batch) -> ...
    params: Any
    opt_state: Any
    mesh: Optional[Any] = None      # launch.mesh LocalMesh or ProcessMesh;
    #                                 None for serial
    comm: Optional[Any] = None      # the CommConfig of the strip update
    dist_update: Optional[Callable] = None  # optim.dist update_fn
    #                                         (local_update under overlap)
    telemetry: Optional[Any] = None  # recorder of the spans (the
    #                                  trainer's, Run.step's, the train
    #                                  step's and the update's) and the
    #                                  counts (telemetry.make_recorder);
    #                                  listeners (the cluster heartbeat,
    #                                  the JSONL sink) ride its events;
    #                                  None = no-op
    ctx: ShardingCtx = field(default_factory=ShardingCtx)  # the member
    #                                  layout of params (model axis)
    _data: Optional[Prefetcher] = field(default=None, repr=False)
    _warm: bool = field(default=False, repr=False)  # train_step ran once

    def _make_data(self, skip: int = 0) -> Prefetcher:
        """A fresh prefetcher over the family's seeded stream, ``skip``
        batches drawn and dropped on the host first (a resumed run takes up
        the stream where the interrupted one left it), each batch then
        placed on the run's device, a process mesh's rank keeping its
        rows."""
        s = self.spec
        stream = self.family.stream(self.cfg, s.batch, s.seq, s.seed)
        for _ in range(skip):
            try:
                next(stream)
            except StopIteration:
                break
        shard = None if self.mesh is None else self.mesh.batch_shard
        return Prefetcher(stream, place=make_placer(self.device, shard))

    @property
    def data(self) -> Prefetcher:
        """Background-prefetching batch iterator over the family's seeded
        stream.  Created on first access (so compiling a Run never starts
        threads)."""
        if self._data is None:
            self._data = self._make_data()
        return self._data

    def step(self, batch, step_idx: int = 0):
        """Run one train step on an explicit batch, under a ``step`` span
        of ``telemetry``; advances the run's params and opt_state and
        returns the metrics dict."""
        with (self.telemetry or NULL_RECORDER).span("step",
                                                    step=step_idx + 1):
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, step_idx, batch)
        self._warm = True
        return metrics

    def full_params(self):
        """The full param tree: ``params`` gathered over the model axis (a
        collective on a process mesh), ``params`` itself without one."""
        return self.ctx.full(self.params, self.family.param_specs(self.cfg))

    def load_params(self, tree):
        """Copy the full param tree ``tree`` (numpy arrays, e.g. the
        reference's carried over, or tensors) into ``params``, each leaf in
        its member layout, in place; the optimizer state is untouched."""
        host = map_tree(lambda a: a.detach().cpu().numpy()
                        if isinstance(a, torch.Tensor) else np.asarray(a),
                        tree)
        self.params = self._place("params", self.params, host)

    # -- checkpoints ---------------------------------------------------
    def _strip_mesh(self):
        """The mesh of the zero1 strip state (the data members), or None
        when the run has none."""
        if self.comm is None or self.mesh is None:
            return None
        # the overlapped update is a bare function, at model_ways 1 only
        plan = getattr(self.dist_update, "plan", None)
        return self.mesh if plan is None else plan.mesh

    def _zero1_world(self):
        """This run's zero1 world layout (``checkpoint.replan``'s meta
        record), or None when the run has no strip state."""
        mesh = self._strip_mesh()
        if mesh is None:
            return None
        from repro_torch.checkpoint.replan import world_meta
        return world_meta([mesh.shape[a] for a in mesh.data_axes],
                          self.comm.hierarchical, self.comm.bucket_bytes)

    def _ckpt_meta(self):
        world = self._zero1_world()
        return {"zero1": world} if world is not None else None

    def _layouts(self, name: str, tree):
        """Per leaf of tree ``name`` (params or opt_state), in leaf order:
        the spec of its member layout on ``mesh``, or None for a leaf held
        as the checkpoint holds it (or as strips of ``_strip_mesh``)."""
        leaves = tree_leaves(tree)
        if self.mesh is None:
            return [None] * len(leaves)
        if name == "params":
            return [self.ctx.held(s)
                    for s in tree_leaves(self.family.param_specs(self.cfg))]
        specs = getattr(self.dist_update, "strip", None)
        if specs is None or self.comm is not None:
            return [None] * len(leaves)
        out, i = [], 0
        for x in leaves:        # the state's fields repeat the param tree
            if isinstance(x, torch.Tensor) and x.dim():
                out.append(specs[i % len(specs)])
                i += 1
            else:
                out.append(None)
        return out

    def _map_layout(self, name: str, tree, fn):
        """``fn(leaf, layout)`` over tree ``name`` (``_layouts``)."""
        it = iter(self._layouts(name, tree))
        return map_tree(lambda x: fn(x, next(it)), tree)

    def _global(self, name: str, tree):
        """Tree ``name`` as the checkpoint holds it: every leaf at its full
        shape, the strip state in the reference's global ``(G, n/G)``
        rows (collectives on a mesh over ranks: every rank calls it)."""
        strips = self._strip_mesh() if name == "opt_state" else None

        def one(x, spec):
            if not isinstance(x, torch.Tensor):
                return x
            if spec is not None:
                return from_members(x, spec, self.mesh)
            if strips is not None and x.dim():
                return strips.gather_members(x)
            return x
        return self._map_layout(name, tree, one)

    def _ckpt_gather(self):
        """ckpt.save's gather: each tree's global value (``_global``)."""
        if self.mesh is None:
            return None
        return {name: (lambda tree, name=name: self._global(name, tree))
                for name in ("params", "opt_state")}

    def _template(self, name: str, tree):
        """Tree ``name`` as the checkpoint holds it, as zero-copy stand-ins
        carrying the shape and dtype (``_global`` without the data)."""
        strips = self._strip_mesh() if name == "opt_state" else None

        def one(x, spec):
            if not isinstance(x, torch.Tensor) or not x.dim():
                return x
            if spec is not None:
                shape = full_shape(x, spec, self.mesh)
            elif strips is not None and strips.n_ranks > 1:
                shape = (strips.data_size, *x.shape[strips.member_dims:])
            else:
                return x
            return np.broadcast_to(np.zeros((), ckpt_lib.np_dtype(x.dtype)),
                                   shape)
        return self._map_layout(name, tree, one)

    def _stale_wrapped(self) -> bool:
        """True when this run's opt_state is the stale-sync dict around the
        inner zero1 strip state."""
        return (isinstance(self.opt_state, dict)
                and set(self.opt_state) == {"stale", "synced", "zero1"})

    def _reinit_stale(self, inner):
        """A restored inner strip state wrapped for a stale-sync run with an
        empty carry (this world's bucket shapes) and ``synced = 0``, so
        that the first resumed step applies its own reduce
        (``optim.dist.make_stale_sync_update``)."""
        tpl = self._template("opt_state", self.opt_state)["stale"]
        return {"stale": [np.zeros(*ckpt_lib.leaf_meta(r)) for r in tpl],
                "synced": np.zeros((), np.int32), "zero1": inner}

    def _ef_wrapped(self) -> bool:
        """True when this run's opt_state is the top-k error-feedback dict
        around the inner zero1 strip state."""
        return (isinstance(self.opt_state, dict)
                and set(self.opt_state) == {"residual", "zero1"})

    def _reinit_residual(self, inner):
        """A restored inner strip state wrapped for a top-k run with a zero
        residual (this world's bucket shapes): the carried mass of a bare or
        other-world checkpoint has no owner here."""
        tpl = self._template("opt_state", self.opt_state)["residual"]
        return {"residual": [np.zeros(*ckpt_lib.leaf_meta(r)) for r in tpl],
                "zero1": inner}

    def _restore_replan(self, step: int, template):
        """The strict restore failed on shape: the checkpoint was saved at
        another world size.  Re-plan the strip state for this world
        (``checkpoint.replan``: exact); params are replicated, so they
        restore strictly.  ``template`` is the opt_state to restore into,
        in the checkpoint's layout."""
        from repro_torch.checkpoint.replan import replan_strip_state
        from repro_torch.comm.bucketer import plan_buckets
        wrap = None
        if isinstance(template, dict) and set(template) == {"residual",
                                                            "zero1"}:
            # the top-k residual is member-local unsent gradient mass sized
            # by the old world's buckets, with no exact conversion: re-plan
            # the inner strips (keeping the opt_state:zero1/... keys) and
            # restart the residual at zero
            template = {"zero1": template["zero1"]}
            wrap = self._reinit_residual
        new_world = self._zero1_world()
        old_world = ckpt_lib.read_manifest(
            self.spec.ckpt_dir, step)["meta"].get("zero1")
        if new_world is None or old_world is None:
            raise ValueError(
                f"checkpoint step {step} does not match this run's shapes "
                "and carries no zero1 world meta to re-plan from")
        params_tpl = self._template("params", self.params)
        trees, _ = ckpt_lib.restore(self.spec.ckpt_dir, step,
                                    params=params_tpl)
        old_leaves = ckpt_lib.restore_loose(self.spec.ckpt_dir, step,
                                            "opt_state", template)
        plan = plan_buckets(params_tpl, new_world["G"],
                            self.comm.bucket_bytes)
        trees["opt_state"] = replan_strip_state(
            template, old_leaves, plan, old_world, new_world)
        if wrap is not None:
            trees["opt_state"] = wrap(trees["opt_state"]["zero1"])
        return trees

    @torch.no_grad()
    def _place(self, name: str, cur, host):
        """Copy the host tree ``host`` (the checkpoint's layout) into the
        run's tree ``name``, ``cur``, in place: each leaf into its member
        layout (``_layouts``), a rank of a process or cluster mesh taking
        its rows of the strip state (``mesh.own``).  Int leaves (AdamW's count) are
        replaced."""
        it = iter(tree_leaves(host))
        strips = self._strip_mesh() if name == "opt_state" else None

        def put(c, spec):
            a = next(it)
            if not isinstance(c, torch.Tensor):
                return int(a)
            # ascontiguousarray makes a 0-d array 1-d: shape it back
            src = torch.from_numpy(
                np.ascontiguousarray(a).reshape(np.shape(a)))
            if spec is not None:
                src = to_members(src, spec, self.mesh)
            elif strips is not None and c.dim() and strips.n_ranks > 1:
                src = strips.own(src, strips.per_member(lambda m: m))
            return c.copy_(src)
        return self._map_layout(name, cur, put)

    def restore(self, step: int):
        """Load checkpoint ``step`` of ``spec.ckpt_dir`` into the run's
        params and opt_state, in place.  A zero1 checkpoint saved at
        another world size is re-planned (``checkpoint.replan``) rather
        than rejected: the elastic shrink-and-resume path; a stale-sync
        checkpoint's carry, strips of the mean gradient in owner order, is
        re-planned with it, as the reference's is.  A stale-sync or top-k
        run also takes a bare zero1 checkpoint (the strips' layouts are the
        same): the inner state restores, and the carry restarts empty
        (``synced = 0``: the first resumed step is synchronous) or the
        residual at zero."""
        opt_tpl = self._template("opt_state", self.opt_state)
        wrap = None
        if self._stale_wrapped() or self._ef_wrapped():
            keys = ckpt_lib.read_manifest(
                self.spec.ckpt_dir, step)["trees"].get("opt_state", ())
            if not any(k.startswith("opt_state:zero1/") for k in keys):
                opt_tpl = opt_tpl["zero1"]
                wrap = (self._reinit_stale if self._stale_wrapped()
                        else self._reinit_residual)
        try:
            trees, _ = ckpt_lib.restore(
                self.spec.ckpt_dir, step,
                params=self._template("params", self.params),
                opt_state=opt_tpl)
        except ValueError:
            trees = self._restore_replan(step, opt_tpl)
        if wrap is not None:
            trees["opt_state"] = wrap(trees["opt_state"])
        self.params = self._place("params", self.params, trees["params"])
        self.opt_state = self._place("opt_state", self.opt_state,
                                     trees["opt_state"])

    def fit(self, start_step: Optional[int] = None, log_fn=print):
        """Train for ``spec.steps`` steps; returns the metrics history (the
        first and the final step always log).

        ``start_step=None`` (the default) resumes from the latest
        checkpoint in ``spec.ckpt_dir`` when there is one: params and
        opt_state are restored and the seeded data stream is fast-forwarded
        one batch per completed step, so the trajectory goes on where the
        interrupted run left it.  ``start_step=0`` forces a fresh run."""
        s = self.spec
        if start_step is None:
            start_step = 0
            if s.ckpt_dir:
                latest = ckpt_lib.latest_step(s.ckpt_dir)
                if latest is not None:
                    self.restore(latest)
                    start_step = latest
                    log_fn(f"resuming from checkpoint step {latest} "
                           f"({s.ckpt_dir})")
                    if latest < s.steps:
                        # rebuild the stream, skipping the completed steps'
                        # batches on the host
                        if self._data is not None:
                            self._data.close()
                        self._data = self._make_data(skip=latest)
        if start_step >= s.steps:
            return []
        tcfg = TrainerConfig(total_steps=s.steps, log_every=s.log_every,
                             ckpt_every=s.ckpt_every, ckpt_dir=s.ckpt_dir,
                             ckpt_meta=self._ckpt_meta(),
                             ckpt_gather=self._ckpt_gather(),
                             recorder=self.telemetry)
        trainer = Trainer(self.train_step, tcfg, warm=self._warm)
        self.params, self.opt_state, history = trainer.fit(
            self.params, self.opt_state, self.data, start_step=start_step,
            log_fn=log_fn)
        if history:
            # the first executed step always logs, so a non-empty history
            # means train_step really ran
            self._warm = True
        return history

    def close(self):
        """Stop the data thread and finalize the recorder; a traced
        single-process run merges its Chrome trace here (a cluster's
        supervisor merges its workers' traces)."""
        if self._data is not None:
            self._data.close()
            self._data = None
        rec = self.telemetry
        if rec is not None and getattr(rec, "enabled", False):
            rec.close()
            if rec.trace_dir:
                from repro_torch.cluster.spec import in_worker
                if not in_worker():
                    from repro_torch.telemetry import merge_process_traces
                    merge_process_traces(rec.trace_dir)

    def __enter__(self) -> "Run":
        return self

    def __exit__(self, *exc):
        self.close()
