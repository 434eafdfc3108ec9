"""The multi-pod dry run of the port (``repro.launch.dryrun``): plan and
count one step of every (arch x input shape x production mesh) pair on a
machine with no card, with no compiler and without allocating.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

For each pair (:func:`count_pair`, the counterpart of the reference's
``lower_pair``, lines 86-232): build the production mesh
(``launch.mesh.make_production_mesh``, on ``meta``), plan it with
``core.hybrid.plan`` at the port's H100 entry (``configs.base.
H100_SXM_BF16``), build the abstract inputs (``launch.specs``), then run
ONE member's program on ``meta`` tensors (:func:`count_step`) under
``FlopCounterMode``, the byte counter (``core.roofline.ByteCounter``) and
the collective counter (``core.collectives.count_collectives``):

- train: the zero1-gspmd train step with AdamW (``optim.dist.
  GspmdUpdate`` on the member's view), ``remat="block"`` forced as the
  reference forces it (lines 92-94);
- prefill: ``transformer.forward`` with ``update_cache=True``;
- decode: one token against the caches.

The member's program is that of one rank of a process mesh of the
production shape (``launch.mesh.ProcessMesh.member_view``): its own rows
of the batch, its own blocks of every model-sharded leaf (``ShardingCtx.
members`` runs its model member alone), every collective recorded and
moving nothing.  The per-device figure is member 0's count, the busiest
member's: the rules shard a dim only where it divides, so every member
runs the same operators on blocks of the same shapes, and member 0, at
coordinate 0 on every axis, also takes the gradient norm's squares of the
blocks the others skip (``GspmdUpdate.clip``).  :func:`count_step`'s
``member=`` counts another member.  The attention runs its plain version
(``use_kernel=False``): a kernel wrapper refuses ``meta`` tensors.

The port runs the blocks in a Python loop, with no ``scan``, so the
counts cover every layer and need no ``_combine`` / ``_unstack``
correction (the reference's lines 36-85).  XLA's ``memory_analysis`` has
no counterpart: a row's ``mem_state_per_dev_gb`` is the bytes of params,
gradients, optimizer state, caches and batch one device holds under the
plan's rules (the reference's placement: FSDP's data-axis share
included); activations are not in it.  ``t_count_s`` (the seconds the
count took) replaces ``t_lower_s`` / ``t_compile_s``.  Rows are written
to ``experiments/dryrun_torch/`` (git-ignored), one JSON file a pair.
The roofline terms are modelled from the data-sheet constants of
``configs.base``, not measured.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.api.families import adapter_for
from repro_torch.configs import (
    ASSIGNED_ARCHS,
    INPUT_SHAPES,
    ModelConfig,
    get_config,
    get_input_shape,
)
from repro_torch.configs.base import H100_SXM_BF16, InputShape
from repro_torch.core import collectives, hybrid, roofline
from repro_torch.core.params import tree_leaves
from repro_torch.core.sharding import (
    ShardingCtx,
    ShardingRules,
    entry_axes,
    to_members,
    zero1_state_spec,
)
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import (
    ProcessMesh,
    make_production_mesh,
    mesh_devices,
)
from repro_torch.models import transformer
from repro_torch.optim import AdamW, constant
from repro_torch.optim.dist import GspmdUpdate
from repro_torch.train.train_step import make_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")


def model_flops(cfg: ModelConfig, kind: str, batch: int, seq: int) -> float:
    n = cfg.param_count(active_only=True)
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch  # decode: one token per request


def _extent(spec, mesh) -> int:
    return math.prod(mesh.shape[a] for e in spec for a in entry_axes(e))


def _held_bytes(t: torch.Tensor, spec, mesh) -> float:
    """Bytes of one device's block of ``t`` under ``spec``."""
    return t.numel() * t.element_size() / _extent(spec, mesh)


def state_bytes(cfg: ModelConfig, kind: str, mesh, rules: ShardingRules,
                params, inputs) -> float:
    """Bytes of params, gradients and AdamW state (train) or caches
    (prefill, decode), and the batch, that one device holds under
    ``rules`` on ``mesh`` (module docstring).  ``inputs``: the abstract
    batch or decode inputs, their leaves placed (``launch.specs``)."""
    total = sum(_held_bytes(p, p.sharding, mesh)
                for p in tree_leaves(params))
    if kind == "train":
        total *= 2                                        # + gradients
        for s in tree_leaves(transformer.param_specs(cfg)):
            st = zero1_state_spec(s.axes, s.shape, mesh, rules)
            total += 2 * 4 * math.prod(s.shape) / _extent(st, mesh)
    for t in _leaves(inputs):
        total += _held_bytes(t, t.sharding, mesh)
    return total


def _leaves(tree) -> list:
    """The tensors of a tree of dicts, sequences and cache dataclasses."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif not isinstance(tree, (tuple, list)):
        return []
    return [t for x in tree for t in _leaves(x)]


def _block(t: torch.Tensor, view) -> torch.Tensor:
    """The member's block of abstract leaf ``t`` under its placement."""
    return to_members(t, t.sharding, view)


def count_step(cfg: ModelConfig, shape: InputShape, mesh,
               rules: ShardingRules, member: int = 0,
               long_ctx: bool = False):
    """Count one member's program of ``shape``'s kind on ``meta`` tensors
    (module docstring).  Returns (FLOPs, bytes, ``CollectiveStats``); the
    set-up (placing the member's blocks, the optimizer state) is outside
    the count."""
    view = ProcessMesh.member_view(mesh.shape, member)
    ctx = ShardingCtx(view, rules)
    specs = transformer.param_specs(cfg)
    params = ctx.place(sp.abstract_params(cfg, mesh, rules), specs)
    if shape.kind == "train":
        batch = {k: _block(v, view) for k, v in
                 sp.abstract_batch(cfg, shape, mesh, rules).items()}
        opt = AdamW(weight_decay=0.01)
        up = GspmdUpdate(opt, view, ctx, specs, zero1=True)
        opt_state = up.init_fn(params)
        step = make_train_step(adapter_for(cfg).make_loss(cfg, ctx), opt,
                               constant(1e-3), dist_update=up)

        def run():
            step(params, opt_state, 0, batch)
    else:
        if shape.kind == "prefill":
            inputs = sp.abstract_batch(cfg, shape, mesh, rules)
        else:
            inputs = sp.abstract_decode_inputs(cfg, shape, mesh, rules,
                                               long_ctx)
            inputs.pop("caches")
        inputs = {k: _block(v, view) for k, v in inputs.items()}
        rows = next(iter(inputs.values())).shape[0]
        caches = transformer.shard_caches(transformer.init_caches(
            cfg, rows, shape.seq_len, long_ctx=long_ctx, device="meta"), ctx)

        @torch.no_grad()
        def run():
            logits, _, _ = transformer.forward(
                params, cfg, ctx, tokens=inputs.get("tokens"),
                embeds=inputs.get("patch_embeds",
                                  inputs.get("frame_embeds")),
                positions=inputs.get("positions"), caches=caches,
                update_cache=shape.kind == "prefill", long_ctx=long_ctx)
            return logits[:, -1]
    with FlopCounterMode(display=False) as flops, \
            roofline.ByteCounter() as nbytes, \
            collectives.count_collectives() as coll:
        run()
    return flops.get_total_flops(), nbytes.bytes, coll


def count_pair(arch: str, shape_name: str, multi_pod: bool,
               verbose: bool = True) -> dict:
    """Plan and count one (arch x shape x mesh); return the report row."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = get_config(arch)
    shape = get_input_shape(shape_name)
    if shape.kind == "train" and cfg.remat == "none":
        # activation checkpointing is required at this scale (the
        # reference's baseline policy)
        cfg = cfg.replace(remat="block")
    plan = hybrid.plan(cfg, shape, mesh, H100_SXM_BF16)
    rules = plan.rules
    long_ctx = shape_name == "long_500k"

    t0 = time.perf_counter()
    params = sp.abstract_params(cfg, mesh, rules)
    inputs = (sp.abstract_decode_inputs(cfg, shape, mesh, rules, long_ctx)
              if shape.kind == "decode" else
              (sp.abstract_batch(cfg, shape, mesh, rules),
               sp.abstract_caches(cfg, shape, mesh, rules, long_ctx)
               if shape.kind == "prefill" else ()))
    mem = state_bytes(cfg, shape.kind, mesh, rules, params, inputs)
    flops, nbytes, coll = count_step(cfg, shape, mesh, rules,
                                     long_ctx=long_ctx)
    t_count = time.perf_counter() - t0
    if verbose:
        print(f"  counted: flops={flops:.3e} bytes={nbytes:.3e} "
              f"coll_ring={coll.ring_bytes:.3e} in {t_count:.2f} s")
    mesh_desc = "2x16x16" if multi_pod else "16x16"
    rep = roofline.analyze(
        arch, shape_name, mesh_desc, mesh_devices(mesh), flops, nbytes,
        coll, model_flops(cfg, shape.kind, shape.global_batch,
                          shape.seq_len),
        mem_state_per_dev_bytes=mem)
    row = rep.row()
    row.update(t_count_s=round(t_count, 2),
               plan_G=plan.G, plan_model_ways=plan.model_ways,
               plan_G_opt_head=plan.G_opt_head, plan_G_opt_ff=plan.G_opt_ff,
               plan_notes=list(plan.notes))
    return row


def run_one(arch: str, shape_name: str, multi_pod: bool, force: bool = False,
            out_dir: str = RESULTS_DIR) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    mesh_desc = "2x16x16" if multi_pod else "16x16"
    fname = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_desc}.json")
    if os.path.exists(fname) and not force:
        with open(fname) as f:
            return json.load(f)
    print(f"[dryrun] {arch} x {shape_name} x {mesh_desc} ...", flush=True)
    try:
        row = count_pair(arch, shape_name, multi_pod)
        row["status"] = "ok"
    except Exception as e:  # noqa: BLE001 - record the failure, keep going
        traceback.print_exc()
        row = dict(arch=arch, shape=shape_name, mesh=mesh_desc,
                   status="error", error=f"{type(e).__name__}: {e}")
    with open(fname, "w") as f:
        json.dump(row, f, indent=1, default=str)
    print(f"[dryrun] -> {row.get('dominant', row['status'])} "
          f"(count {row.get('t_count_s', '-')}s)", flush=True)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry run (counted)")
    ap.add_argument("--arch", default=None, choices=list(ASSIGNED_ARCHS))
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ASSIGNED_ARCHS) if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                row = run_one(arch, shape, mp, force=args.force)
                failures += row["status"] != "ok"
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
