"""Abstract inputs for every (arch x input shape) pair
(``repro.launch.specs``, lines 18-85): ``meta`` tensors of the
reference's shapes and dtypes, which allocate nothing.  Each leaf carries
its placement as ``leaf.sharding``, the spec ``core.sharding.
ShardingRules.spec`` resolves on the mesh (the entries of the reference's
``NamedSharding`` spec), where the reference's ``ShapeDtypeStruct`` carries
a ``NamedSharding``.  Consumed by ``launch.dryrun``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.params import map_tree
from repro_torch.core.sharding import ShardingRules
from repro_torch.models import transformer


def _leaf(shape, dtype, axes, mesh, rules: ShardingRules) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device="meta")
    t.sharding = rules.spec(axes, shape, mesh)
    return t


def abstract_params(cfg: ModelConfig, mesh, rules: ShardingRules,
                    dtype=torch.float32):
    return map_tree(lambda s: _leaf(s.shape, dtype, s.axes, mesh, rules),
                    transformer.param_specs(cfg))


def abstract_batch(cfg: ModelConfig, shape: InputShape, mesh,
                   rules: ShardingRules) -> Dict[str, Any]:
    """Training / prefill batch (full sequence)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "vision":
        s_img = cfg.vision_tokens
        return {
            "tokens": _leaf((B, S - s_img), torch.int32, ("batch", "seq"),
                            mesh, rules),
            "patch_embeds": _leaf((B, s_img, cfg.d_model), torch.float32,
                                  ("batch", "seq", "embed"), mesh, rules),
            "positions": _leaf((B, S, 3), torch.int32,
                               ("batch", "seq", None), mesh, rules),
        }
    if cfg.frontend == "audio":
        return {
            "frame_embeds": _leaf((B, S, cfg.d_model), torch.float32,
                                  ("batch", "seq", "embed"), mesh, rules),
            "codebook_labels": _leaf((B, S, cfg.num_codebooks), torch.int32,
                                     ("batch", "seq", None), mesh, rules),
        }
    return {"tokens": _leaf((B, S), torch.int32, ("batch", "seq"), mesh,
                            rules)}


def abstract_caches(cfg: ModelConfig, shape: InputShape, mesh,
                    rules: ShardingRules, long_ctx: bool):
    """Caches of ``transformer.init_caches``' structure, each field placed
    by ``transformer.cache_axes``."""
    caches = transformer.init_caches(cfg, shape.global_batch, shape.seq_len,
                                     long_ctx=long_ctx, device="meta")

    def place(cache, axes):
        def one(t, ax):
            ax = tuple(ax)[:t.ndim] + (None,) * max(0, t.ndim - len(ax))
            return _leaf(tuple(t.shape), t.dtype, ax, mesh, rules)
        return dataclasses.replace(cache, **{
            f.name: one(getattr(cache, f.name), getattr(axes, f.name))
            for f in dataclasses.fields(cache)})
    return tuple(place(c, a) for c, a in zip(caches,
                                              transformer.cache_axes(cfg)))


def abstract_decode_inputs(cfg: ModelConfig, shape: InputShape, mesh,
                           rules: ShardingRules, long_ctx: bool):
    """One-token decode inputs: tokens or frame embeds, positions,
    caches."""
    B = shape.global_batch
    caches = abstract_caches(cfg, shape, mesh, rules, long_ctx)
    pos_shape = (B, 1, 3) if cfg.mrope else (B, 1)
    pos = _leaf(pos_shape, torch.int32,
                ("batch", "seq", None)[:len(pos_shape)], mesh, rules)
    if cfg.frontend == "audio":
        tok = _leaf((B, 1, cfg.d_model), torch.float32,
                    ("batch", "seq", "embed"), mesh, rules)
        return {"frame_embeds": tok, "positions": pos, "caches": caches}
    tok = _leaf((B, 1), torch.int32, ("batch", "seq"), mesh, rules)
    return {"tokens": tok, "positions": pos, "caches": caches}
