"""Paper §3.3: the hybrid data/model parallelism planner
(``repro.core.hybrid``).

A mesh realizes the paper's scheme directly:

    G groups            = |pod| * |data|   (data-parallel replicas)
    nodes per group     = |model|          (model-parallel within a group)

:func:`plan` reports the paper-optimal G for the network's widest layers
(``core.balance.optimal_group_count``), so that the chosen mesh can be
judged against the paper's own rule, and the ``ShardingRules`` each (arch x
input shape) pair takes, with the reference's overrides and notes: FSDP
weight sharding over "data" and the two decode-cache layouts.  The port
executes them: ``fsdp`` as placement metadata (a param's data-axis
entries, ``"embed_fsdp"``, are the reference's placement, and every data
member holds its params whole: ``core.sharding.held_spec``), and
``cache_seq`` as the sequence-sharded decode of ``serve.decode`` with a
``ShardingCtx(mesh, plan.rules)`` (``layers.sharded_decode_attention``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.configs.base import HardwareConfig, InputShape, ModelConfig
from repro_torch.core import balance
from repro_torch.core.sharding import ShardingRules


@dataclass(frozen=True)
class HybridPlan:
    arch: str
    shape: str
    G: int                      # data-parallel group count of the mesh
    model_ways: int             # model-parallel width within a group
    G_opt_head: int             # paper-optimal G for the LM-head FC layer
    G_opt_ff: int               # paper-optimal G for the widest MLP layer
    rules: ShardingRules
    notes: Tuple[str, ...] = ()


def mesh_groups(mesh) -> Tuple[int, int]:
    """(G, model ways) of a mesh with ``axis_names`` and ``shape``."""
    g = 1
    for ax in ("pod", "data"):
        if ax in mesh.axis_names:
            g *= mesh.shape[ax]
    m = mesh.shape.get("model", 1)
    return g, m


def plan(cfg: ModelConfig, shape: InputShape, mesh,
         hw: HardwareConfig) -> HybridPlan:
    G, model_ways = mesh_groups(mesh)
    N = G * model_ways
    notes = []

    # Paper §3.3: G = sqrt(N * minibatch / ofm) for an FC layer of width ofm.
    # The transformer analogues of the paper's big FC layers:
    mb = shape.global_batch * (shape.seq_len if shape.kind == "train" else 1)
    g_head = balance.optimal_group_count(N, mb, max(cfg.vocab_size, 1))
    widest_ff = max(cfg.d_ff, cfg.moe_d_ff * max(cfg.num_experts_per_tok, 1),
                    cfg.q_dim, 1)
    g_ff = balance.optimal_group_count(N, mb, widest_ff)

    rules = ShardingRules()
    if cfg.fsdp:
        rules = rules.with_overrides(embed=("data",))
        notes.append("fsdp: weight d_model sharded over 'data' "
                     "(beyond-paper; the paper replicates weights per node — "
                     "infeasible for this arch at 141B params)")
    if shape.kind == "decode":
        if shape.global_batch < G:
            # long_500k: batch=1 cannot be data-sharded; shard the KV-cache
            # sequence dim over the group axes instead
            rules = rules.with_overrides(batch=None, cache_seq=("data",))
            notes.append("batch < G: cache_seq sharded over 'data', "
                         "attention partials combined part-reduce-style")
        elif cfg.num_kv_heads % model_ways != 0:
            # kv heads cannot shard on 'model': shard the cache sequence
            # dim there instead, or the per-device KV cache replicates
            # model_ways times
            rules = rules.with_overrides(cache_seq=("model",))
            notes.append(f"kv_heads={cfg.num_kv_heads} not divisible by "
                         f"model={model_ways}: cache_seq sharded on 'model'")
    return HybridPlan(cfg.name, shape.name, G, model_ways, g_head, g_ff,
                      rules, tuple(notes))
