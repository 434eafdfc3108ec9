"""mixtral-8x22b [moe] — Mixtral 8x22B [arXiv:2401.04088 lineage].

56 layers, d_model 6144, 48 heads (GQA kv=8, head_dim 128), vocab 32768.
MoE: 8 experts, top-2, expert d_ff 16384 (SwiGLU).  Sliding-window attention,
window 4096.  ~141B total / ~39B active params —
the arch where the paper's strip-sharded optimizer state (ZeRO-1 via
part-reduce/part-broadcast) and FSDP weight sharding matter most; fsdp=True.
"""
from repro_torch.configs.base import ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    source="arXiv:2401.04088 (Mixtral)",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=32768,
    block_pattern=(ATTN_LOCAL,),
    sliding_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    moe_d_ff=16384,
    mlp_kind="swiglu",
    tie_embeddings=False,
    rope_theta=1000000.0,
    fsdp=True,
    remat="block",
)
