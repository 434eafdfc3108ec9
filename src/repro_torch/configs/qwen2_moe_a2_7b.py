"""qwen2-moe-a2.7b [moe] — Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24 layers, d_model 2048, 16 heads (kv=16, head_dim 128), vocab 151936.
MoE: 60 routed experts (top-4, expert d_ff 1408) + 4 shared experts
(fused shared-expert hidden 4*1408 = 5632) on every layer.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,                      # every MLP is MoE
    vocab_size=151936,
    block_pattern=(ATTN_GLOBAL,),
    num_experts=60,
    num_experts_per_tok=4,
    moe_d_ff=1408,
    num_shared_experts=4,
    shared_expert_d_ff=5632,
    mlp_kind="swiglu",
    tie_embeddings=True,
    rope_theta=1000000.0,
)
