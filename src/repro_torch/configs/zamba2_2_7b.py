"""zamba2-2.7b [hybrid] — Zamba2 2.7B [arXiv:2411.15242].

54 blocks, d_model 2560, Mamba2 (SSD) backbone with a shared
attention(+MLP) block interleaved (here: every 6th block), attention
32 heads (kv=32, head_dim 80), d_ff 10240, vocab 32000, ssm_state 64.
Zamba2 re-uses ONE set of shared-attention weights at every interleave
point: the shared block's params live unstacked under ``"shared"`` and every
repeat of the pattern applies them (``models.transformer``).
"""
from repro_torch.configs.base import BLOCK_MAMBA, BLOCK_SHARED_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242 (Zamba2)",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    block_pattern=(BLOCK_MAMBA,) * 5 + (BLOCK_SHARED_ATTN,),
    ssm_state=64,
    ssm_heads=80,          # d_inner 5120 / ssd head dim 64
    ssm_expand=2,
    mlp_kind="geglu",
    tie_embeddings=True,
    rope_theta=10000.0,
)
