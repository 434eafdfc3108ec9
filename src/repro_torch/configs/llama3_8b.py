"""llama3-8b [dense] — Llama 3 8B [arXiv:2407.21783].

32 layers, d_model 4096, 32 heads (GQA kv=8, head_dim 128), d_ff 14336
(SwiGLU), vocab 128256, rope theta 500000, untied embeddings.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    source="arXiv:2407.21783 (Llama 3)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    block_pattern=(ATTN_GLOBAL,),
    mlp_kind="swiglu",
    tie_embeddings=False,
    rope_theta=500000.0,
)
