"""gemma-2b [dense] — Gemma 2B [arXiv:2403.08295].

18 layers, d_model 2048, 8 heads with MQA (kv=1, head_dim 256), d_ff 16384
(GeGLU), vocab 256000, tied embeddings.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    source="arXiv:2403.08295 (Gemma)",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    block_pattern=(ATTN_GLOBAL,),
    mlp_kind="geglu",
    tie_embeddings=True,
    rope_theta=10000.0,
)
