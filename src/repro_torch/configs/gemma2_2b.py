"""gemma2-2b [dense] — Gemma 2 2B [arXiv:2408.00118].

26 layers, d_model 2304, 8 heads (GQA kv=4, head_dim 256), d_ff 9216 (GeGLU),
vocab 256000.  Alternating local (sliding-window 4096) / global attention,
attention-logit softcap 50, final-logit softcap 30, tied embeddings.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    source="arXiv:2408.00118 (Gemma 2)",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    block_pattern=(ATTN_LOCAL, ATTN_GLOBAL),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_kind="geglu",
    tie_embeddings=True,
    rope_theta=10000.0,
)
