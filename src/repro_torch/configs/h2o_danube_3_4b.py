"""h2o-danube-3-4b [dense] — H2O-Danube3 4B [arXiv:2401.16818 lineage].

24 layers, d_model 3840, 32 heads (GQA kv=8, head_dim 120), d_ff 10240
(SwiGLU), vocab 32000.  Llama+Mistral mix with sliding-window attention
(window 4096) — runs long_500k natively (bounded KV cache).
"""
from repro_torch.configs.base import ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    source="arXiv:2401.16818 (H2O-Danube)",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    block_pattern=(ATTN_LOCAL,),
    sliding_window=4096,
    mlp_kind="swiglu",
    tie_embeddings=False,
    rope_theta=10000.0,
)
