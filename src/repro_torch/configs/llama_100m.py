"""llama-100m — a ~100M-parameter LLaMA-family config for end-to-end
training examples.  Same block structure as llama3-8b, scaled to
laptop/CPU size [arXiv:2407.21783 lineage]."""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="llama-100m",
    family="dense",
    source="llama3 family, example-scale",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab_size=32768,
    block_pattern=(ATTN_GLOBAL,),
    mlp_kind="swiglu",
    tie_embeddings=True,
    rope_theta=10000.0,
)
