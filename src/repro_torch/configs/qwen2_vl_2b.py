"""qwen2-vl-2b [vlm] — Qwen2-VL 2B [arXiv:2409.12191].

28 layers, d_model 1536, 12 heads (GQA kv=2, head_dim 128), d_ff 8960
(SwiGLU), vocab 151936.  M-RoPE (temporal/height/width rotary sections),
dynamic-resolution vision input.  The ViT/projector frontend is a stub:
the data supplies (B, vision_tokens, d_model) patch embeddings
(``models.frontends``, ``data.pipeline.vlm_stream``); the language decoder,
M-RoPE and the image-then-text interleave are real.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    source="arXiv:2409.12191 (Qwen2-VL)",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    block_pattern=(ATTN_GLOBAL,),
    mlp_kind="swiglu",
    tie_embeddings=True,
    rope_theta=1000000.0,
    mrope=True,
    mrope_sections=(16, 24, 24),
    frontend="vision",
    vision_tokens=1024,
)
