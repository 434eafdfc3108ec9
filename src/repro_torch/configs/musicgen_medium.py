"""musicgen-medium [audio] — MusicGen medium [arXiv:2306.05284].

48 layers, d_model 1536, 24 heads (kv=24, head_dim 64), d_ff 6144 (GELU),
vocab 2048 per EnCodec codebook (4 codebooks, delay interleave pattern).
The EnCodec conv codec is a stub: the data supplies (B, S, d_model) frame
embeddings (the 4 codebook embeddings summed; ``models.frontends``,
``data.pipeline.audio_stream``); the 48-layer decoder-only transformer over
those frames is real, with 4 parallel codebook heads on the output.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    source="arXiv:2306.05284 (MusicGen)",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    block_pattern=(ATTN_GLOBAL,),
    mlp_kind="gelu",
    tie_embeddings=False,
    frontend="audio",
    num_codebooks=4,
)
