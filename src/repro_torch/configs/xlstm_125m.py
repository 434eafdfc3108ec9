"""xlstm-125m [ssm] — xLSTM 125M [arXiv:2405.04517].

12 blocks, d_model 768, 4 heads (head_dim 192), vocab 50304, d_ff 0 (the
xLSTM blocks carry their own up/down projections, expand 2).  Alternating
mLSTM (matrix memory) / sLSTM (scalar memory) blocks — an xLSTM[1:1]-style
stack.
"""
from repro_torch.configs.base import BLOCK_MLSTM, BLOCK_SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    source="arXiv:2405.04517 (xLSTM)",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    block_pattern=(BLOCK_MLSTM, BLOCK_SLSTM),
    ssm_expand=2,
    mlp_kind="gelu",
    tie_embeddings=True,
)
