"""Model configs: the port's own copy of ``repro.configs.base.ModelConfig``,
``ConvLayerSpec``, ``CNNConfig`` and the block-kind constants, field for
field (the two packages share no code, so a config object of one is rebuilt
in the other from ``dataclasses.asdict``)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block kinds understood by models/transformer.py
# ---------------------------------------------------------------------------
ATTN_GLOBAL = "global"        # full causal attention
ATTN_LOCAL = "local"          # sliding-window causal attention
BLOCK_MAMBA = "mamba"         # Mamba2 (SSD) block
BLOCK_SHARED_ATTN = "shared_attn"  # zamba2-style shared attention+MLP block
BLOCK_MLSTM = "mlstm"         # xLSTM matrix-LSTM block
BLOCK_SLSTM = "slstm"         # xLSTM scalar-LSTM block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | hybrid | ssm | audio
    source: str                      # citation for the config numbers

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # --- attention ---
    block_pattern: Tuple[str, ...] = (ATTN_GLOBAL,)
    pattern_repeats: int = 0
    sliding_window: int = 4096       # window for ATTN_LOCAL blocks
    attn_logit_softcap: float = 0.0  # gemma2: 50.0
    final_logit_softcap: float = 0.0 # gemma2: 30.0
    rope_theta: float = 10000.0
    mrope: bool = False              # qwen2-vl M-RoPE (3 rotary sections)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    qk_norm: bool = False

    # --- mlp ---
    mlp_kind: str = "swiglu"         # swiglu | geglu | gelu
    tie_embeddings: bool = True

    # --- moe ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0                # per-expert hidden size
    num_shared_experts: int = 0
    shared_expert_d_ff: int = 0
    router_aux_loss_coef: float = 0.001
    moe_capacity_factor: float = 1.25
    moe_expert_pad: int = 0
    moe_down_rs: bool = False
    loss_chunk: int = 0
    seq_shard_carry: bool = False

    # --- ssm / hybrid ---
    ssm_state: int = 0               # mamba2 state dim per head
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_conv_width: int = 4

    # --- modality frontends ---
    frontend: Optional[str] = None   # None | "vision" | "audio"
    num_codebooks: int = 0           # musicgen
    vision_tokens: int = 1024

    # --- numerics ---
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"

    # --- distribution ---
    fsdp: bool = False
    long_context_window: int = 4096  # SWA window substituted at long_500k decode
    remat: str = "none"

    def __post_init__(self):
        if self.pattern_repeats == 0 and self.num_layers:
            object.__setattr__(
                self, "pattern_repeats", self.num_layers // len(self.block_pattern))
        if self.num_layers and (
                self.num_layers != self.pattern_repeats * len(self.block_pattern)):
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} is not "
                f"pattern_repeats x len({self.block_pattern})")
        if self.num_heads and self.num_kv_heads and (
                self.num_heads % self.num_kv_heads):
            raise ValueError(
                f"{self.name}: num_heads must be a multiple of num_kv_heads")

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        if "block_pattern" in kw or "num_layers" in kw:
            kw.setdefault("pattern_repeats", 0)
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ConvLayerSpec:
    """One layer of a paper CNN (VGG-A / OverFeat-FAST), for models/cnn.py."""
    kind: str          # conv | pool | fc
    ifm: int = 0
    ofm: int = 0
    kernel: int = 0
    stride: int = 1
    pad: int = 0
    out_hw: int = 0    # output feature-map spatial size (square)


@dataclass(frozen=True)
class CNNConfig:
    name: str
    source: str
    layers: Tuple[ConvLayerSpec, ...]
    image_size: int
    num_classes: int = 1000
    family: str = "cnn"

    def conv_layers(self):
        return [lyr for lyr in self.layers if lyr.kind == "conv"]

    def fc_layers(self):
        return [lyr for lyr in self.layers if lyr.kind == "fc"]
