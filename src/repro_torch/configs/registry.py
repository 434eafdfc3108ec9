"""Architecture registry of the port: ``--arch <id>`` resolution and the
reduced smoke variants (``repro.configs.registry`` with the families'
reduction recipes, ``repro.api.families._cnn_smoke``, ``_dnn_smoke`` and
``_transformer_smoke``)."""
from __future__ import annotations

import importlib
from typing import Union

from repro_torch.configs.base import (
    INPUT_SHAPES,
    CNNConfig,
    ConvLayerSpec,
    DNNConfig,
    InputShape,
    ModelConfig,
)

# every architecture of the reference's registry
_MODULES = {
    "llama3-8b": "llama3_8b",
    "gemma2-2b": "gemma2_2b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "gemma-2b": "gemma_2b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "llama-100m": "llama_100m",
    "xlstm-125m": "xlstm_125m",
    "zamba2-2.7b": "zamba2_2_7b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "musicgen-medium": "musicgen_medium",
    "vgg-a": "vgg_a",
    "overfeat-fast": "overfeat_fast",
    "cd-dnn": "cd_dnn",
}

ARCHS = tuple(_MODULES)

# assigned pool (10) + the paper's own workloads (3)
ASSIGNED_ARCHS = (
    "gemma2-2b", "qwen2-moe-a2.7b", "llama3-8b", "qwen2-vl-2b",
    "zamba2-2.7b", "xlstm-125m", "musicgen-medium", "gemma-2b",
    "h2o-danube-3-4b", "mixtral-8x22b",
)
PAPER_ARCHS = ("vgg-a", "overfeat-fast", "cd-dnn")
ALL_ARCHS = ASSIGNED_ARCHS + PAPER_ARCHS

AnyConfig = Union[ModelConfig, CNNConfig, DNNConfig]


def get_config(name: str) -> AnyConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_input_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


def smoke_variant(cfg: AnyConfig) -> AnyConfig:
    """Reduced variant of the same family for CPU smoke tests, by config
    class — the reference's recipes, value for value."""
    if isinstance(cfg, CNNConfig):
        return _cnn_smoke(cfg)
    if isinstance(cfg, DNNConfig):
        return _dnn_smoke(cfg)
    return _transformer_smoke(cfg)


def _cnn_smoke(cfg: CNNConfig) -> CNNConfig:
    # keep first two convs + last fc, shrink maps
    L = ConvLayerSpec
    return CNNConfig(
        name=cfg.name + "-smoke", source=cfg.source, image_size=32,
        num_classes=16,
        layers=(
            L("conv", ifm=3, ofm=16, kernel=3, stride=1, pad=1, out_hw=32),
            L("pool", out_hw=16),
            L("conv", ifm=16, ofm=32, kernel=3, stride=1, pad=1, out_hw=16),
            L("pool", out_hw=8),
            L("fc", ifm=32 * 8 * 8, ofm=64, out_hw=1),
            L("fc", ifm=64, ofm=16, out_hw=1),
        ),
    )


def _dnn_smoke(cfg: DNNConfig) -> DNNConfig:
    return DNNConfig(name=cfg.name + "-smoke", source=cfg.source,
                     input_dim=40, hidden_dim=64, num_hidden=3,
                     output_dim=32)


def _transformer_smoke(cfg: ModelConfig) -> ModelConfig:
    """≤2 pattern repeats, d_model ≤ 256, head_dim 32, ≤4 experts, small
    vocab."""
    unit = cfg.block_pattern
    # keep the heterogeneity of the unit but only 1-2 repeats
    repeats = 1 if len(unit) > 2 else 2
    d_model = min(cfg.d_model, 256)
    head_dim = 32
    heads = max(2, min(4, cfg.num_heads))
    kv = max(1, min(heads, cfg.num_kv_heads))
    while heads % kv:
        kv -= 1
    # rescale M-RoPE sections to the reduced head_dim (keep 1/4:3/8:3/8)
    mrope_sections = cfg.mrope_sections
    if cfg.mrope:
        half = head_dim // 2
        a = half // 4
        b = (half - a) // 2
        mrope_sections = (a, b, half - a - b)
    return cfg.replace(
        num_layers=repeats * len(unit),
        pattern_repeats=repeats,
        mrope_sections=mrope_sections,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2)
        if cfg.num_experts else 0,
        moe_capacity_factor=(min(cfg.num_experts, 4)
                             / max(1, min(cfg.num_experts_per_tok, 2))
                             if cfg.num_experts else 1.25),
        moe_d_ff=min(cfg.moe_d_ff, 128) if cfg.moe_d_ff else 0,
        num_shared_experts=min(cfg.num_shared_experts, 1),
        shared_expert_d_ff=min(cfg.shared_expert_d_ff, 128),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_heads=min(cfg.ssm_heads, 8) if cfg.ssm_heads else 0,
        sliding_window=min(cfg.sliding_window, 64),
        long_context_window=64,
        vision_tokens=16,
        remat="none",
        fsdp=False,
    )
