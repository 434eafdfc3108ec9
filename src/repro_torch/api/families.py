"""Family-adapter registry of the port (``repro.api.families``): each
model family declares its training glue once, keyed by its config class,
and ``adapter_for(cfg)`` resolves it by MRO.

The ``cnn`` family (VGG-A, OverFeat-FAST), the ``dnn`` family (CD-DNN)
and the ``transformer`` family (every LM: next-token CE, AdamW; batches
from the seeded ``lm_token_stream``, or ``vlm_stream`` for a vision
frontend and ``audio_stream`` for an audio one) are ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Type

from repro_torch.configs.base import CNNConfig, DNNConfig, ModelConfig
from repro_torch.core.params import map_tree
from repro_torch.data.pipeline import (
    asr_frame_stream,
    audio_stream,
    image_stream,
    lm_token_stream,
    vlm_stream,
)
from repro_torch.models import cnn, dnn, transformer


@dataclass(frozen=True)
class FamilyAdapter:
    """Everything ``compile_run`` needs to assemble a family's training run.

    init:         (cfg, seed, device) -> param tree
    make_loss:    (cfg, ctx) -> loss_fn(params, batch) -> scalar, params in
                  ``ctx``'s member layout (``core.sharding.ShardingCtx``),
                  every family on its mesh's model axis
    param_specs:  cfg -> tree of ``core.params.Spec`` (shapes and logical
                  axes), the structure of the param tree
    stream:       (cfg, batch, seq, seed) -> iterator of host batches
    default_optimizer: "sgd" (the paper's CNN/DNN optimizer) or "adamw"

    The reference's ``smoke`` field has no counterpart: the port's smoke
    variants dispatch by config class in ``configs.registry.
    smoke_variant``.
    """
    family: str
    config_cls: Type
    init: Callable[..., Any]
    make_loss: Callable[..., Callable]
    param_specs: Callable[[Any], Any]
    stream: Callable[[Any, int, int, int], Iterator]
    default_optimizer: str = "adamw"

    def param_axes(self, cfg) -> Any:
        """The logical-axes tree matching the param tree (for the
        zero1-gspmd state specs and rules-based placement)."""
        return map_tree(lambda s: s.axes, self.param_specs(cfg))


_REGISTRY: Dict[Type, FamilyAdapter] = {}


def register_family(adapter: FamilyAdapter) -> FamilyAdapter:
    """Register ``adapter`` for its config class (last registration wins)."""
    _REGISTRY[adapter.config_cls] = adapter
    return adapter


def adapter_for(cfg) -> FamilyAdapter:
    """Resolve the family adapter for a config instance by MRO."""
    for cls in type(cfg).__mro__:
        if cls in _REGISTRY:
            return _REGISTRY[cls]
    raise TypeError(
        f"no family adapter registered for {type(cfg).__name__}; "
        f"known families: {sorted(a.family for a in _REGISTRY.values())}")


CNN_FAMILY = register_family(FamilyAdapter(
    family="cnn", config_cls=CNNConfig,
    init=cnn.init_params,
    make_loss=lambda cfg, ctx: lambda p, b: cnn.loss_fn(p, cfg, b, ctx=ctx),
    param_specs=cnn.param_specs,
    stream=lambda cfg, batch, seq, seed: image_stream(
        cfg.image_size, cfg.num_classes, batch, seed),
    default_optimizer="sgd",
))

DNN_FAMILY = register_family(FamilyAdapter(
    family="dnn", config_cls=DNNConfig,
    init=dnn.init_params,
    make_loss=lambda cfg, ctx: lambda p, b: dnn.loss_fn(p, cfg, b, ctx=ctx),
    param_specs=dnn.param_specs,
    stream=lambda cfg, batch, seq, seed: asr_frame_stream(
        cfg.input_dim, cfg.output_dim, batch, seed),
    default_optimizer="sgd",
))


def _transformer_stream(cfg: ModelConfig, batch: int, seq: int, seed: int):
    # a vision run's seq counts the image's tokens and the text's
    if cfg.frontend == "vision":
        return vlm_stream(cfg, batch, seq - cfg.vision_tokens, seed)
    if cfg.frontend == "audio":
        return audio_stream(cfg, batch, seq, seed)
    return lm_token_stream(cfg.vocab_size, batch, seq, seed)


TRANSFORMER_FAMILY = register_family(FamilyAdapter(
    family="transformer", config_cls=ModelConfig,
    init=transformer.init_params,
    make_loss=lambda cfg, ctx: lambda p, b: transformer.lm_loss(p, cfg, ctx,
                                                                 b),
    param_specs=transformer.param_specs,
    stream=_transformer_stream,
    default_optimizer="adamw",
))
