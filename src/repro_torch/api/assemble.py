"""``compile_serve``: ServeSpec -> live Server (``repro.api.assemble``)."""
from __future__ import annotations

from repro_torch.api.serve import Server
from repro_torch.api.spec import ServeSpec
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.transformer import ATTN_KINDS


def compile_serve(spec: ServeSpec, params=None, device=None,
                  recorder=None) -> Server:
    """Assemble a live :class:`~repro_torch.api.serve.Server` from ``spec``.

    ``params`` serves given weights (e.g. the reference's, carried over by
    ``interop.params_from_numpy``); ``None`` initializes fresh ones from
    ``spec.seed``.  ``device`` defaults to the GPU and raises when none is
    visible; pass ``device="cpu"`` to run on the CPU.  ``recorder`` receives
    prefill/decode spans and preempt events.  The archs the reference
    rejects are rejected here with the same reasons, and so are MoE configs,
    which the port does not serve yet — before any buffer is allocated.
    """
    cfg = get_config(spec.arch) if isinstance(spec.arch, str) else spec.arch
    if not isinstance(cfg, ModelConfig):
        raise ValueError(
            f"compile_serve needs a token LM ModelConfig, got "
            f"{type(cfg).__name__} — serving covers the transformer family "
            "only")
    cfg = smoke_variant(cfg) if spec.smoke else cfg
    bad = [k for k in cfg.block_pattern if k not in ATTN_KINDS]
    if bad:
        raise ValueError(
            f"paged decode serves attention blocks only ({ATTN_KINDS}); "
            f"{cfg.name!r} has {bad} in its pattern")
    if cfg.frontend is not None or cfg.num_codebooks or cfg.mrope:
        raise ValueError(
            f"{cfg.name!r} uses a modality frontend / codebook heads / "
            "M-RoPE — token-in/token-out archs only for serving")
    if cfg.num_experts:
        raise ValueError(f"{cfg.name!r} is a MoE config: MoE blocks are not "
                         "ported yet")

    dev = resolve_device(device)
    if params is None:
        params = transformer.init_params(cfg, spec.seed, dev)
    return Server(spec=spec, cfg=cfg, params=params, device=dev,
                  recorder=recorder)
