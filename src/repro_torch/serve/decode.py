"""Batched prefill and incremental decode over ring-buffered caches
(``repro.serve.decode``).

``prefill`` runs the full-sequence forward and fills the caches;
``decode_step`` consumes one token per request against them; ``generate``
drives greedy or temperature sampling.  Everything runs where the params
live (``transformer.init_params`` puts them on the GPU unless asked for the
CPU).  The caches' tensors are written in place, so a step's returned
caches hold the same storage with new lengths.

This is the dense, fixed-batch path: every request of the batch has the
same prompt length and each attention layer's cache holds ``capacity``
positions (its window, for a sliding-window layer); an SSM layer's cache
holds its recurrent state (``models.ssm``).  It serves every family the
reference's ``generate`` does, SSM and hybrid models among them, which the
serving engine (``api.serve.Server``) rejects.  Decode attends the ring
buffer through the plain ``kernels.ref.decode_attention_ref``, as the
reference does; the serving engine decodes through the paged kernel
instead.

``ctx`` (``core.sharding.ShardingCtx``, in the reference's position) runs
the model on its mesh's model axis, ``params`` in its member layout; with
a ``cache_seq`` rule that maps onto mesh axes of extent > 1 dividing the
capacity (``core.hybrid.plan`` picks ``("model",)`` when the kv heads do
not split over the model ways), ``prefill`` hands back its ring caches
sequence-sharded (``transformer.shard_caches``) and every decode step
attends them through ``layers.sharded_decode_attention``.

With M-RoPE (qwen2-vl) a decode step's position is the scalar position
repeated three times, as in the reference: after a prefill with image
embeddings, whose M-RoPE text positions start past the image grid
(``frontends.mrope_positions``), the decode positions continue from the
sequence length instead.  The port keeps that difference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sharding import ShardingCtx
from repro_torch.models import transformer


@torch.no_grad()
def prefill(params, cfg: ModelConfig, ctx: ShardingCtx,
            tokens: Optional[torch.Tensor], capacity: int, *,
            embeds: Optional[torch.Tensor] = None, long_ctx: bool = False):
    """tokens: (B, S) and/or embeds: (B, S_e, d) (``transformer.forward``'s
    inputs).  Returns (last_logits (B, V), caches), the ring caches
    sequence-sharded under a ``cache_seq`` rule (module docstring)."""
    first = tokens if tokens is not None else embeds
    caches = transformer.init_caches(cfg, first.shape[0], capacity,
                                     long_ctx=long_ctx, device=first.device)
    logits, _, caches = transformer.forward(
        params, cfg, ctx, tokens=tokens, embeds=embeds, caches=caches,
        update_cache=True, long_ctx=long_ctx)
    return logits[:, -1], transformer.shard_caches(caches, ctx)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, ctx: ShardingCtx,
                tokens: torch.Tensor, pos, caches, *,
                long_ctx: bool = False):
    """tokens: (B, 1) the latest sampled token; pos: an int or (B,) absolute
    position.  Returns (logits (B, V), new_caches)."""
    B = tokens.shape[0]
    pos_b = torch.as_tensor(pos, device=tokens.device).reshape(-1, 1) \
        .expand(B, 1)
    if cfg.mrope:
        pos_b = pos_b[..., None].expand(B, 1, 3)
    logits, _, caches = transformer.forward(
        params, cfg, ctx, tokens=tokens, positions=pos_b, caches=caches,
        long_ctx=long_ctx)
    return logits[:, -1], caches


def generate(params, cfg: ModelConfig, ctx: ShardingCtx, prompt,
             max_new_tokens: int, *, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             capacity: Optional[int] = None) -> torch.Tensor:
    """Greedy (``temperature`` 0: the first maximum on ties) or sampled
    generation.  prompt: (B, S) ints.  Sampling draws from ``generator``
    (default: one seeded with 0 on the params' device).  Returns (B,
    max_new_tokens) int64 on the params' device."""
    dev = params["final_norm"].device
    prompt = torch.as_tensor(prompt, device=dev)
    B, S = prompt.shape
    capacity = capacity or (S + max_new_tokens)
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def sample(lg):
        if temperature <= 0:
            return torch.argmax(lg, dim=-1)
        probs = torch.softmax(lg.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    logits, caches = prefill(params, cfg, ctx, prompt, capacity)
    cur = sample(logits)[:, None]
    toks = [cur]
    for i in range(1, max_new_tokens):
        logits, caches = decode_step(params, cfg, ctx, cur, S + i - 1,
                                     caches)
        cur = sample(logits)[:, None]
        toks.append(cur)
    return torch.cat(toks, dim=1)
