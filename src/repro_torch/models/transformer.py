"""Config-driven decoder assembly of the port (``repro.models.transformer``
for the attention-block token LMs): params, caches, the forward and the
next-token losses.

Params keep the reference's tree: per pattern entry, each block's weights
are stacked on a leading ``pattern_repeats`` axis (R).  The reference
``lax.scan``s over R; here a Python loop walks the repeats over the stacked
weights, unbound once per forward, and indexes the caches.  Caches mirror
the params: a tuple (one entry per pattern position) of cache objects whose
tensors carry the leading R axis; a layer writes through its view of them
in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

import torch

from repro_torch.configs.base import (
    ATTN_GLOBAL,
    ATTN_LOCAL,
    BLOCK_SHARED_ATTN,
    ModelConfig,
)
from repro_torch.core.params import Spec, init_tree, map_tree, tree_leaves
from repro_torch.device import resolve_device
from repro_torch.models import layers, moe
from repro_torch.models.layers import attention_block, mlp_block, rms_norm

ATTN_KINDS = (ATTN_GLOBAL, ATTN_LOCAL, BLOCK_SHARED_ATTN)


# ---------------------------------------------------------------------------
# param specs
# ---------------------------------------------------------------------------
def _block_specs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    if kind not in (ATTN_GLOBAL, ATTN_LOCAL):
        raise ValueError(f"block kind {kind!r} is not ported yet")
    sp = {"attn": layers.attn_specs(cfg)}
    if cfg.num_experts:
        sp["moe"] = moe.moe_specs(cfg)
    else:
        sp["mlp"] = layers.mlp_specs(cfg)
    return sp


def _stack_specs(sp, repeats: int):
    return map_tree(lambda s: Spec((repeats,) + s.shape, (None,) + s.axes,
                                   s.init, s.scale), sp)


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, V = cfg.d_model, cfg.vocab_size
    if cfg.num_codebooks:
        raise ValueError("codebook heads are not ported yet")
    specs: Dict[str, Any] = {
        "embed": Spec((V, d), ("vocab", "embed"), init="embed", scale=0.02),
        "final_norm": Spec((d,), ("embed",), init="zeros"),
        "blocks": tuple(_stack_specs(_block_specs(cfg, kind),
                                     cfg.pattern_repeats)
                        for kind in cfg.block_pattern),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = Spec((d, V), ("embed", "vocab"))
    return specs


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype=torch.float32):
    """Fresh params on ``device`` (default: the GPU), drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_tree(param_specs(cfg), gen, dev, dtype)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def effective_window(cfg: ModelConfig, kind: str, long_ctx: bool) -> int:
    """Attention window per block kind; ``long_ctx`` swaps full attention for
    the sliding-window variant."""
    if kind == ATTN_LOCAL:
        return cfg.sliding_window
    if kind in (ATTN_GLOBAL, BLOCK_SHARED_ATTN):
        return cfg.long_context_window if long_ctx else 0
    return 0


def _stack(caches):
    """R per-layer cache objects -> one object of R-stacked tensors."""
    first = caches[0]
    return type(first)(**{
        f.name: (torch.stack([getattr(c, f.name) for c in caches])
                 if isinstance(getattr(first, f.name), torch.Tensor)
                 else getattr(first, f.name))
        for f in dataclasses.fields(first)})


def _at(cache, r: int):
    """Layer ``r``'s view of an R-stacked cache object."""
    return type(cache)(**{
        f.name: (getattr(cache, f.name)[r]
                 if isinstance(getattr(cache, f.name), torch.Tensor)
                 else getattr(cache, f.name))
        for f in dataclasses.fields(cache)})


def init_caches(cfg: ModelConfig, batch: int, context_len: int,
                long_ctx: bool = False, dtype=torch.bfloat16, device=None):
    """Tuple (per pattern entry) of R-stacked ring-buffer caches."""
    caches = []
    for kind in cfg.block_pattern:
        if kind not in ATTN_KINDS:
            raise ValueError(f"block kind {kind!r} is not ported yet")
        w = effective_window(cfg, kind, long_ctx)
        cap = min(w, context_len) if w else context_len
        caches.append(_stack([
            layers.init_attn_cache(cfg, batch, cap, dtype, device)
            for _ in range(cfg.pattern_repeats)]))
    return tuple(caches)


def init_paged_caches(cfg: ModelConfig, batch: int, num_pages: int,
                      page_size: int, pages_per_req: int,
                      dtype=torch.bfloat16, impl: str = "kernel",
                      device=None):
    """Tuple (per pattern entry) of R-stacked
    :class:`~repro_torch.models.layers.PagedKVState`: every layer owns its
    own physical page pool; page table and lengths are per layer too, as in
    the reference."""
    caches = []
    for kind in cfg.block_pattern:
        if kind not in ATTN_KINDS:
            raise ValueError(
                f"paged KV caches support attention blocks only, got {kind!r}")
        caches.append(_stack([layers.init_paged_kv_state(
            cfg, batch, num_pages, page_size, pages_per_req, dtype, impl,
            device) for _ in range(cfg.pattern_repeats)]))
    return tuple(caches)


def _restack(stacked, per_layer):
    """The pools were written in place through each layer's view; only the
    length counters are new."""
    name = "lengths" if isinstance(stacked, layers.PagedKVState) else "length"
    return dataclasses.replace(stacked, **{
        name: torch.stack([getattr(c, name) for c in per_layer])})


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _unstack(tree, repeats: int) -> list:
    """The ``repeats`` per-layer trees of a tree of R-stacked weights.  Each
    leaf is unbound once: the backward of ``torch.unbind`` stacks the R
    layer gradients in one allocation, where indexing ``w[r]`` in every
    layer would add R zero-filled gradients of the whole stacked leaf."""
    cols = [torch.unbind(w) for w in tree_leaves(tree)]

    def layer(r):
        it = iter([c[r] for c in cols])
        return map_tree(lambda _: next(it), tree)

    return [layer(r) for r in range(repeats)]


def forward(params, cfg: ModelConfig, *, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None, caches=None,
            update_cache: bool = False, long_ctx: bool = False,
            return_hidden: bool = False, use_kernel: bool = False):
    """Returns (logits, aux_loss, new_caches) for ``tokens`` (B, S), or
    the final-normed hidden states in place of the logits when
    ``return_hidden``; ``positions`` (B, S) default to ``arange(S)``.
    ``use_kernel`` runs every cacheless attention on the flash kernel
    (``layers.attention_block``).  ``aux_loss`` is the sum of the MoE
    blocks' load-balance losses (zero without experts)."""
    emb_scale = float(np.float32(cfg.d_model ** 0.5))
    x = (params["embed"][tokens.long()] * emb_scale).to(torch.bfloat16)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)

    have_cache = caches is not None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_layer = [[] for _ in cfg.block_pattern]
    blocks = [_unstack(bp, cfg.pattern_repeats) for bp in params["blocks"]]
    for r in range(cfg.pattern_repeats):
        for j, kind in enumerate(cfg.block_pattern):
            p = blocks[j][r]
            cache = _at(caches[j], r) if have_cache else None
            x, nc = attention_block(
                p["attn"], x, cfg, positions,
                window=effective_window(cfg, kind, long_ctx), cache=cache,
                update_cache=update_cache, use_kernel=use_kernel)
            if "moe" in p:
                x, aux_j = moe.moe_block(p["moe"], x, cfg)
                aux = aux + aux_j
            else:
                x = mlp_block(p["mlp"], x, cfg)
            if have_cache:
                per_layer[j].append(nc if nc is not None else cache)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    new_caches = (tuple(_restack(c, pl) for c, pl in zip(caches, per_layer))
                  if have_cache else None)
    if return_hidden:
        return x, aux, new_caches
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T.to(x.dtype)
    else:
        logits = x @ params["lm_head"].to(x.dtype)
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits, aux, new_caches


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in f32 (``logits`` (..., V), ``labels`` (...))."""
    lf = logits.float()
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return (torch.logsumexp(lf, dim=-1) - gold).mean()


def chunked_lm_loss(params, cfg: ModelConfig, hidden: torch.Tensor,
                    labels: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """CE over sequence chunks, so the (B, S, V) f32 logits are never whole
    (the reference's perf knob ``loss_chunk``)."""
    B, S, _ = hidden.shape
    Sm1 = S - 1
    chunk = -(-Sm1 // n_chunks)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        lo = i * chunk
        hi = min(lo + chunk, Sm1)
        if lo >= hi:
            break
        hc = hidden[:, lo:hi]
        logits = hc @ w.to(hc.dtype)
        if cfg.final_logit_softcap:
            c = cfg.final_logit_softcap
            logits = torch.tanh(logits / c) * c
        lf = logits.float()
        # hidden positions lo..hi-1 predict tokens lo+1..hi
        gold = torch.gather(lf, -1, labels[:, lo + 1:hi + 1, None].long())
        total = total + (torch.logsumexp(lf, -1) - gold[..., 0]).sum()
    return total / (B * Sm1)


def lm_loss(params, cfg: ModelConfig, batch: dict,
            use_kernel: bool = False) -> torch.Tensor:
    """Next-token CE of a token LM; ``batch["tokens"]`` (B, S).  With
    ``cfg.loss_chunk`` the CE runs over sequence chunks.  ``use_kernel``
    puts every attention forward on the flash kernel.  The vision and audio
    branches of the reference wait for their frontends."""
    if cfg.frontend is not None or cfg.num_codebooks:
        raise NotImplementedError(
            f"{cfg.name!r}: the {cfg.frontend or 'codebook'} frontend's loss "
            "is not ported yet")
    tokens = batch["tokens"]
    if cfg.loss_chunk:
        hidden, aux, _ = forward(params, cfg, tokens=tokens,
                                 return_hidden=True, use_kernel=use_kernel)
        return chunked_lm_loss(params, cfg, hidden, tokens,
                               cfg.loss_chunk) + aux
    logits, aux, _ = forward(params, cfg, tokens=tokens,
                             use_kernel=use_kernel)
    return _ce(logits[:, :-1], tokens[:, 1:]) + aux
