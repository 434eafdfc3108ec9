"""Config-driven decoder assembly of the port (``repro.models.transformer``):
params, caches, the forward and the next-token losses of every LM family:
dense and MoE attention blocks, Mamba2, mLSTM and sLSTM blocks
(``models.ssm``), zamba2's shared attention block, M-RoPE positions, vision
and audio frontend embeddings and codebook heads.

Params keep the reference's tree: per pattern entry, each block's weights
are stacked on a leading ``pattern_repeats`` axis (R).  The reference
``lax.scan``s over R; here a Python loop walks the repeats over the stacked
weights, unbound once per forward, and indexes the caches.  Zamba2's shared
attention(+MLP) block is weight-shared: its pattern entry holds an empty
``{}`` and its one set of weights lives unstacked under ``"shared"``, used
at every repeat (autograd sums the R gradients).  ``cfg.remat``
checkpoints each repeat of the pattern, the reference's scan body, when
gradients are taken (:func:`remat_body`).  Caches mirror the params:
a tuple (one entry per pattern position) of cache objects whose tensors
carry the leading R axis.  An attention layer writes its keys and values
through its view of them in place; an SSM layer returns new states, which
the forward stacks into the returned caches.

Under a model axis (``ctx``, ``core.sharding.ShardingCtx``) the params are
in ``ctx``'s member layout: a model-sharded stacked leaf is ``(M, R,
...)`` on a local mesh, so that member m's block of layer r, ``w[m][r]``,
is contiguous and no step copies it, and the rank's ``(R, ...)`` block on
a process mesh.  The embedding is vocab-parallel: each member looks up the
tokens in its row range (zeros elsewhere) and the members' rows are summed.
The tied head, ``lm_head`` and ``codebook_heads`` are column-parallel over
``"vocab"``: each member's logits over its vocab columns, joined by
``gather_model`` into the whole logits, and the CE is the reference's on
them.  The blocks are ``layers``', ``moe``'s and ``ssm``'s own model-axis
forms.  ``seq_shard_carry`` (the reference's layout hint for the residual
stream) changes nothing here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

import torch

from repro_torch.configs.base import (
    ATTN_GLOBAL,
    ATTN_LOCAL,
    BLOCK_MAMBA,
    BLOCK_MLSTM,
    BLOCK_SHARED_ATTN,
    BLOCK_SLSTM,
    ModelConfig,
)
from repro_torch.core.params import Spec, init_tree, map_tree, tree_leaves
from repro_torch.core.sharding import ShardingCtx
from repro_torch.device import resolve_device
from repro_torch.models import layers, moe, ssm
from repro_torch.models.layers import attention_block, mlp_block, rms_norm

ATTN_KINDS = (ATTN_GLOBAL, ATTN_LOCAL, BLOCK_SHARED_ATTN)
# the residual stream's type (the reference's bf16); the CPU tests set f32
# in both packages to hold the model's wiring at f32 rounding
ACTIVATION_DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# param specs
# ---------------------------------------------------------------------------
def _block_specs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        sp = {"attn": layers.attn_specs(cfg)}
        if cfg.num_experts:
            sp["moe"] = moe.moe_specs(cfg)
        else:
            sp["mlp"] = layers.mlp_specs(cfg)
        return sp
    if kind == BLOCK_SHARED_ATTN:
        return {"attn": layers.attn_specs(cfg), "mlp": layers.mlp_specs(cfg)}
    if kind == BLOCK_MAMBA:
        return {"mamba": ssm.mamba_specs(cfg)}
    if kind == BLOCK_MLSTM:
        return {"mlstm": ssm.mlstm_specs(cfg)}
    if kind == BLOCK_SLSTM:
        return {"slstm": ssm.slstm_specs(cfg)}
    raise ValueError(kind)


def _stack_specs(sp, repeats: int):
    return map_tree(lambda s: Spec((repeats,) + s.shape, (None,) + s.axes,
                                   s.init, s.scale), sp)


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, V = cfg.d_model, cfg.vocab_size
    specs: Dict[str, Any] = {
        "embed": Spec((V, d), ("vocab", "embed"), init="embed", scale=0.02),
        "final_norm": Spec((d,), ("embed",), init="zeros"),
        # the shared block's entry is empty: its params live outside the stack
        "blocks": tuple({} if kind == BLOCK_SHARED_ATTN else
                        _stack_specs(_block_specs(cfg, kind),
                                     cfg.pattern_repeats)
                        for kind in cfg.block_pattern),
    }
    if BLOCK_SHARED_ATTN in cfg.block_pattern:
        specs["shared"] = _block_specs(cfg, BLOCK_SHARED_ATTN)
    if not cfg.tie_embeddings:
        specs["lm_head"] = Spec((d, V), ("embed", "vocab"))
    if cfg.num_codebooks:
        specs["codebook_heads"] = Spec((cfg.num_codebooks, d, V),
                                       ("codebooks", "embed", "vocab"))
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
    """Tuple (per pattern entry) of R-stacked caches: ring-buffer KV caches
    of ``dtype`` for attention blocks, f32 recurrent states for SSM
    blocks."""
    def make(kind):
        if kind in ATTN_KINDS:
            w = effective_window(cfg, kind, long_ctx)
            cap = min(w, context_len) if w else context_len
            return layers.init_attn_cache(cfg, batch, cap, dtype, device)
        init = {BLOCK_MAMBA: ssm.init_mamba_cache,
                BLOCK_MLSTM: ssm.init_mlstm_cache,
                BLOCK_SLSTM: ssm.init_slstm_cache}[kind]
        return init(cfg, batch, device=device)
    return tuple(_stack([make(kind) for _ in range(cfg.pattern_repeats)])
                 for kind in cfg.block_pattern)


def cache_axes(cfg: ModelConfig):
    """The logical axes of :func:`init_caches`' tree
    (``repro.models.transformer.cache_axes``): a tuple (per pattern entry)
    of cache objects whose fields hold axes tuples, each led by ``None``
    for the R axis."""
    def one(kind):
        if kind in ATTN_KINDS:
            ax = layers.attn_cache_axes()
        elif kind == BLOCK_MAMBA:
            ax = ssm.mamba_cache_axes()
        elif kind == BLOCK_MLSTM:
            ax = ssm.mlstm_cache_axes()
        else:
            ax = ssm.slstm_cache_axes()
        return dataclasses.replace(ax, **{
            f.name: (None,) + getattr(ax, f.name)
            for f in dataclasses.fields(ax)})
    return tuple(one(kind) for kind in cfg.block_pattern)


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
    """The new R-stacked cache of a pattern entry from its R layers' caches.
    Attention layers wrote their pools in place through their views, so
    only the length counters are new; SSM layers return new states, and
    every field is stacked."""
    if isinstance(stacked, layers.PagedKVState):
        names = ("lengths",)
    elif isinstance(stacked, layers.AttnCache):
        names = ("length",)
    else:
        names = tuple(f.name for f in dataclasses.fields(stacked))
    return dataclasses.replace(stacked, **{
        name: torch.stack([getattr(c, name) for c in per_layer])
        for name in names})


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _unstack(tree, repeats: int, specs=None,
             ctx: ShardingCtx = ShardingCtx()) -> list:
    """The ``repeats`` per-layer trees of a tree of R-stacked weights
    (``specs``: its ``Spec`` tree, needed under a model axis).  Each leaf
    is unbound once: the backward of ``torch.unbind`` stacks the R layer
    gradients in one allocation, where indexing ``w[r]`` in every layer
    would add R zero-filled gradients of the whole stacked leaf.  A model-sharded leaf
    on a local mesh, ``(M, R, ...)``, is unbound along R: layer r's leaf is
    its ``(M, ...)`` view."""
    leaves = tree_leaves(tree)
    local = ctx.model_ways > 1 and ctx.mesh.member_dims
    flags = [local and ctx.sharded(s) for s in tree_leaves(specs)] \
        if local else [False] * len(leaves)
    cols = [torch.unbind(w, 1 if f else 0) for w, f in zip(leaves, flags)]

    def layer(r):
        it = iter([c[r] for c in cols])
        return map_tree(lambda _: next(it), tree)

    return [layer(r) for r in range(repeats)]


def _apply_block(kind: str, p, shared_p, x, cfg: ModelConfig,
                 ctx: ShardingCtx, positions, *, long_ctx: bool, cache,
                 update_cache: bool, use_kernel: bool):
    """One block of the pattern.  Returns (x, aux loss or None, new cache
    or None)."""
    aux = None
    if kind in ATTN_KINDS:
        pp = shared_p if kind == BLOCK_SHARED_ATTN else p
        x, nc = attention_block(
            pp["attn"], x, cfg, ctx, positions,
            window=effective_window(cfg, kind, long_ctx), cache=cache,
            update_cache=update_cache, use_kernel=use_kernel)
        if "moe" in pp:
            x, aux = moe.moe_block(pp["moe"], x, cfg, ctx)
        else:
            x = mlp_block(pp["mlp"], x, cfg, ctx)
    elif kind == BLOCK_MAMBA:
        x, nc = ssm.mamba_block(p["mamba"], x, cfg, ctx, cache=cache)
    elif kind == BLOCK_MLSTM:
        x, nc = ssm.mlstm_block(p["mlstm"], x, cfg, ctx, cache=cache)
    elif kind == BLOCK_SLSTM:
        x, nc = ssm.slstm_block(p["slstm"], x, cfg, ctx, cache=cache)
    else:
        raise ValueError(kind)
    return x, aux, nc


def _save_plain_products(ctx, op, *args, **kwargs):
    """The ``"block_dots"`` policy: keep the outputs of plain matrix
    products (``mm``, ``addmm``), the products with no batch dims that
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` saves;
    recompute everything else (``bmm`` among it)."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_body(remat: str):
    """``fn(body, *args)`` running one repeat of the block pattern under
    the activation checkpointing ``cfg.remat`` names, as the reference
    wraps its scan body (``repro.models.transformer.make_scan_body``):
    ``"block"`` keeps the repeat's input alone and recomputes its forward
    in the backward; ``"block_dots"`` keeps the plain products' outputs
    too (:func:`_save_plain_products`); ``"none"``: None, the body runs
    as it is.  A recompute runs the body's kernels again: the flash
    kernel launches once more an attention block and a step."""
    if remat == "none":
        return None
    import functools

    from torch.utils.checkpoint import (
        checkpoint,
        create_selective_checkpoint_contexts,
    )
    if remat == "block":
        return functools.partial(checkpoint, use_reentrant=False)
    if remat == "block_dots":
        return functools.partial(
            checkpoint, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_plain_products))
    raise ValueError(f"remat must be none, block or block_dots: {remat!r}")


def shard_caches(caches, ctx: ShardingCtx):
    """The R-stacked caches with every attention ring cache's sequence
    split over the mesh axes ``ctx.rules`` maps ``cache_seq`` to
    (``layers.shard_cache``); unchanged without such an axis."""
    return tuple(layers.shard_cache(c, ctx)
                 if isinstance(c, layers.AttnCache) else c for c in caches)


def _embed(params, cfg: ModelConfig, ctx: ShardingCtx,
           tokens: torch.Tensor) -> torch.Tensor:
    """The scaled token embeddings in f32, vocab-parallel under a model
    axis (module docstring): exact, one member's row plus zeros."""
    emb_scale = float(np.float32(cfg.d_model ** 0.5))
    spec = param_specs(cfg)["embed"]
    if not ctx.sharded(spec):
        return params["embed"][tokens.long()] * emb_scale
    rows = cfg.vocab_size // ctx.model_ways

    def member(m, tok, w):
        at = tok.long() - m * rows
        mine = (at >= 0) & (at < rows)
        got = w[torch.where(mine, at, 0)] * emb_scale
        return got * mine[..., None].to(got.dtype)
    return ctx.summed(member, [tokens], [params["embed"]], [spec])


def _head(params, cfg: ModelConfig, ctx: ShardingCtx,
          x: torch.Tensor) -> torch.Tensor:
    """The logits of hidden ``x``: the codebook heads, the tied embedding
    or ``lm_head``, softcapped; column-parallel over ``"vocab"`` under a
    model axis, the members' columns joined (module docstring)."""
    sp = param_specs(cfg)
    name = ("codebook_heads" if cfg.num_codebooks else
            "embed" if cfg.tie_embeddings else "lm_head")

    def fn(x, w):
        if cfg.num_codebooks:
            logits = torch.einsum("bsd,kdv->bskv", x, w.to(x.dtype))
        else:
            logits = x @ (w.T if cfg.tie_embeddings else w).to(x.dtype)
        if cfg.final_logit_softcap:
            c = cfg.final_logit_softcap
            logits = torch.tanh(logits / c) * c
        return logits
    return ctx.column(x, [params[name]], [sp[name]], fn)


def forward(params, cfg: ModelConfig, ctx: ShardingCtx = ShardingCtx(), *,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None, caches=None,
            update_cache: bool = False, long_ctx: bool = False,
            return_hidden: bool = False, use_kernel: bool = False):
    """Returns (logits, aux_loss, new_caches), or the final-normed hidden
    states in place of the logits when ``return_hidden``.  ``params`` in
    ``ctx``'s member layout (module docstring).

    ``tokens`` (B, S) and/or ``embeds`` (B, S_e, d): for a VLM the two are
    concatenated, vision first; for audio only the embeds are used.  Both
    enter the blocks in ``ACTIVATION_DTYPE`` (bf16).  ``positions``: (B, S) ints, or (B, S, 3) for
    M-RoPE; ``arange`` over the whole sequence when None (repeated three
    times for M-RoPE).  ``use_kernel`` runs every cacheless attention on
    the flash kernel (``layers.attention_block``).  ``aux_loss`` is the sum
    of the MoE blocks' load-balance losses (zero without experts).  With
    ``cfg.num_codebooks`` the logits are (B, S, K, V), one head a
    codebook."""
    parts = []
    if embeds is not None:
        parts.append(embeds.to(ACTIVATION_DTYPE))
    if tokens is not None:
        parts.append(_embed(params, cfg, ctx, tokens).to(ACTIVATION_DTYPE))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
        if cfg.mrope:
            positions = positions[..., None].expand(B, S, 3)

    shared_p = params.get("shared")
    have_cache = caches is not None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_layer = [[] for _ in cfg.block_pattern]
    specs = param_specs(cfg)["blocks"]
    blocks = [_unstack(bp, cfg.pattern_repeats, sp, ctx)
              for bp, sp in zip(params["blocks"], specs)]

    def body(x, aux, r):
        """One repeat of the block pattern: the reference's scan body."""
        new = []
        for j, kind in enumerate(cfg.block_pattern):
            cache = _at(caches[j], r) if have_cache else None
            x, aux_j, nc = _apply_block(
                kind, blocks[j][r], shared_p, x, cfg, ctx, positions,
                long_ctx=long_ctx, cache=cache, update_cache=update_cache,
                use_kernel=use_kernel)
            if aux_j is not None:
                aux = aux + aux_j
            new.append(nc if nc is not None else cache)
        return x, aux, new

    remat = (remat_body(cfg.remat) if torch.is_grad_enabled()
             and not have_cache else None)
    for r in range(cfg.pattern_repeats):
        x, aux, new = (body(x, aux, r) if remat is None
                       else remat(body, x, aux, r))
        if have_cache:
            for j, c in enumerate(new):
                per_layer[j].append(c)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    new_caches = (tuple(_restack(c, pl) for c, pl in zip(caches, per_layer))
                  if have_cache else None)
    if return_hidden:
        return x, aux, new_caches
    return _head(params, cfg, ctx, x), aux, new_caches


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in f32 (``logits`` (..., V), ``labels`` (...))."""
    lf = logits.float()
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return (torch.logsumexp(lf, dim=-1) - gold).mean()


def chunked_lm_loss(params, cfg: ModelConfig, ctx: ShardingCtx,
                    hidden: torch.Tensor, labels: torch.Tensor,
                    n_chunks: int) -> torch.Tensor:
    """CE over sequence chunks, so the (B, S, V) f32 logits are never whole
    (the reference's perf knob ``loss_chunk``); each chunk's logits
    column-parallel under a model axis, as the forward's."""
    B, S, _ = hidden.shape
    Sm1 = S - 1
    chunk = -(-Sm1 // n_chunks)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        lo = i * chunk
        hi = min(lo + chunk, Sm1)
        if lo >= hi:
            break
        lf = _head(params, cfg, ctx, hidden[:, lo:hi]).float()
        # hidden positions lo..hi-1 predict tokens lo+1..hi
        gold = torch.gather(lf, -1, labels[:, lo + 1:hi + 1, None].long())
        total = total + (torch.logsumexp(lf, -1) - gold[..., 0]).sum()
    return total / (B * Sm1)


def lm_loss(params, cfg: ModelConfig, ctx: ShardingCtx, batch: dict,
            use_kernel: bool = False) -> torch.Tensor:
    """Next-token CE for every family, ``params`` in ``ctx``'s member
    layout.  ``batch`` keys: ``tokens`` (B, S) for the token LMs (dense,
    MoE, SSM, hybrid); for a vision frontend also ``patch_embeds`` (B,
    S_img, d) and optionally M-RoPE ``positions`` (B, S_img + S, 3), the CE
    over the text positions only; for audio ``frame_embeds`` (B, S, d) and
    ``codebook_labels`` (B, S, K), the CE over every codebook.  With
    ``cfg.loss_chunk`` a token LM's CE runs over sequence chunks.
    ``use_kernel`` puts every attention forward on the flash kernel."""
    kw = dict(use_kernel=use_kernel)
    if cfg.frontend == "audio":
        logits, aux, _ = forward(params, cfg, ctx,
                                 embeds=batch["frame_embeds"], **kw)
        labels = batch["codebook_labels"]                    # (B, S, K)
        return _ce(logits[:, :-1], labels[:, 1:]) + aux
    if cfg.frontend == "vision":
        logits, aux, _ = forward(params, cfg, ctx, tokens=batch["tokens"],
                                 embeds=batch["patch_embeds"],
                                 positions=batch.get("positions"), **kw)
        s_img = batch["patch_embeds"].shape[1]
        return _ce(logits[:, s_img:-1], batch["tokens"][:, 1:]) + aux
    tokens = batch["tokens"]
    if cfg.loss_chunk and not cfg.num_codebooks:
        hidden, aux, _ = forward(params, cfg, ctx, tokens=tokens,
                                 return_hidden=True, **kw)
        return chunked_lm_loss(params, cfg, ctx, hidden, tokens,
                               cfg.loss_chunk) + aux
    logits, aux, _ = forward(params, cfg, ctx, tokens=tokens, **kw)
    return _ce(logits[:, :-1], tokens[:, 1:]) + aux
