"""Transformer layers of the port: norms, RoPE and M-RoPE, attention, MLP.

``repro.models.layers`` with the reference's numerics: f32 norms and RoPE
angles, bf16 activations, every matmul bf16 @ ``w.to(bf16)``.  Layout is
(B, S, H, D) throughout.  The MoE layer is ``models.moe``; the SSM blocks
are ``models.ssm``.

Under a model axis (``ctx``, ``core.sharding.ShardingCtx``) the blocks
run once per model member on its own blocks: attention on the member's q
heads (``wq`` by column, ``wo`` by row; the flash kernel, under
``use_kernel``, once per member) and the MLP on its ``ff`` columns
(``w_gate``/``w_up`` by column, ``w_down`` by row); the members' partial
outputs are summed (``ShardingCtx.reduce``), where the reference
constrains the activations.  Kv heads that do not split over the members
(``Hkv % M != 0``: gemma-2b's one kv head at M = 2) are projected whole on
every member (``ShardingCtx.gather_leaf``), and each member attends the
global kv heads of its q heads.  Q heads that do not split (``Hq % M !=
0`` while ``q_dim`` does, so the rules still split ``wq``'s columns,
across a head boundary: gemma2-2b's 8 heads at the production mesh's 16
ways) take all four projections whole on every member, which repeats the
unsharded block alike.  :func:`sharded_decode_attention` is one
decode token over a ring cache whose sequence is split over the mesh axes
``cache_seq`` maps to: each member's f32 partials, combined by ``pmax``
and sums over those axes.

The reference's functions are pure and return new caches.  Here cache
writes happen IN PLACE on the tensors the cache objects hold (the page
pools of the serving engine are updated where they lie, as the reference's
donated buffers are), and the returned cache carries the new lengths.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as coll
from repro_torch.core.params import Spec
from repro_torch.core.sharding import ShardingCtx, to_members
from repro_torch.kernels import flash_attention
from repro_torch.kernels.ref import decode_attention_ref

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm scaled by ``1 + w`` (zero-initialised ``w``), in f32."""
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + w.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in f32 (biased variance), scaled by ``w``, shifted by
    ``b``."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE (split-half, f32 angles)
# ---------------------------------------------------------------------------
def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    D = x.shape[-1]
    freqs = _rope_freqs(D, theta, x.device)                  # (D/2,)
    ang = positions[..., None].float() * freqs               # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections, theta: float) -> torch.Tensor:
    """Qwen2-VL M-RoPE: positions3 (B, S, 3) = (temporal, height, width);
    the D/2 frequency slots are split into ``sections`` (sum = D/2), each
    section rotated by its own position component."""
    D = x.shape[-1]
    if sum(sections) != D // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {D // 2}")
    freqs = _rope_freqs(D, theta, x.device)                  # (D/2,)
    comp = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                      for i, s in enumerate(sections)])
    pos = positions3.float()[..., comp]                      # (B, S, D/2)
    ang = pos * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _rotate(x: torch.Tensor, positions: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """RoPE, or M-RoPE with ``cfg.mrope`` (positions (B, S, 3))."""
    if cfg.mrope:
        return apply_mrope(x, positions, cfg.mrope_sections, cfg.rope_theta)
    return apply_rope(x, positions, cfg.rope_theta)


# ---------------------------------------------------------------------------
# chunked online-softmax attention
# ---------------------------------------------------------------------------
def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      logit_softcap: float = 0.0,
                      scale: Optional[float] = None,
                      chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks; (B,S,H,D) layout, GQA.
    Query positions are right-aligned against the keys (``Skv - Sq``)."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    chunk = min(chunk, Skv)
    if Skv % chunk:
        chunk = Skv  # single chunk, as the reference does
    n_chunks = Skv // chunk

    qf = q.float() * scale
    q_pos = (torch.arange(Sq, device=q.device) + (Skv - Sq))[:, None, None]
    m = torch.full((B, Sq, Hq), NEG_INF, dtype=torch.float32, device=q.device)
    lsum = torch.zeros((B, Sq, Hq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, Hq, D), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        kb = k[:, ci * chunk:(ci + 1) * chunk].float()
        vb = v[:, ci * chunk:(ci + 1) * chunk].float()
        if g > 1:
            kb = kb.repeat_interleave(g, dim=2)
            vb = vb.repeat_interleave(g, dim=2)
        s = torch.einsum("bqhd,bkhd->bqhk", qf, kb)
        if logit_softcap > 0:
            s = torch.tanh(s / logit_softcap) * logit_softcap
        k_pos = (ci * chunk + torch.arange(chunk, device=q.device))[None, None, :]
        mask = torch.ones_like(k_pos, dtype=torch.bool)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window > 0:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask[None], s, NEG_INF)            # (B,Sq,Hq,chunk)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        lsum = lsum * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bqhk,bkhd->bqhd", p, vb)
        m = m_new
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# attention block: params, caches, apply
# ---------------------------------------------------------------------------
def attn_specs(cfg: ModelConfig) -> dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    emb = "embed_fsdp" if cfg.fsdp else "embed"
    return {
        "wq": Spec((d, qd), (emb, "heads")),
        "wk": Spec((d, kvd), (emb, "kv_heads")),
        "wv": Spec((d, kvd), (emb, "kv_heads")),
        "wo": Spec((qd, d), ("heads", emb)),
        "norm": Spec((d,), ("embed",), init="zeros"),
    }


@dataclasses.dataclass(frozen=True)
class AttnCache:
    """Ring-buffered KV cache: capacity C = window (SWA) or full context."""
    k: torch.Tensor          # (B, C, Hkv, D) — keys stored post-RoPE
    v: torch.Tensor
    length: torch.Tensor     # () int32 — total tokens seen


def attn_cache_axes() -> AttnCache:
    """The logical axes of each field of an :class:`AttnCache`
    (``repro.models.layers.attn_cache_axes``)."""
    ax = ("batch", "cache_seq", "kv_heads", "head_dim")
    return AttnCache(ax, ax, ())


@dataclasses.dataclass(frozen=True)
class SeqShardedCache(AttnCache):
    """An :class:`AttnCache` whose sequence is split over the mesh axes
    ``seq_axes`` (:func:`shard_cache`), ``k`` and ``v`` in member
    layout."""
    seq_axes: tuple = ()


def init_attn_cache(cfg: ModelConfig, batch: int, capacity: int,
                    dtype=torch.bfloat16, device=None) -> AttnCache:
    shp = (batch, capacity, cfg.num_kv_heads, cfg.head_dim)
    return AttnCache(torch.zeros(shp, dtype=dtype, device=device),
                     torch.zeros(shp, dtype=dtype, device=device),
                     torch.zeros((), dtype=torch.int32, device=device))


@dataclasses.dataclass(frozen=True)
class PagedKVState:
    """Paged KV cache of one attention layer.

    pages_k/pages_v: (P, ps, Hkv, D) — the physical page pool (page 0 is
    the serving engine's null page: idle slots write there and it is never
    attended by a live request).
    page_table:      (B, n) int32 — physical page per logical page.
    lengths:         (B,) int32 — tokens stored per request BEFORE the
    current decode token; position ``p`` lives in page ``p // ps`` at offset
    ``p % ps``.
    impl:            ``"kernel"`` (``kernels.paged_attn``: the Hopper kernel
    on CUDA tensors) or ``"gather"`` (its plain PyTorch version).  The
    reference's ``"pallas"`` is this port's ``"kernel"``.
    """
    pages_k: torch.Tensor
    pages_v: torch.Tensor
    page_table: torch.Tensor
    lengths: torch.Tensor
    impl: str = "kernel"


def init_paged_kv_state(cfg: ModelConfig, batch: int, num_pages: int,
                        page_size: int, pages_per_req: int,
                        dtype=torch.bfloat16, impl: str = "kernel",
                        device=None) -> PagedKVState:
    shp = (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    return PagedKVState(
        torch.zeros(shp, dtype=dtype, device=device),
        torch.zeros(shp, dtype=dtype, device=device),
        torch.zeros((batch, pages_per_req), dtype=torch.int32, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device), impl)


def paged_decode_attention_block(cache: PagedKVState, q: torch.Tensor,
                                 k_new: torch.Tensor, v_new: torch.Tensor, *,
                                 window: int, logit_softcap: float):
    """One decode token against the paged pool: write k/v at each request's
    next position through its page table (in place, BEFORE attending), then
    attend the valid set.  q/k_new/v_new: (B, 1, H, D).  Returns
    (out (B, 1, Hq, D), cache with lengths + 1)."""
    from repro_torch.kernels.paged_attn import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )
    ps = cache.pages_k.shape[1]
    pos = cache.lengths                                     # (B,)
    phys = torch.gather(cache.page_table, 1,
                        (pos // ps)[:, None].long())[:, 0].long()
    off = (pos % ps).long()
    # idle slots all write page 0 offset 0: which duplicate wins is
    # unspecified (as in the reference's scatter) and never read
    cache.pages_k[phys, off] = k_new[:, 0].to(cache.pages_k.dtype)
    cache.pages_v[phys, off] = v_new[:, 0].to(cache.pages_v.dtype)
    total = pos + 1                                         # valid counts
    attend = (paged_decode_attention if cache.impl == "kernel"
              else paged_decode_attention_plain)
    out = attend(q[:, 0].contiguous(), cache.pages_k, cache.pages_v,
                 cache.page_table, total, window=window,
                 logit_softcap=logit_softcap)
    return out[:, None], dataclasses.replace(cache, lengths=total)


def cache_seq_axes(ctx: ShardingCtx, capacity: int) -> tuple:
    """The mesh axes ``ctx.rules`` maps ``cache_seq`` to, when they have
    an extent > 1 that divides ``capacity`` (the reference's test for its
    sharded decode), else ``()``."""
    if ctx.mesh is None:
        return ()
    rule = ctx.rules.rules.get("cache_seq") or ()
    axes = tuple(a for a in ctx.mesh.axis_names if a in rule)
    n = coll.axis_size(ctx.mesh, axes) if axes else 1
    return axes if n > 1 and capacity % n == 0 else ()


def shard_cache(cache: AttnCache, ctx: ShardingCtx) -> AttnCache:
    """A whole (R-stacked or per-layer) ring cache with its sequence split
    over :func:`cache_seq_axes`, each layer's ``(B, C, Hkv, D)`` in the
    member layout of spec ``(None, axes)``: ``(n, B, C / n, Hkv, D)`` on a
    local mesh, the rank's ``(B, C / n, Hkv, D)`` on a process mesh.  The
    cache itself when there is no such axis."""
    stacked = cache.k.dim() == 5
    axes = cache_seq_axes(ctx, cache.k.shape[-3])
    if not axes or isinstance(cache, SeqShardedCache):
        return cache
    spec = (None, axes if len(axes) > 1 else axes[0])

    def place(t):
        if stacked:
            return torch.stack([to_members(t[r], spec, ctx.mesh)
                                for r in range(t.shape[0])])
        return to_members(t, spec, ctx.mesh)
    return SeqShardedCache(place(cache.k), place(cache.v), cache.length,
                           axes)


def sharded_decode_attention(ctx: ShardingCtx, q: torch.Tensor,
                             cache: SeqShardedCache, k_new: torch.Tensor,
                             v_new: torch.Tensor, *, logit_softcap: float):
    """One-token attention over a sequence-sharded ring cache
    (:func:`shard_cache`): the paper's part-reduce pattern applied to
    attention partials.  Each shard i of the n over ``cache.seq_axes``
    writes the new key and value into its slice iff it owns slot
    ``length % C``, and computes its f32 partials over its ``C / n``
    slots (masked logits, the local maximum, the exp-sum and the weighted
    values); ``pmax`` and ``reduce_from_model`` over those axes combine
    them.  As in the reference: no ``window`` mask, and the denominator
    floored at ``1e-30``.  q, k_new, v_new: (B, 1, H, D), q whole.
    Returns (out (B, 1, Hq, D), cache with length + 1)."""
    mesh, axes = ctx.mesh, cache.seq_axes
    local = bool(mesh.member_dims)
    n = coll.axis_size(mesh, axes)
    shards = range(n) if local else \
        [coll.group_index(mesh, axes, mesh.member)]
    Cs = cache.k.shape[-3]
    C = Cs * n
    D = cache.k.shape[-1]
    g = q.shape[2] // cache.k.shape[-2]
    length = cache.length
    slot = (length % C).reshape(1).long()
    qf = q[:, 0].float() * (D ** -0.5)                        # (B, Hq, D)
    logits, values = [], []
    for j, i in enumerate(shards):
        kc = cache.k[j] if local else cache.k
        vc = cache.v[j] if local else cache.v
        at = slot - i * Cs
        own = (at >= 0) & (at < Cs)
        at = torch.clamp(at, 0, Cs - 1)
        for c, new in ((kc, k_new), (vc, v_new)):
            c.index_copy_(1, at, torch.where(own, new.to(c.dtype),
                                             c.index_select(1, at)))
        kf, vf = kc.float(), vc.float()
        if g > 1:
            kf = kf.repeat_interleave(g, dim=2)
            vf = vf.repeat_interleave(g, dim=2)
        s = torch.einsum("bhd,bkhd->bhk", qf, kf)             # (B, Hq, Cs)
        if logit_softcap > 0:
            s = torch.tanh(s / logit_softcap) * logit_softcap
        gidx = i * Cs + torch.arange(Cs, device=q.device)
        valid = gidx[None, None, :] < torch.clamp(length + 1, max=C)
        logits.append(torch.where(valid, s, NEG_INF))
        values.append(vf)
    m = coll.pmax([s.amax(-1) for s in logits], mesh, axes)   # (B, Hq)
    ps = [torch.exp(s - m[..., None]) for s in logits]
    denom = coll.reduce_from_model([p.sum(-1) for p in ps], mesh, axes)
    o = coll.reduce_from_model(
        [torch.einsum("bhk,bkhd->bhd", p, vf) for p, vf in zip(ps, values)],
        mesh, axes)
    out = (o / torch.clamp(denom, min=1e-30)[..., None])[:, None]
    return out.to(q.dtype), dataclasses.replace(cache, length=length + 1)


def _heads(t: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S, n * D) -> (B, S, n, D)."""
    return t.reshape(*t.shape[:2], n, -1)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def _kv_of(m: int, hq: int, group: int):
    """The global kv heads that model member m's q heads ``[m * hq, (m +
    1) * hq)`` read (q head h reads kv head ``h // group``): a slice when
    they form whole groups or lie in one group, else the index of each q
    head's kv head (the kv heads repeated to the member's q heads)."""
    lo = m * hq
    if hq % group == 0:
        return slice(lo // group, (lo + hq) // group)
    if group % hq == 0:
        return slice(lo // group, lo // group + 1)
    return [(lo + j) // group for j in range(hq)]


def _attend(q, k, v, cfg: ModelConfig, *, window: int, cache,
            update_cache: bool, use_kernel: bool, kv=None):
    """Attention of q (B, S, Hq, D) over k, v, which ``cache`` (when
    given) takes; ``kv`` selects the kv heads q reads from k, v and the
    cache (None: all of them).  Returns (out (B, S, Hq, D), new cache or
    None)."""
    def sel(t):
        return t if kv is None else t[:, :, kv]
    B, S = q.shape[:2]
    new_cache = None
    if isinstance(cache, PagedKVState):
        if S != 1:
            raise ValueError("the paged KV cache is decode-only (S == 1)")
        return paged_decode_attention_block(
            cache, q, k, v, window=window,
            logit_softcap=cfg.attn_logit_softcap)
    if cache is not None and S == 1 and not update_cache:
        # append to the ring buffer at slot length % C (in place), attend
        # over its min(length + 1, C) resident entries
        C = cache.k.shape[1]
        slot = (cache.length % C).reshape(1).long()
        cache.k.index_copy_(1, slot, k.to(cache.k.dtype))
        cache.v.index_copy_(1, slot, v.to(cache.v.dtype))
        valid = torch.clamp(cache.length + 1, max=C).expand(B)
        out = decode_attention_ref(q, sel(cache.k), sel(cache.v), valid,
                                   window=window,
                                   logit_softcap=cfg.attn_logit_softcap)
        new_cache = dataclasses.replace(cache, length=cache.length + 1)
    elif use_kernel and cache is None:
        out = flash_attention.attention(q, sel(k).contiguous(),
                                        sel(v).contiguous(), True, window,
                                        cfg.attn_logit_softcap)
    else:
        out = chunked_attention(q, sel(k), sel(v), causal=True,
                                window=window,
                                logit_softcap=cfg.attn_logit_softcap)
        if update_cache:
            # write the last min(S, C) tokens into the ring buffer so that
            # position p lands in slot p % C (decode continues the ring)
            if cache is None:
                raise ValueError("prefill needs an allocated cache")
            C = cache.k.shape[1]
            if S >= C:
                cache.k.copy_(torch.roll(k[:, -C:], S % C, dims=1))
                cache.v.copy_(torch.roll(v[:, -C:], S % C, dims=1))
            else:
                cache.k[:, :S] = k.to(cache.k.dtype)
                cache.v[:, :S] = v.to(cache.v.dtype)
            new_cache = dataclasses.replace(
                cache, length=torch.full_like(cache.length, S))
    return out, new_cache


def attention_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                    ctx: ShardingCtx, positions: torch.Tensor, *,
                    window: int = 0, cache=None, update_cache: bool = False,
                    use_kernel: bool = False):
    """Pre-norm attention.  Returns (residual_out, new_cache_or_None).
    ``positions`` are (B, S), or (B, S, 3) M-RoPE positions when
    ``cfg.mrope``, on every route.  ``p`` in ``ctx``'s member layout.

    Train/prefill: full-sequence chunked attention (+ a fresh ring-buffer
    write when ``update_cache``, for any S, one token included).  With
    ``use_kernel`` and no cache (the training path) the attention is
    ``kernels.flash_attention.attention`` instead: the flash kernel forward
    (on CPU tensors its plain version) and ``attention_ref``'s gradient
    backward; the reference's models always run chunked attention, so the
    switch is the port's own, as for the CNN and the DNN.  Decode (S == 1):
    one token against the paged pool (the serving engine's path), against
    a sequence-sharded ring cache (:func:`sharded_decode_attention`) or
    against a whole one (``serve.decode``'s), the last through the plain
    ``decode_attention_ref``, as in the reference.

    Under a model axis each member projects its own q heads (and its kv
    heads, when they split) and attends them; its ``wo`` rows give a
    partial output, and the members' partials are summed (module
    docstring).  A whole ring cache is then written by each member on its
    own kv heads (all of them when they do not split)."""
    B, S, _ = x.shape
    sp = attn_specs(cfg)
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if isinstance(cache, SeqShardedCache) and S == 1 and not update_cache:
        q = _rotate(_heads(ctx.column(h, [p["wq"]], [sp["wq"]], _mm), Hq),
                    positions, cfg)
        # the kv heads' projections whole, as the prefill's (the same
        # product, so a cache's keys are the unsharded run's bits)
        k = _rotate(_heads(_mm(h, ctx.gather_leaf(p["wk"], sp["wk"])), Hkv),
                    positions, cfg)
        v = _heads(_mm(h, ctx.gather_leaf(p["wv"], sp["wv"])), Hkv)
        out, new_cache = sharded_decode_attention(
            ctx, q, cache, k, v, logit_softcap=cfg.attn_logit_softcap)
        y = ctx.row(out.reshape(B, S, cfg.q_dim), [p["wo"]], [sp["wo"]],
                    _mm)
        return x + y, new_cache
    M = ctx.model_ways
    kw = dict(window=window, update_cache=update_cache,
              use_kernel=use_kernel)
    if ctx.sharded(sp["wq"]) and isinstance(cache, PagedKVState):
        raise ValueError("the paged KV cache serves with no model axis, as "
                         "the reference's compile_serve does")
    if not ctx.sharded(sp["wq"]) or Hq % M:
        # q heads that do not split over the members (the rules split
        # ``wq``'s columns whenever q_dim divides, across a head boundary
        # where Hq does not): every member gathers the four projections
        # whole and repeats the unsharded block alike
        wq, wk, wv, wo = (ctx.gather_leaf(p[n], sp[n])
                          for n in ("wq", "wk", "wv", "wo"))
        q = _rotate(_heads(_mm(h, wq), Hq), positions, cfg)
        k = _rotate(_heads(_mm(h, wk), Hkv), positions, cfg)
        v = _heads(_mm(h, wv), Hkv)
        out, new_cache = _attend(q, k, v, cfg, cache=cache, **kw)
        return x + _mm(out.reshape(B, S, cfg.q_dim), wo), new_cache
    hq = Hq // M
    split_kv = Hkv % M == 0 and ctx.sharded(sp["wk"])
    hk = Hkv // M if split_kv else Hkv
    if split_kv:
        xs, names = [h], ("wq", "wo", "wk", "wv")
    else:
        # every member projects the kv heads whole, once per member alike
        k = _rotate(_heads(_mm(h, ctx.gather_leaf(p["wk"], sp["wk"])), Hkv),
                    positions, cfg)
        v = _heads(_mm(h, ctx.gather_leaf(p["wv"], sp["wv"])), Hkv)
        xs, names = [h, k, v], ("wq", "wo")

    def member(m, hm, *rest):
        if split_kv:
            wq, wo, wk, wv = rest
            k = _rotate(_heads(_mm(hm, wk), hk), positions, cfg)
            v = _heads(_mm(hm, wv), hk)
            kv, mc = None, cache
            if isinstance(cache, AttnCache):
                heads = slice(m * hk, (m + 1) * hk)
                mc = dataclasses.replace(cache, k=cache.k[:, :, heads],
                                         v=cache.v[:, :, heads])
        else:
            k, v, wq, wo = rest
            kv, mc = _kv_of(m, hq, Hq // Hkv), cache
        q = _rotate(_heads(_mm(hm, wq), hq), positions, cfg)
        out, nc = _attend(q, k, v, cfg, cache=mc, kv=kv, **kw)
        return _mm(out.reshape(B, S, hq * cfg.head_dim), wo), nc

    outs = ctx.members(member, xs, [p[n] for n in names],
                       [sp[n] for n in names])
    y = ctx.reduce([o for o, _ in outs])
    nc = outs[0][1]
    new_cache = None if nc is None else dataclasses.replace(
        cache, length=nc.length)
    return x + y, new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_specs(cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    emb = "embed_fsdp" if cfg.fsdp else "embed"
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {
            "w_gate": Spec((d, ff), (emb, "ff")),
            "w_up": Spec((d, ff), (emb, "ff")),
            "w_down": Spec((ff, d), ("ff", emb)),
            "norm": Spec((d,), ("embed",), init="zeros"),
        }
    return {
        "w_up": Spec((d, ff), (emb, "ff")),
        "w_down": Spec((ff, d), ("ff", emb)),
        "norm": Spec((d,), ("embed",), init="zeros"),
    }


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_kind == "swiglu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


def mlp_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
              ctx: ShardingCtx) -> torch.Tensor:
    """Pre-norm MLP; under a model axis each member on its ``ff`` columns
    (module docstring).  ``p`` in ``ctx``'s member layout."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    sp = mlp_specs(cfg)
    gated = cfg.mlp_kind in ("swiglu", "geglu")
    names = ("w_gate", "w_up", "w_down") if gated else ("w_up", "w_down")

    def member(m, h, *ws):
        if gated:
            wg, wu, wd = ws
            u = _act(cfg, h @ wg.to(h.dtype)) * (h @ wu.to(h.dtype))
        else:
            wu, wd = ws
            u = _act(cfg, h @ wu.to(h.dtype))
        return u @ wd.to(u.dtype)
    return x + ctx.summed(member, [h], [p[n] for n in names],
                          [sp[n] for n in names])
