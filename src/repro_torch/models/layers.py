"""Transformer layers of the port: norms, RoPE and M-RoPE, attention, MLP.

``repro.models.layers`` with the reference's numerics: f32 norms and RoPE
angles, bf16 activations, every matmul bf16 @ ``w.to(bf16)``.  Layout is
(B, S, H, D) throughout.  Not ported: the sequence-sharded decode
(``sharded_decode_attention``, which needs a mesh axis over the cache's
sequence that the port's meshes do not have).  The MoE layer is
``models.moe``; the SSM blocks are ``models.ssm``.

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
from repro_torch.core.params import Spec
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


def attention_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, *, window: int = 0,
                    cache=None, update_cache: bool = False,
                    use_kernel: bool = False):
    """Pre-norm attention.  Returns (residual_out, new_cache_or_None).
    ``positions`` are (B, S), or (B, S, 3) M-RoPE positions when
    ``cfg.mrope``, on every route.

    Train/prefill: full-sequence chunked attention (+ a fresh ring-buffer
    write when ``update_cache``, for any S, one token included).  With
    ``use_kernel`` and no cache (the training path) the attention is
    ``kernels.flash_attention.attention`` instead: the flash kernel forward
    (on CPU tensors its plain version) and ``attention_ref``'s gradient
    backward; the reference's models always run chunked attention, so the
    switch is the port's own, as for the CNN and the DNN.  Decode (S == 1):
    one token against the paged pool (the serving engine's path) or against
    the ring buffer (``serve.decode``'s), the latter through the plain
    ``decode_attention_ref``, as in the reference."""
    B, S, _ = x.shape
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q = (h @ p["wq"].to(h.dtype)).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = (h @ p["wk"].to(h.dtype)).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (h @ p["wv"].to(h.dtype)).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    q = _rotate(q, positions, cfg)
    k = _rotate(k, positions, cfg)

    new_cache = None
    if isinstance(cache, PagedKVState):
        if S != 1:
            raise ValueError("the paged KV cache is decode-only (S == 1)")
        out, new_cache = paged_decode_attention_block(
            cache, q, k, v, window=window,
            logit_softcap=cfg.attn_logit_softcap)
    elif cache is not None and S == 1 and not update_cache:
        # append to the ring buffer at slot length % C (in place), attend
        # over its min(length + 1, C) resident entries
        C = cache.k.shape[1]
        slot = (cache.length % C).reshape(1).long()
        cache.k.index_copy_(1, slot, k.to(cache.k.dtype))
        cache.v.index_copy_(1, slot, v.to(cache.v.dtype))
        valid = torch.clamp(cache.length + 1, max=C).expand(B)
        out = decode_attention_ref(q, cache.k, cache.v, valid, window=window,
                                   logit_softcap=cfg.attn_logit_softcap)
        new_cache = dataclasses.replace(cache, length=cache.length + 1)
    elif use_kernel and cache is None:
        out = flash_attention.attention(q, k, v, True, window,
                                        cfg.attn_logit_softcap)
    else:
        out = chunked_attention(q, k, v, causal=True, window=window,
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
    out = out.reshape(B, S, cfg.q_dim)
    y = out @ p["wo"].to(out.dtype)
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


def mlp_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        u = _act(cfg, h @ p["w_gate"].to(h.dtype)) * (h @ p["w_up"].to(h.dtype))
    else:
        u = _act(cfg, h @ p["w_up"].to(h.dtype))
    return x + u @ p["w_down"].to(u.dtype)
