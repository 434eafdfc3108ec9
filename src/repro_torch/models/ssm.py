"""State-space and recurrent blocks of the port (``repro.models.ssm``):
Mamba2 (SSD), and xLSTM's mLSTM and sLSTM.

Training and prefill use the reference's chunk-parallel forms (quadratic
within a chunk, a linear scan across chunks); decode uses the recurrences on
carried states.  The reference's ``lax.scan``s are Python loops here: over
chunks (SSD, mLSTM) and over the S steps of the sequence (sLSTM, which has
no chunked form).  None of these scans has a Pallas kernel in the reference,
so none has a hand-written kernel here: they are plain PyTorch, as the
reference's are plain JAX.

Numerics are the reference's: the block inputs are bf16, the scans run in
f32, and PyTorch promotes bf16 x f32 tensors to f32 as JAX does (the causal
conv's ``xp * w[i]``, the decode branch's conv cache).  The SSD and mLSTM
intra-chunk masks are applied to the exponent, before ``exp``, so that the
masked entries' gradients are zero and not NaN.

Caches are frozen dataclasses of tensors with the reference's fields; a
block returns a new cache object (the states are not written in place, as
the attention caches' key and value buffers are).

Under a model axis (``ctx``, ``core.sharding.ShardingCtx``) the fused
projections' contiguous column blocks do not line up with the blocks' own
segments (Mamba's ``in_proj`` is ``[z | x | B | C | dt]`` over
``"ssm_inner"``, mLSTM's ``up_proj`` ``[x | z]``), so such leaves are
gathered whole (``ShardingCtx.gather_leaf``) and every member repeats the
computation that reads them.  Computed on the members' own blocks:

* ``mamba``: ``out_proj`` by row (each member's ``din`` slice of the
  gated output); gathered: ``in_proj``, ``conv_w``, ``conv_b``,
  ``A_log``, ``D``, ``dt_bias``, ``gate_norm``;
* ``mlstm``: ``wq``, ``wk``, ``wv``, ``w_if`` and ``down_proj`` by row;
  gathered: ``up_proj``, ``b_if``, ``out_norm``;
* ``slstm``: ``W`` and ``b`` by column, ``R`` on each member's heads at
  every step of the scan (the members' recurrent terms joined); whole:
  ``out_proj`` (``("embed", "embed")``, never sharded).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.params import Spec
from repro_torch.core.sharding import ShardingCtx
from repro_torch.models.layers import rms_norm

NEG = -1e30


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def _whole(p: dict, specs: dict, ctx: ShardingCtx, keep=()) -> dict:
    """``p`` with every model-sharded leaf but those named in ``keep``
    gathered whole (module docstring)."""
    return {k: w if k in keep else ctx.gather_leaf(w, specs[k])
            for k, w in p.items()}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) without a threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================
def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    din = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads or max(1, din // 64)
    P = din // H
    return din, H, P


def mamba_specs(cfg: ModelConfig) -> dict:
    d, N = cfg.d_model, cfg.ssm_state
    din, H, P = mamba_dims(cfg)
    cw = cfg.ssm_conv_width
    emb = "embed_fsdp" if cfg.fsdp else "embed"
    return {
        # order: [z(din), x(din), B(N), C(N), dt(H)]
        "in_proj": Spec((d, 2 * din + 2 * N + H), (emb, "ssm_inner")),
        "conv_w": Spec((cw, din + 2 * N), ("kernel", "ssm_inner"),
                       init="normal", scale=0.5),
        "conv_b": Spec((din + 2 * N,), ("ssm_inner",), init="zeros"),
        "A_log": Spec((H,), ("ssm_heads",), init="ones"),
        "D": Spec((H,), ("ssm_heads",), init="ones"),
        "dt_bias": Spec((H,), ("ssm_heads",), init="zeros"),
        "gate_norm": Spec((din,), ("ssm_inner",), init="zeros"),
        "out_proj": Spec((din, d), ("ssm_inner", emb)),
        "norm": Spec((d,), ("embed",), init="zeros"),
    }


@dataclasses.dataclass(frozen=True)
class MambaCache:
    state: torch.Tensor       # (B, H, P, N)
    conv: torch.Tensor        # (B, cw-1, din+2N) trailing inputs
    length: torch.Tensor      # () int32


def mamba_cache_axes() -> MambaCache:
    """The logical axes of each field of a :class:`MambaCache`
    (``repro.models.ssm.mamba_cache_axes``)."""
    return MambaCache(("batch", "ssm_heads", None, "ssm_state"),
                      ("batch", None, "ssm_inner"), ())


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> MambaCache:
    din, H, P = mamba_dims(cfg)
    N, cw = cfg.ssm_state, cfg.ssm_conv_width
    return MambaCache(
        torch.zeros((batch, H, P, N), dtype=dtype, device=device),
        torch.zeros((batch, cw - 1, din + 2 * N), dtype=dtype, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over seq.  xbc: (B, S, C); w: (cw, C).  The
    products promote to ``w``'s type (bf16 inputs, f32 weights: f32)."""
    cw, S = w.shape[0], xbc.shape[1]
    if prev is None:
        pad = torch.zeros((xbc.shape[0], cw - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = prev.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + S] * w[i]
    return F.silu(out + b)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 256,
                init_state: Optional[torch.Tensor] = None):
    """Chunk-parallel SSD (Mamba2, Dao & Gu 2024 minimal form).

    x: (B, S, H, P); dt: (B, S, H) (post-softplus); A: (H,) negative;
    Bm, Cm: (B, S, N) shared across heads.  Returns (y (B, S, H, P),
    final_state (B, H, P, N)).  The reference's arithmetic with heads
    leading inside a chunk, so that each product is one batched matmul:
    within chunk c, y_diag[l] = sum_{m <= l} (C_l . B_m) exp(cs_l - cs_m)
    (dt_m x_m), the states carried across chunks by a loop.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    nc = S // chunk
    xc = x.reshape(Bsz, nc, chunk, H, P).permute(0, 1, 3, 2, 4)   # b,c,h,l,p
    dtc = dt.reshape(Bsz, nc, chunk, H).permute(0, 1, 3, 2)       # b,c,h,l
    Bc = Bm.reshape(Bsz, nc, chunk, N)
    Cc = Cm.reshape(Bsz, nc, chunk, N)

    cs = torch.cumsum(dtc * A[None, None, :, None], dim=-1)       # inclusive
    # intra-chunk decay T[l, m] = exp(cs_l - cs_m) for l >= m.  Mask the
    # EXPONENT, not the result: for m > l the difference is positive and
    # exp() overflows, and a mask after exp() still sends NaN backward.
    idx = torch.arange(chunk, device=x.device)
    tri = idx[:, None] >= idx[None, :]
    diff = torch.where(tri, cs[..., :, None] - cs[..., None, :], NEG)
    scores = torch.einsum("bcln,bcmn->bclm", Cc, Bc)              # b,c,l,m
    w_lm = scores[:, :, None] * torch.exp(diff)                   # b,c,h,l,m
    xdt = xc * dtc[..., None]                                     # dt_m x_m
    y_diag = w_lm @ xdt                                           # b,c,h,l,p
    # chunk-final states: sum_m exp(cs_last - cs_m) dt_m B_m (x)_m
    decay_to_end = torch.exp(cs[..., -1:] - cs)                   # b,c,h,l
    states = torch.einsum("bchlp,bcln->bchpn", xdt * decay_to_end[..., None],
                          Bc)
    chunk_decay = torch.exp(cs[..., -1])                          # b,c,h

    prev = (init_state if init_state is not None
            else torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device))
    prevs = []
    for c in range(nc):
        prevs.append(prev)
        prev = prev * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prevs, dim=1)                       # b,c,h,p,n
    # inter-chunk contribution: C_l . prev_state decayed to l
    y_off = torch.einsum("bcln,bchpn->bchlp", Cc, prev_states) \
        * torch.exp(cs)[..., None]
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, P)
    return y, prev


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                ctx: ShardingCtx, cache: Optional[MambaCache] = None):
    """Pre-norm Mamba2 block.  Returns (residual_out, new_cache_or_None).
    With a cache and S == 1 it takes one recurrent step; with a cache and
    S > 1 (prefill) it runs the chunked form and fills the cache.  ``p``
    in ``ctx``'s member layout (module docstring)."""
    sp = mamba_specs(cfg)
    out_proj = p["out_proj"]
    p = _whole(p, sp, ctx, keep=("out_proj",))
    Bsz, S, _ = x.shape
    din, H, P = mamba_dims(cfg)
    N = cfg.ssm_state
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    proj = h @ p["in_proj"].to(h.dtype)
    z, xs, Bm, Cm, dt = torch.split(proj, [din, din, N, N, H], dim=-1)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)

    new_cache = None
    A = -torch.exp(p["A_log"].float())
    dt = _softplus(dt.float() + p["dt_bias"].float())
    if cache is not None and S == 1:
        xbc_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], cache.conv)
        conv_new = torch.cat([cache.conv[:, 1:], xbc], dim=1)
        xs_c, Bc, Cc = torch.split(xbc_conv, [din, N, N], dim=-1)
        xh = xs_c.reshape(Bsz, 1, H, P)[:, 0]                     # (b,h,p)
        dA = torch.exp(dt[:, 0] * A[None, :])                     # (b,h)
        st = cache.state * dA[:, :, None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, 0], xh, Bc[:, 0])
        y = torch.einsum("bhpn,bn->bhp", st, Cc[:, 0])
        y = y + p["D"].to(y.dtype)[None, :, None] * xh
        y = y.reshape(Bsz, 1, din)
        new_cache = MambaCache(st, conv_new, cache.length + 1)
    else:
        xbc_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"])
        xs_c, Bc, Cc = torch.split(xbc_conv, [din, N, N], dim=-1)
        xh = xs_c.reshape(Bsz, S, H, P)
        y, final = ssd_chunked(xh.float(), dt, A, Bc.float(), Cc.float())
        y = y + p["D"].to(y.dtype)[None, None, :, None] * xh.to(y.dtype)
        y = y.reshape(Bsz, S, din).to(x.dtype)
        if cache is not None:
            cw = cfg.ssm_conv_width
            conv_new = xbc[:, -(cw - 1):].float()
            new_cache = MambaCache(final, conv_new,
                                   torch.full_like(cache.length, S))
    # gated output norm (Mamba2): y * silu(z), RMS-normed
    y = rms_norm(y.to(x.dtype) * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = ctx.row(y, [out_proj], [sp["out_proj"]], _mm)
    return x + out, new_cache


# ===========================================================================
# xLSTM: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar, a scan)
# ===========================================================================
def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    din = cfg.ssm_expand * cfg.d_model
    H = cfg.num_heads
    P = din // H
    return din, H, P


def mlstm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    din, H, P = mlstm_dims(cfg)
    emb = "embed_fsdp" if cfg.fsdp else "embed"
    return {
        "up_proj": Spec((d, 2 * din), (emb, "ssm_inner")),
        "wq": Spec((din, din), ("ssm_inner", None)),
        "wk": Spec((din, din), ("ssm_inner", None)),
        "wv": Spec((din, din), ("ssm_inner", None)),
        "w_if": Spec((din, 2 * H), ("ssm_inner", "ssm_heads")),
        "b_if": Spec((2 * H,), ("ssm_heads",), init="zeros"),
        "out_norm": Spec((din,), ("ssm_inner",), init="zeros"),
        "down_proj": Spec((din, d), ("ssm_inner", emb)),
        "norm": Spec((d,), ("embed",), init="zeros"),
    }


@dataclasses.dataclass(frozen=True)
class MlstmCache:
    C: torch.Tensor           # (B, H, P, P) matrix memory
    n: torch.Tensor           # (B, H, P) normalizer
    m: torch.Tensor           # (B, H) max-stabilizer (log domain)
    length: torch.Tensor


def mlstm_cache_axes() -> MlstmCache:
    """The logical axes of each field of an :class:`MlstmCache`
    (``repro.models.ssm.mlstm_cache_axes``)."""
    return MlstmCache(("batch", "ssm_heads", None, None),
                      ("batch", "ssm_heads", None),
                      ("batch", "ssm_heads"), ())


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> MlstmCache:
    _, H, P = mlstm_dims(cfg)
    return MlstmCache(
        torch.zeros((batch, H, P, P), dtype=dtype, device=device),
        torch.zeros((batch, H, P), dtype=dtype, device=device),
        torch.full((batch, H), NEG, dtype=dtype, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


def _mlstm_chunk_scan(q, k, v, log_f, log_i, chunk: int,
                      cache: Optional[MlstmCache]):
    """Stabilized chunk-parallel mLSTM.

    q, k, v: (B, S, H, P); log_f, log_i: (B, S, H).  Returns (y, (C, n, m)
    at the end).  Recurrence: C_t = f_t C_{t-1} + i_t k_t v_t^T; n_t = f_t
    n_{t-1} + i_t k_t; y_t = (C_t^T q_t) / max(|n_t . q_t|, exp(-m_t)).
    """
    B, S, H, P = q.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    dev = q.device
    if cache is None:
        Cp = torch.zeros((B, H, P, P), dtype=torch.float32, device=dev)
        np_ = torch.zeros((B, H, P), dtype=torch.float32, device=dev)
        mp = torch.full((B, H), NEG, dtype=torch.float32, device=dev)
    else:
        Cp, np_, mp = cache.C.float(), cache.n.float(), cache.m.float()
    idx = torch.arange(chunk, device=dev)
    tri = (idx[:, None] >= idx[None, :])[None, :, :, None]
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        qb, kb, vb = q[:, sl] / (P ** 0.5), k[:, sl], v[:, sl]
        fb, ib = log_f[:, sl], log_i[:, sl]
        Fc = torch.cumsum(fb, dim=1)                      # (B,l,H) inclusive
        # intra-chunk log weights D[l,m] = F_l - F_m + i_m  (m <= l)
        Dlm = torch.where(tri, Fc[:, :, None, :] - Fc[:, None, :, :]
                          + ib[:, None, :, :], NEG)
        # inter-chunk log weight for query l: F_l + m_prev
        Dcarry = Fc + mp[:, None, :]                      # (B,l,H)
        M = torch.maximum(Dlm.amax(dim=2), Dcarry)        # per-query max
        w_in = torch.exp(Dlm - M[:, :, None, :])          # (B,l,m,H)
        w_car = torch.exp(Dcarry - M)                     # (B,l,H)
        scores = torch.einsum("blhp,bmhp->blmh", qb, kb)
        y_num = torch.einsum("blmh,bmhp->blhp", scores * w_in, vb) \
            + torch.einsum("blhp,bhpq->blhq", qb, Cp) * w_car[..., None]
        # normalizer n_l = sum_m w_in[l,m] k_m + w_car[l] n_prev
        n_vec = torch.einsum("blmh,bmhp->blhp", w_in, kb) \
            + w_car[..., None] * np_[:, None]
        denom = torch.abs(torch.einsum("blhp,blhp->blh", n_vec, qb))
        ys.append(y_num / torch.maximum(denom, torch.exp(-M))[..., None])
        # ---- carry update to the end of the chunk ----
        F_last = Fc[:, -1]                                # (B,H)
        m_new = torch.maximum(F_last + mp,
                              (F_last[:, None] - Fc + ib).amax(dim=1))
        w_state = torch.exp(F_last[:, None] - Fc + ib - m_new[:, None])
        carry = torch.exp(F_last + mp - m_new)
        Cp = carry[:, :, None, None] * Cp + torch.einsum(
            "blhp,blhq->bhpq", w_state[..., None] * kb, vb)
        np_ = carry[..., None] * np_ + torch.einsum("blh,blhp->bhp",
                                                    w_state, kb)
        mp = m_new
    return torch.cat(ys, dim=1), (Cp, np_, mp)


def mlstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                ctx: ShardingCtx, cache: Optional[MlstmCache] = None,
                chunk: int = 256):
    """Pre-norm mLSTM block, ``p`` in ``ctx``'s member layout (module
    docstring).  Returns (residual_out, new_cache_or_None)."""
    sp = mlstm_specs(cfg)
    rows = ("wq", "wk", "wv", "w_if", "down_proj")
    p = _whole(p, sp, ctx, keep=rows)

    def row(x, name):
        return ctx.row(x, [p[name]], [sp[name]], _mm)
    Bsz, S, _ = x.shape
    din, H, P = mlstm_dims(cfg)
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    u, z = torch.chunk(h @ p["up_proj"].to(h.dtype), 2, dim=-1)
    q = row(u, "wq").reshape(Bsz, S, H, P).float()
    k = row(u, "wk").reshape(Bsz, S, H, P).float()
    v = row(u, "wv").reshape(Bsz, S, H, P).float()
    gates = row(u, "w_if") + p["b_if"].to(u.dtype)
    gates = gates.reshape(Bsz, S, 2, H)
    log_i = gates[:, :, 0].float()
    log_f = F.logsigmoid(gates[:, :, 1].float())

    y, (Cf, nf, mf) = _mlstm_chunk_scan(q, k, v, log_f, log_i, chunk, cache)
    new_cache = None
    if cache is not None:
        new_cache = MlstmCache(Cf, nf, mf, cache.length + S)
    y = y.reshape(Bsz, S, din).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
    return x + row(y, "down_proj"), new_cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    H = cfg.num_heads
    P = d // H
    emb = "embed_fsdp" if cfg.fsdp else "embed"
    return {
        "W": Spec((d, 4 * d), (emb, "ssm_inner")),
        "R": Spec((H, P, 4 * P), ("ssm_heads", None, None), init="normal",
                  scale=0.02),
        "b": Spec((4 * d,), ("ssm_inner",), init="zeros"),
        "out_norm": Spec((d,), ("embed",), init="zeros"),
        "out_proj": Spec((d, d), (emb, emb)),
        "norm": Spec((d,), ("embed",), init="zeros"),
    }


@dataclasses.dataclass(frozen=True)
class SlstmCache:
    h: torch.Tensor   # (B, d)
    c: torch.Tensor   # (B, d)
    n: torch.Tensor   # (B, d)
    m: torch.Tensor   # (B, d)
    length: torch.Tensor


def slstm_cache_axes() -> SlstmCache:
    """The logical axes of each field of an :class:`SlstmCache`
    (``repro.models.ssm.slstm_cache_axes``)."""
    a = ("batch", "embed")
    return SlstmCache(a, a, a, a, ())


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> SlstmCache:
    d = cfg.d_model

    def zeros():
        return torch.zeros((batch, d), dtype=dtype, device=device)
    return SlstmCache(zeros(), zeros(), zeros(),
                      torch.full((batch, d), NEG, dtype=dtype, device=device),
                      torch.zeros((), dtype=torch.int32, device=device))


def _slstm_step(p, H, P, carry, wx, rec_fn=None):
    """One sLSTM step; wx: (B, 4d) = W x + b precomputed; carry (h,c,n,m).
    ``rec_fn(h (B, H, P)) -> (B, 4d)`` replaces the recurrent product
    with ``p["R"]`` (the model-axis form, :func:`slstm_block`)."""
    h, c, n, m = carry
    B = h.shape[0]
    if rec_fn is None:
        rec = torch.einsum("bhp,hpq->bhq", h.reshape(B, H, P),
                           p["R"]).reshape(B, 4 * H * P)
    else:
        rec = rec_fn(h.reshape(B, H, P))
    z_pre, i_pre, f_pre, o_pre = torch.chunk(wx + rec, 4, dim=-1)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    i = torch.exp(i_pre - m_new)
    f = torch.exp(log_f + m - m_new)
    c_new = f * c + i * z
    n_new = f * n + i
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return (h_new, c_new, n_new, m_new)


def slstm_scan(p, H: int, P: int, carry, wx: torch.Tensor, rec_fn=None):
    """The sLSTM recurrence over the S steps of ``wx`` (B, S, 4d): one
    :func:`_slstm_step` a token, as the reference's ``lax.scan``.  Returns
    (h of every step (B, S, d), the last carry)."""
    hs = []
    for t in range(wx.shape[1]):
        carry = _slstm_step(p, H, P, carry, wx[:, t], rec_fn)
        hs.append(carry[0])
    return torch.stack(hs, dim=1), carry


def slstm_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                ctx: ShardingCtx, cache: Optional[SlstmCache] = None):
    """Pre-norm sLSTM block, ``p`` in ``ctx``'s member layout (module
    docstring).  Returns (residual_out, new_cache_or_None)."""
    sp = slstm_specs(cfg)
    Bsz, S, d = x.shape
    H = cfg.num_heads
    P = d // H
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    W = ctx.column(h, [p["W"], p["b"]], [sp["W"], sp["b"]],
                   lambda h, w, b: h @ w.to(h.dtype) + b.to(h.dtype))
    wx = W.float()
    rec_fn = None
    if ctx.sharded(sp["R"]):
        hm = H // ctx.model_ways

        def rec_fn(hh):
            def member(m, hh, r):
                return torch.einsum("bhp,hpq->bhq", hh[:, m * hm:(m + 1) * hm],
                                    r).reshape(Bsz, -1)
            return ctx.gather(ctx.members(member, [hh], [p["R"]], [sp["R"]]))
    if cache is None:
        z = torch.zeros((Bsz, d), dtype=torch.float32, device=x.device)
        carry = (z, z, z, torch.full((Bsz, d), NEG, dtype=torch.float32,
                                     device=x.device))
    else:
        carry = (cache.h.float(), cache.c.float(), cache.n.float(),
                 cache.m.float())
    ys, (hf, cf, nf, mf) = slstm_scan(p, H, P, carry, wx, rec_fn)
    y = ys.to(x.dtype)                                    # (B,S,d)
    new_cache = None
    if cache is not None:
        new_cache = SlstmCache(hf, cf, nf, mf, cache.length + S)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(y.dtype)
    return x + out, new_cache
