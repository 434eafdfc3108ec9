"""Mixture-of-Experts layer of the port: top-k token-choice routing
(``repro.models.moe``).

Three routes, chosen by shape as in the reference:
  * train/prefill (S > 1): per-sample, capacity-bounded scatter dispatch
    (tokens over an expert's capacity are dropped);
  * decode (S == 1) with every expert computed, when ``B * k >= E`` and
    the weights are not FSDP-sharded: every expert's weights are read
    anyway, so all experts run on all tokens and the router's one-hot
    combines them;
  * sparse decode (S == 1 otherwise): each token gathers its k experts'
    weights.

The reference's numerics: the router in f32 on the normed activations, the
expert products in the activations' dtype on ``w.to(dtype)``.  Top-k ties
go to the lower expert index, as ``lax.top_k`` breaks them.

Under a model axis (``ctx``, ``core.sharding.ShardingCtx``), the
reference's three placements:
  * ``"experts"`` on the model axis (``Ep % M == 0``): each member runs its
    own experts' slice of the dispatch buffer, and the members' combined
    outputs are summed; the router ``(d, E)`` is column-sharded when ``E %
    M == 0``, its logits joined by ``gather_model`` before the top-k;
  * otherwise ``"moe_ff"`` on it: each member runs every expert on its
    ``moe_ff`` columns (``w_gate``/``w_up`` by column, ``w_down`` by row),
    and the members' partial outputs are summed;
  * :func:`moe_ep_block`, expert parallelism with explicit all-to-alls
    (``moe_expert_pad > 0``, a model axis, S > 1, ``(E + pad) % M == 0``,
    as the reference's ``moe_block`` picks it).
The shared experts shard ``"ff"`` as the MLP does.  ``moe_down_rs``
(``"moe_out"``) is a constraint on activations in the reference, which no
leaf carries: here a layout hint that changes nothing.  The router and
its aux loss run once on the replicated activations, so the aux loss
counts once, not M times.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as coll
from repro_torch.core.params import Spec
from repro_torch.core.sharding import ShardingCtx
from repro_torch.models.layers import rms_norm


def moe_specs(cfg: ModelConfig) -> dict:
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    Ep = E + cfg.moe_expert_pad    # padded for expert-parallel sharding
    emb = "embed_fsdp" if cfg.fsdp else "embed"
    sp = {
        "router": Spec((d, E), ("embed", "experts")),
        "w_gate": Spec((Ep, d, ff), ("experts", emb, "moe_ff")),
        "w_up": Spec((Ep, d, ff), ("experts", emb, "moe_ff")),
        "w_down": Spec((Ep, ff, d), ("experts", "moe_ff", emb)),
        "norm": Spec((d,), ("embed",), init="zeros"),
    }
    if cfg.num_shared_experts:
        sff = cfg.shared_expert_d_ff
        sp.update({
            "sh_gate": Spec((d, sff), (emb, "ff")),
            "sh_up": Spec((d, sff), (emb, "ff")),
            "sh_down": Spec((sff, d), ("ff", emb)),
        })
    return sp


def _top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest probabilities, ties to the lower index
    (``lax.top_k``'s rule): a stable descending sort."""
    return torch.sort(probs.detach(), dim=-1, descending=True,
                      stable=True).indices[..., :k]


def _route(logits: torch.Tensor, k: int):
    """The router's f32 ``logits`` (..., E) -> (weights (..., k) f32, idx
    (..., k), aux_loss): the softmax probabilities, the experts
    :func:`_top_k` picks, their weights renormalised, and the Switch-style
    load-balance loss ``E * sum_e f_e * p_e``."""
    probs = torch.softmax(logits, dim=-1)
    top_i = _top_k(probs, k)
    top_w = torch.gather(probs, -1, top_i)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    E = logits.shape[-1]
    onehot = F.one_hot(top_i, E).float().sum(-2)              # (..., E)
    f_e = onehot.reshape(-1, E).mean(0) / k
    p_e = probs.reshape(-1, E).mean(0)
    aux = E * torch.sum(f_e * p_e)
    return top_w, top_i, aux


def _router(h: torch.Tensor, w: torch.Tensor, k: int):
    """h: (..., d) -> :func:`_route` of the f32 logits ``h @ w``."""
    return _route(h.float() @ w.float(), k)


def _routed(p: dict, h: torch.Tensor, cfg: ModelConfig, ctx: ShardingCtx):
    """:func:`_router` on ``ctx``'s member layout: a column-sharded router
    gives each member its experts' logits, joined before the top-k."""
    spec, k = moe_specs(cfg)["router"], cfg.num_experts_per_tok
    if not ctx.sharded(spec):
        return _router(h, p["router"], k)
    logits = ctx.column(h.float(), [p["router"]], [spec],
                        lambda x, w: x @ w.float())
    return _route(logits, k)


def _expert_ffn(x: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """x: (..., E, C, d) through per-expert SwiGLU."""
    g = F.silu(torch.einsum("...ecd,edf->...ecf", x, wg.to(x.dtype)))
    u = torch.einsum("...ecd,edf->...ecf", x, wu.to(x.dtype))
    return torch.einsum("...ecf,efd->...ecd", g * u, wd.to(x.dtype))


def _expert_range(cfg: ModelConfig, ctx: ShardingCtx, m: int):
    """(lo, hi): the experts model member m holds, all of them when the
    experts do not shard (then ``"moe_ff"`` may)."""
    Ep = cfg.num_experts + cfg.moe_expert_pad
    if ctx.sharded(moe_specs(cfg)["w_gate"]) and ctx.held(
            moe_specs(cfg)["w_gate"])[:1] == ("model",):
        n = Ep // ctx.model_ways
        return m * n, (m + 1) * n
    return 0, Ep


def _shared(p: dict, h: torch.Tensor, cfg: ModelConfig, ctx: ShardingCtx):
    """The shared experts' SwiGLU, ``"ff"`` on the model axis as the
    MLP's."""
    sp = moe_specs(cfg)
    names = ("sh_gate", "sh_up", "sh_down")

    def member(m, h, wg, wu, wd):
        sg = F.silu(h @ wg.to(h.dtype))
        return (sg * (h @ wu.to(h.dtype))) @ wd.to(h.dtype)
    return ctx.summed(member, [h], [p[n] for n in names],
                      [sp[n] for n in names])


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
              ctx: ShardingCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm MoE MLP.  Returns (residual_out, aux_loss times
    ``router_aux_loss_coef``).  ``p`` in ``ctx``'s member layout (module
    docstring)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    Ep = E + cfg.moe_expert_pad
    mesh = ctx.mesh
    if (cfg.moe_expert_pad and mesh is not None
            and "model" in mesh.axis_names and S > 1
            and Ep % mesh.shape["model"] == 0):
        return moe_ep_block(p, x, cfg, ctx)
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    top_w, top_i, aux = _routed(p, h, cfg, ctx)               # (B, S, k)
    sp = moe_specs(cfg)
    names = ("w_gate", "w_up", "w_down")
    leaves, specs = [p[n] for n in names], [sp[n] for n in names]

    if S == 1:
        hv = h[:, 0]                                          # (B, d)
        tw = top_w[:, 0]                                      # (B, k)
        idx = top_i[:, 0]
        if B * k >= E and not cfg.fsdp:
            # every expert on every token, combined by the router one-hot
            def member(m, hv, tw, wg, wu, wd):
                lo, hi = _expert_range(cfg, ctx, m)
                g = F.silu(torch.einsum("bd,edf->bef", hv, wg.to(hv.dtype)))
                u = torch.einsum("bd,edf->bef", hv, wu.to(hv.dtype))
                ye = torch.einsum("bef,efd->bed", g * u, wd.to(hv.dtype))
                sel = F.one_hot(idx, Ep)[..., lo:hi].to(ye.dtype)
                return torch.einsum("bed,bke,bk->bd", ye, sel,
                                    tw.to(ye.dtype))[:, None]
        else:
            # each token's k experts, gathered in the weights' own dtype
            # and cast after the gather (not all E experts a step); a
            # member's experts only, the others' rows zero
            def member(m, hv, tw, wg, wu, wd):
                lo, hi = _expert_range(cfg, ctx, m)
                mine = (idx >= lo) & (idx < hi)
                j = torch.where(mine, idx - lo, 0)
                wg, wu, wd = (w[j].to(hv.dtype) for w in (wg, wu, wd))
                g = F.silu(torch.einsum("bd,bkdf->bkf", hv, wg))
                u = torch.einsum("bd,bkdf->bkf", hv, wu)
                ye = torch.einsum("bkf,bkfd->bkd", g * u, wd)
                if hi - lo < Ep:
                    ye = ye * mine[..., None].to(ye.dtype)
                return torch.einsum("bkd,bk->bd", ye,
                                    tw.to(ye.dtype))[:, None]
        y = ctx.summed(member, [hv, tw], leaves, specs)
    else:
        # per-sample capacity-bounded scatter: a token's slot in expert e is
        # the count of earlier (token, choice) pairs of its sample routed
        # to e; slots >= C are dropped (their rows zeroed, so the only
        # colliding writes add zeros, and the accumulate is exact)
        C = max(1, int(S * k / E * cfg.moe_capacity_factor))
        flat_i = top_i.reshape(B, S * k)
        oh = F.one_hot(flat_i, Ep)                            # (B, S*k, Ep)
        pos = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(-1)   # (B, S*k)
        keep = pos < C
        pos_c = torch.clamp(pos, max=C - 1)
        xs = h.repeat_interleave(k, dim=1) * keep[..., None].to(h.dtype)
        b_idx = torch.arange(B, device=x.device)[:, None].expand(B, S * k)
        xe = torch.zeros((B, Ep, C, d), dtype=h.dtype, device=x.device)
        xe = xe.index_put((b_idx, flat_i, pos_c), xs, accumulate=True)
        tw = top_w.reshape(B, S * k)

        def member(m, xe, tw, wg, wu, wd):
            lo, hi = _expert_range(cfg, ctx, m)
            ye = _expert_ffn(xe[:, lo:hi], wg, wu, wd)
            if hi - lo == Ep:
                gathered = ye[b_idx, flat_i, pos_c]           # (B, S*k, d)
                w = keep[..., None] * tw[..., None]
                return (gathered * w.to(ye.dtype)).reshape(
                    B, S, k, d).sum(2)
            # this member's experts' assignments, the others' zero
            mine = (flat_i >= lo) & (flat_i < hi)
            gathered = ye[b_idx, torch.where(mine, flat_i - lo, 0), pos_c]
            w = (keep & mine)[..., None] * tw[..., None]
            return (gathered * w.to(ye.dtype)).float().reshape(
                B, S, k, d).sum(2)
        y = ctx.summed(member, [xe, tw], leaves, specs).to(h.dtype)

    if cfg.num_shared_experts:
        y = y + _shared(p, h, cfg, ctx)
    return x + y, aux * cfg.router_aux_loss_coef


def moe_ep_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 ctx: ShardingCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE with explicit all-to-alls (the reference's
    ``moe_ep_block``): experts on the model axis (``(E + pad) % M ==
    0``), tokens replicated over it.  Each model member routes the whole
    batch, takes its ``T / M`` slice of the ``T = B * S * k``
    assignments, scatters them into per-destination buffers of capacity
    ``C = max(1, int(T / M / M * cf))``, ``all_to_all_model``s the tokens
    and their local expert ids to the members that own the experts, runs
    its own experts on a capacity ``Ce = max(1, int(M * C / E_loc * cf))``
    buffer, sends the results back the same way, folds the k assignments
    into token space, and the members' outputs are summed.  Returns
    (residual_out, aux_loss times ``router_aux_loss_coef``)."""
    mesh = ctx.mesh
    B, S, d = x.shape
    k = cfg.num_experts_per_tok
    Ep = cfg.num_experts + cfg.moe_expert_pad
    n = mesh.shape["model"]
    E_loc = Ep // n
    cf = cfg.moe_capacity_factor
    T = B * S * k
    Ts = T // n
    C = max(1, int(Ts / n * cf))
    Ce = max(1, int(n * C / E_loc * cf))
    dev = x.device

    h = rms_norm(x, p["norm"], cfg.norm_eps)
    top_w, top_i, aux = _routed(p, h, cfg, ctx)
    flat_i = top_i.reshape(T)

    def slot_of(ids, groups):
        """Each entry's slot among the earlier entries of its group."""
        oh = F.one_hot(ids, groups)
        return ((torch.cumsum(oh, 0) - oh) * oh).sum(-1)

    plans = {}

    def dispatch(m, h, tw):
        sl = slice(m * Ts, (m + 1) * Ts)
        my_i = flat_i[sl]
        toks = h.reshape(B * S, d).repeat_interleave(k, dim=0)[sl]
        dest, e_loc = my_i // E_loc, my_i % E_loc
        pos = slot_of(dest, n)
        keep = pos < C
        pos_c = torch.clamp(pos, max=C - 1)
        buf = torch.zeros((n, C, d), dtype=h.dtype, device=dev).index_put(
            (dest, pos_c), toks * keep[:, None].to(h.dtype), accumulate=True)
        meta = torch.full((n * C,), -1, dtype=torch.long, device=dev)
        meta = meta.scatter_reduce(0, dest * C + pos_c,
                                   torch.where(keep, e_loc, -1), "amax")
        plans[m] = (dest, pos_c, keep, tw.reshape(T)[sl])
        return buf, meta.reshape(n, C)

    names = ("w_gate", "w_up", "w_down")
    sp = moe_specs(cfg)
    held = ctx.model_members()
    outs = ctx.members(dispatch, [h, top_w])
    # ---- dispatch: tokens travel to their expert's member ----
    recv = coll.all_to_all_model([b for b, _ in outs], mesh)
    recv_e = coll.all_to_all_model([e for _, e in outs], mesh)
    blocks = ctx.members(lambda m, *ws: ws, [],
                         [p[nm] for nm in names], [sp[nm] for nm in names])
    back_in = []
    for rt, re, (wg, wu, wd) in zip(recv, recv_e, blocks):
        rt = rt.reshape(n * C, d)
        re = re.reshape(n * C)
        valid = re >= 0
        re_c = torch.clamp(re, min=0)
        pe = slot_of(re_c, E_loc)
        keep_e = (pe < Ce) & valid
        pe_c = torch.clamp(pe, max=Ce - 1)
        xe = torch.zeros((E_loc, Ce, d), dtype=rt.dtype, device=dev)
        xe = xe.index_put((re_c, pe_c), rt * keep_e[:, None].to(rt.dtype),
                          accumulate=True)
        ye = _expert_ffn(xe, wg, wu, wd)                      # fully local
        out_t = ye[re_c, pe_c] * keep_e[:, None].to(ye.dtype)
        back_in.append(out_t.reshape(n, C, d))
    # ---- return: results travel back to the token's home member ----
    back = coll.all_to_all_model(back_in, mesh)
    ys = []
    for m, bk in zip(held, back):
        dest, pos_c, keep, my_w = plans[m]
        y_slice = bk[dest, pos_c] * (keep[:, None]
                                     * my_w[:, None]).to(bk.dtype)
        # fold the k assignments into token space first (linear), then one
        # (B*S, d) sum over the members
        tok = (m * Ts + torch.arange(Ts, device=dev)) // k
        ys.append(torch.zeros((B * S, d), dtype=y_slice.dtype, device=dev)
                  .index_add(0, tok, y_slice))
    y = ctx.reduce(ys).reshape(B, S, d)
    if cfg.num_shared_experts:
        y = y + _shared(p, h, cfg, ctx)
    return x + y, aux * cfg.router_aux_loss_coef

