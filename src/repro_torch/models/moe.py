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

``moe_ep_block`` (expert parallelism: experts sharded over a ``"model"``
mesh axis, tokens moved by all-to-all) is not ported: the port's meshes
have no ``"model"`` axis, so the reference's ``moe_block`` would not reach
it on them either.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.params import Spec
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


def _router(h: torch.Tensor, w: torch.Tensor, k: int):
    """h: (..., d) -> (weights (..., k) f32, idx (..., k), aux_loss): the
    router's f32 probabilities, the experts :func:`_top_k` picks, their
    weights renormalised, and the Switch-style load-balance loss
    ``E * sum_e f_e * p_e``."""
    logits = h.float() @ w.float()
    probs = torch.softmax(logits, dim=-1)
    top_i = _top_k(probs, k)
    top_w = torch.gather(probs, -1, top_i)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    E = w.shape[-1]
    onehot = F.one_hot(top_i, E).float().sum(-2)              # (..., E)
    f_e = onehot.reshape(-1, E).mean(0) / k
    p_e = probs.reshape(-1, E).mean(0)
    aux = E * torch.sum(f_e * p_e)
    return top_w, top_i, aux


def _expert_ffn(x: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """x: (..., E, C, d) through per-expert SwiGLU."""
    g = F.silu(torch.einsum("...ecd,edf->...ecf", x, wg.to(x.dtype)))
    u = torch.einsum("...ecd,edf->...ecf", x, wu.to(x.dtype))
    return torch.einsum("...ecf,efd->...ecd", g * u, wd.to(x.dtype))


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm MoE MLP.  Returns (residual_out, aux_loss times
    ``router_aux_loss_coef``)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    top_w, top_i, aux = _router(h, p["router"], k)            # (B, S, k)

    if S == 1:
        hv = h[:, 0]                                          # (B, d)
        if B * k >= E and not cfg.fsdp:
            # every expert on every token, combined by the router one-hot
            g = F.silu(torch.einsum("bd,edf->bef", hv,
                                    p["w_gate"].to(hv.dtype)))
            u = torch.einsum("bd,edf->bef", hv, p["w_up"].to(hv.dtype))
            ye = torch.einsum("bef,efd->bed", g * u,
                              p["w_down"].to(hv.dtype))
            sel = F.one_hot(top_i[:, 0], ye.shape[1]).to(ye.dtype)
            y = torch.einsum("bed,bke,bk->bd", ye, sel,
                             top_w[:, 0].to(ye.dtype))[:, None]
        else:
            # each token's k experts, gathered in the weights' own dtype
            # and cast after the gather (not all E experts a step)
            idx = top_i[:, 0]                                 # (B, k)
            wg = p["w_gate"][idx].to(hv.dtype)                # (B, k, d, ff)
            wu = p["w_up"][idx].to(hv.dtype)
            wd = p["w_down"][idx].to(hv.dtype)
            g = F.silu(torch.einsum("bd,bkdf->bkf", hv, wg))
            u = torch.einsum("bd,bkdf->bkf", hv, wu)
            ye = torch.einsum("bkf,bkfd->bkd", g * u, wd)
            y = torch.einsum("bkd,bk->bd", ye,
                             top_w[:, 0].to(ye.dtype))[:, None]
    else:
        # per-sample capacity-bounded scatter: a token's slot in expert e is
        # the count of earlier (token, choice) pairs of its sample routed
        # to e; slots >= C are dropped (their rows zeroed, so the only
        # colliding writes add zeros, and the accumulate is exact)
        Ep = E + cfg.moe_expert_pad
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
        ye = _expert_ffn(xe, p["w_gate"], p["w_up"], p["w_down"])
        gathered = ye[b_idx, flat_i, pos_c]                   # (B, S*k, d)
        gathered = gathered * (keep[..., None]
                               * top_w.reshape(B, S * k)[..., None]
                               ).to(ye.dtype)
        y = gathered.reshape(B, S, k, d).sum(2)

    if cfg.num_shared_experts:
        sg = F.silu(h @ p["sh_gate"].to(h.dtype))
        su = h @ p["sh_up"].to(h.dtype)
        y = y + (sg * su) @ p["sh_down"].to(h.dtype)
    return x + y, aux * cfg.router_aux_loss_coef
