"""Paged-decode attention: the Hopper kernel and its plain PyTorch version.

One decode token per request attends over that request's KV history,
scattered across fixed-size pages of a physical pool (``pages_k`` /
``pages_v``: (P, ps, Hkv, D)) and addressed through ``page_table`` (B, n).
Port of ``repro.kernels.paged_attn.paged_decode_attention``; the CUDA
source, ``csrc/paged_attn.cu``, states its design and its bound.

:func:`paged_decode_attention` is the wrapper: on CPU tensors it computes
the plain version (that is how the CPU tests run it); on CUDA tensors it
launches the kernel or raises — it never falls back.
:func:`paged_decode_attention_plain` gathers the pages and runs a dense
softmax, as ``repro.kernels.ref.paged_decode_attention_ref`` does; it is the
explicit ``attn_impl="gather"`` path and what the kernel is checked against.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import launch, load

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMS = 132           # streaming multiprocessors of an H100 SXM
_BLOCKS_PER_SM = 4   # the split grid's target: this many blocks an SM
_HEADS = 8           # kMaxHeads in csrc/paged_attn.cu: query heads a block

# kernel launches since the last reset, one a call (the plain version is not
# counted; a call runs two CUDA launches, the split pass and the combine)
launches = 0


def split_pages(B: int, Hkv: int, g: int, n: int) -> int:
    """Pages per split block of the kernel, for B requests of n pages and
    Hkv kv heads of g query heads each.  The grid is (kv head x head group,
    request, split); each request's n pages get ceil(_BLOCKS_PER_SM * _SMS
    / (B * Hkv * head groups)) splits (at least 1, at most n), so that a
    call fills the SMs about that many times over.  At the serving shapes
    (llama3-8b, B 4, n 34) that is 2 pages a split, 17 splits and 544
    blocks."""
    groups = B * Hkv * -(-g // _HEADS)
    splits = min(n, -(-_BLOCKS_PER_SM * _SMS // groups))
    return -(-n // splits)


def paged_decode_attention_plain(q: torch.Tensor, pages_k: torch.Tensor,
                                 pages_v: torch.Tensor,
                                 page_table: torch.Tensor,
                                 lengths: torch.Tensor, *, window: int = 0,
                                 logit_softcap: float = 0.0) -> torch.Tensor:
    """Gather-then-softmax paged decode attention in f32.  q: (B, Hq, D);
    pools: (P, ps, Hkv, D); page_table: (B, n) int; lengths: (B,) valid
    tokens per request (>= 1).  Returns (B, Hq, D) in q's dtype."""
    B, Hq, D = q.shape
    _, ps, Hkv, _ = pages_k.shape
    n = page_table.shape[1]
    g = Hq // Hkv
    pt = page_table.long()
    kg = pages_k[pt].reshape(B, n * ps, Hkv, D).float()
    vg = pages_v[pt].reshape(B, n * ps, Hkv, D).float()
    if g > 1:
        kg = kg.repeat_interleave(g, dim=2)
        vg = vg.repeat_interleave(g, dim=2)
    qf = q.float() * (D ** -0.5)
    logits = torch.einsum("bhd,bkhd->bhk", qf, kg)
    if logit_softcap > 0:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    pos = torch.arange(n * ps, device=q.device)[None, :]
    valid = pos < lengths[:, None]
    if window > 0:
        valid &= pos > lengths[:, None] - 1 - window
    logits = torch.where(valid[:, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, vg).to(q.dtype)


def _check(q, pages_k, pages_v, page_table, lengths, window, logit_softcap):
    dev = q.device
    for name, t in (("pages_k", pages_k), ("pages_v", pages_v),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for name, t in (("q", q), ("pages_k", pages_k), ("pages_v", pages_v),
                    ("page_table", page_table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES or pages_k.dtype != q.dtype \
            or pages_v.dtype != q.dtype:
        raise TypeError("q and both pools must share one dtype, float32 or "
                        f"bfloat16; got {q.dtype}/{pages_k.dtype}/"
                        f"{pages_v.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    if q.dim() != 3 or pages_k.dim() != 4 or pages_k.shape != pages_v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pools "
                         f"{tuple(pages_k.shape)}/{tuple(pages_v.shape)}")
    B, Hq, D = q.shape
    _, _, Hkv, Dk = pages_k.shape
    if Dk != D or page_table.dim() != 2 or page_table.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pools "
                         f"{tuple(pages_k.shape)}, page_table "
                         f"{tuple(page_table.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if Hq % Hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {Hq}/{Hkv}")
    if D < 8 or D % 8 or D > 256:
        raise ValueError(f"head_dim must be a multiple of 8 and <= 256, "
                         f"got {D}")
    for name, t in (("pages_k", pages_k), ("pages_v", pages_v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if window < 0 or logit_softcap < 0:
        raise ValueError("window and logit_softcap must be >= 0")


def paged_decode_attention(q: torch.Tensor, pages_k: torch.Tensor,
                           pages_v: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *, window: int = 0,
                           logit_softcap: float = 0.0) -> torch.Tensor:
    """One-token attention over paged KV (see the module docstring)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, pages_k, pages_v, page_table, lengths, window=window,
            logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, got "
                         f"{q.device}")
    _check(q, pages_k, pages_v, page_table, lengths, window, logit_softcap)
    B, Hq, D = q.shape
    P, ps, Hkv, _ = pages_k.shape
    n = page_table.shape[1]
    pps = split_pages(B, Hkv, Hq // Hkv, n)
    out = torch.empty_like(q)
    # each split's (m, l) pairs, then its acc rows, in f32
    scratch = torch.empty(B * Hq * -(-n // pps) * (2 + D),
                          dtype=torch.float32, device=q.device)
    launch(_lib().paged_decode_attention, q.device, q.data_ptr(),
           pages_k.data_ptr(), pages_v.data_ptr(), page_table.data_ptr(),
           lengths.data_ptr(), scratch.data_ptr(), out.data_ptr(), B, Hq, Hkv,
           D, P, ps, n, pps, int(window), float(logit_softcap),
           float(D ** -0.5), _DTYPES[q.dtype])
    global launches
    launches += 1
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("paged_attn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_decode_attention.argtypes = [p, p, p, p, p, p, p] + [i] * 9 + [
        ctypes.c_float, ctypes.c_float, i, p]
    lib.paged_decode_attention.restype = ctypes.c_int
    return lib
