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

import torch

NEG_INF = -1e30
_THREADS = 128     # kThreads in csrc/paged_attn.cu
_MAX_ACC = 32      # kMaxAcc in csrc/paged_attn.cu
_MAX_SMEM = 48 * 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (the plain version is not counted)
launches = 0


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
    _, ps, Hkv, Dk = pages_k.shape
    if Dk != D or page_table.dim() != 2 or page_table.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pools "
                         f"{tuple(pages_k.shape)}, page_table "
                         f"{tuple(page_table.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if Hq % Hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {Hq}/{Hkv}")
    if D % 32 or D > 256:
        raise ValueError(f"head_dim must be a multiple of 32 and <= 256, "
                         f"got {D}")
    g = Hq // Hkv
    if g * -(-D // _THREADS) > _MAX_ACC:
        raise ValueError(f"{g} query heads per kv head at head_dim {D} "
                         f"exceed the kernel's {_MAX_ACC} accumulators")
    if 4 * (g * D + g * ps + 3 * g) > _MAX_SMEM:
        raise ValueError("page_size too large for the kernel's shared memory")
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
    lib = _lib()
    B, Hq, D = q.shape
    P, ps, Hkv, _ = pages_k.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.paged_decode_attention(
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, D, P, ps, page_table.shape[1], int(window),
            float(logit_softcap), float(D ** -0.5), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {rc}")
    global launches
    launches += 1
    return out


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("paged_attn")
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib
