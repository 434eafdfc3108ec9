"""Flash attention: the Hopper kernel, its plain PyTorch version and its
autograd wrapper.

Port of ``repro.kernels.flash_attention.flash_attention``: causal,
sliding-window, logit-softcapped GQA attention with an online softmax over
KV blocks, so the (Sq, Skv) score matrix is never stored.  q: (B, Sq, Hq,
D); k, v: (B, Skv, Hkv, D); bf16 or f32 in (one type for all three), q's
type out, f32 inside.  Both types run on the tensor cores (wgmma, K and V
fed by TMA): bf16 as it is, f32 as six products of bf16 pieces, after a
first launch that splits K and V into scratch this wrapper allocates; the
CUDA source, ``csrc/flash_attention.cu``, states both designs and the
bound.  Unlike the TPU kernel it takes any Sq and Skv:
it masks its ragged edges (the reference sends such shapes to
``attention_ref``).  It takes every head dim ``D % 8 == 0`` up to 256, as
the TPU kernel, whose blocks span the whole of D, takes any D: a D between
the compiled instances (``HEAD_DIMS``) runs the next one up, its columns
past D zeros (:func:`instance_dim`).

:func:`flash_attention` is the wrapper: on CPU tensors it computes the plain
version (that is how the CPU tests run it); on CUDA tensors it launches the
kernel or raises — it never falls back.  ``launches`` counts calls, one a
call whatever the kernels inside (two for f32).
:func:`flash_attention_plain` repeats the TPU kernel's arithmetic block by
block; the kernel is checked against it.
:func:`attention` is what ``attention_block(use_kernel=True)`` calls, the
port of ``repro.kernels.ops.attention``: the kernel computes the forward,
and the backward is the gradient of ``kernels.ref.attention_ref``
recomputed from q, k and v, as the reference's ``_attention_bwd`` is.  The
JAX package has no backward kernel, so neither has the port.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.build import launch, load
from repro_torch.kernels.ref import attention_ref

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)     # the compiled instances (csrc)
_MAX_GRID_Y = 65535
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (the plain version is not counted)
launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          logit_softcap: float = 0.0,
                          scale: Optional[float] = None, bq: int = 128,
                          bkv: int = 128) -> torch.Tensor:
    """The TPU kernel's arithmetic in PyTorch.  For each block of ``bq``
    query rows (all heads and batch rows at once): an f32 running max,
    denominator and (rows, D) accumulator, updated by every block of
    ``bkv`` keys that holds a live (q, k) pair (the others are skipped),
    then divided by ``max(l, 1e-30)``.  Blocks are capped at Sq and Skv; a
    ragged last block is simply shorter."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    bq, bkv = min(bq, Sq), min(bkv, Skv)
    dev = q.device
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    for q0 in range(0, Sq, bq):
        n = min(bq, Sq - q0)
        qb = (q[:, q0:q0 + n].float() * scale).view(B, n, Hkv, g, D)
        q_pos = torch.arange(n, device=dev) + (q0 + Skv - Sq)
        lo, hi = q0 + Skv - Sq, q0 + n - 1 + Skv - Sq   # first/last q_pos
        m = torch.full((B, n, Hkv, g), NEG_INF, dtype=torch.float32,
                       device=dev)
        lsum = torch.zeros_like(m)
        acc = torch.zeros((B, n, Hkv, g, D), dtype=torch.float32, device=dev)
        for k0 in range(0, Skv, bkv):
            kk = min(bkv, Skv - k0)
            if causal and k0 > hi:
                break
            if window > 0 and k0 + kk - 1 <= lo - window:
                continue
            s = torch.einsum("bqhgd,bkhd->bqhgk", qb, kf[:, k0:k0 + kk])
            if logit_softcap > 0:
                s = torch.tanh(s / logit_softcap) * logit_softcap
            k_pos = torch.arange(k0, k0 + kk, device=dev)[None, :]
            mask = torch.ones(n, kk, dtype=torch.bool, device=dev)
            if causal:
                mask &= k_pos <= q_pos[:, None]
            if window > 0:
                mask &= k_pos > q_pos[:, None] - window
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            lsum = lsum * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p, vf[:, k0:k0 + kk])
            m = m_new
        o = acc / torch.clamp(lsum, min=1e-30)[..., None]
        out[:, q0:q0 + n] = o.reshape(B, n, Hq, D).to(q.dtype)
    return out


def instance_dim(D: int) -> int:
    """The compiled instance that runs head dim ``D``: the least of
    ``HEAD_DIMS`` that holds it (zamba2's 80 and h2o-danube's 120 run the
    128 one).  ``D`` must be a multiple of 8 (a row of D bf16 is then a
    multiple of the 16 bytes TMA strides by) from 8 to 256."""
    if D % 8 or not 8 <= D <= HEAD_DIMS[-1]:
        raise ValueError(f"head_dim {D} is not a multiple of 8 from 8 to "
                         f"{HEAD_DIMS[-1]}: no compiled instance takes it "
                         f"(instances {HEAD_DIMS})")
    return next(d for d in HEAD_DIMS if d >= D)


def _check(q, k, v, causal, window, logit_softcap):
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype, float32 or "
                        f"bfloat16; got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Sq, Hq, D) and k, v one (B, Skv, "
                         f"Hkv, D) shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    if Bk != B or Dk != D or min(B, Sq, Skv, Hkv) < 1:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} "
                         "disagree in batch or head_dim, or are empty")
    if Hq % Hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {Hq}/{Hkv}")
    instance_dim(D)
    if causal and Sq > Skv:
        raise ValueError(f"causal attention with Sq {Sq} > Skv {Skv}: "
                         "right-aligned queries before the first key "
                         "attend nothing")
    if window < 0 or logit_softcap < 0:
        raise ValueError("window and logit_softcap must be >= 0")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention forward (see the module docstring); ``scale`` defaults to
    ``D ** -0.5``.  Bad arguments raise before anything runs, on the CPU
    too."""
    _check(q, k, v, causal, window, logit_softcap)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     logit_softcap=logit_softcap,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hq > _MAX_GRID_Y or B > _MAX_GRID_Y:
        raise ValueError(f"B {B} or Hq {Hq} exceeds the kernel's grid")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("the bf16 kernel loads q, k and v by TMA, which "
                         "needs 16-byte-aligned tensors")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    # f32: the three bf16 pieces of K, then of V, that the first launch writes
    planes = torch.empty(6 * k.numel(), dtype=torch.bfloat16,
                         device=q.device) if q.dtype == torch.float32 else None
    launch(_lib().flash_attention, q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), None if planes is None else planes.data_ptr(),
           out.data_ptr(), B, Sq, Skv, Hq, Hkv, D, int(causal), int(window),
           float(logit_softcap), float(scale), _DTYPES[q.dtype])
    global launches
    launches += 1
    return out


class _Attention(torch.autograd.Function):
    """Kernel forward, ``attention_ref``'s gradient backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_softcap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window,
                        logit_softcap=logit_softcap)
        return flash_attention(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = attention_ref(q, k, v, **ctx.opts)
            gq, gk, gv = torch.autograd.grad(out, (q, k, v), g)
        return gq, gk, gv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0,
              logit_softcap: float = 0.0) -> torch.Tensor:
    """Differentiable :func:`flash_attention` in the (B, S, H, D) layout:
    the kernel forward, the backward through ``attention_ref``."""
    return _Attention.apply(q, k, v, causal, window, logit_softcap)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention.argtypes = [p] * 5 + [i] * 8 + [f, f, i, p]
    lib.flash_attention.restype = ctypes.c_int
    return lib
