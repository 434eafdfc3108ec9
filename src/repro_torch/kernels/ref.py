"""Plain PyTorch oracles of the reference's ``repro.kernels.ref`` that the
port's kernels and models are held against.

:func:`conv2d_ref` is the reference's default conv route (``lax.conv`` on
NHWC/HWIO).  It is not a port of a TPU kernel: here it is one
``torch.nn.functional.conv2d`` call on permuted views, the route
``cnn.forward(use_kernel=False)`` takes and the gradient the conv kernel's
autograd wrapper uses.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
               padding: int = 0) -> torch.Tensor:
    """NHWC x HWIO -> NHWC convolution in f32 with symmetric zero padding.
    x: (N, H, W, IFM), w: (K, K, IFM, OFM) -> (N, OH, OW, OFM)."""
    out = F.conv2d(x.float().permute(0, 3, 1, 2),
                   w.float().permute(3, 2, 0, 1), stride=stride,
                   padding=padding)
    return out.permute(0, 2, 3, 1)


def ring_reduce_scatter_ref(stacked: torch.Tensor) -> torch.Tensor:
    """Oracle of ``kernels.ring.ring_reduce_scatter``: row p is the sum over
    members of chunk p, accumulated in f32 and cast back (the ring adds hop
    by hop in the input dtype, so bf16 compares to a tolerance)."""
    G, N = stacked.shape
    full = stacked.float().sum(0)
    return full.reshape(G, N // G).to(stacked.dtype)


def ring_all_gather_ref(strips: torch.Tensor) -> torch.Tensor:
    """Oracle of ``kernels.ring.ring_all_gather``: every member holds the
    full buffer, strips concatenated in owner order."""
    G, n = strips.shape
    return strips.reshape(1, G * n).expand(G, G * n)


# ---------------------------------------------------------------------------
# the compressed wire formats (``CommConfig.wire_format``)
# ---------------------------------------------------------------------------
def ieee_div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` rounded once, as IEEE division.  The divisor rides in as a
    tensor on ``x``'s device: PyTorch's CUDA division by a Python scalar
    multiplies by its rounded reciprocal, which may differ by one ulp."""
    if not isinstance(d, torch.Tensor):
        d = torch.tensor(d, dtype=x.dtype, device=x.device)
    return torch.div(x, d)


def int8_scale_ref(amax: torch.Tensor) -> torch.Tensor:
    """The per-message scale of a max-abs ``amax``: ``amax / 127``, 1 where
    that is 0 (an all-zero message keeps its dequantize defined)."""
    s = ieee_div(amax, 127.0)
    return torch.where(s > 0, s, torch.ones_like(s))


def int8_quantize_ref(x: torch.Tensor):
    """Oracle of ``kernels.ring.int8_quantize``: symmetric per-message
    max-abs quantization of a 1-D message.  Returns ``(q int8 (n,),
    scale f32 (1,))``; rounding is half to even, so ``|q| <= 127``."""
    xf = x.float()
    s = int8_scale_ref(xf.abs().max())
    q = torch.round(ieee_div(xf, s)).to(torch.int8)
    return q, s.reshape(1)


def int8_dequantize_ref(q: torch.Tensor, scale: torch.Tensor
                        ) -> torch.Tensor:
    """Inverse of :func:`int8_quantize_ref` (f32 result)."""
    return q.float() * scale.reshape(())


def ring_hop_int8_ref(chunks: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor, c) -> tuple:
    """Oracle of ``kernels.ring.ring_hop_int8``: dequantize the received
    message, add the local partial of chunk ``c`` in f32 and re-quantize
    against a fresh max-abs scale (one rounding per hop)."""
    acc = int8_dequantize_ref(q, scale) + chunks[c].float()
    return int8_quantize_ref(acc)


def topk_indices_ref(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest ``|x|`` along the last dimension, ties to
    the lower index first (``lax.top_k``'s rule): a stable descending sort."""
    order = torch.sort(x.float().abs(), dim=-1, descending=True,
                       stable=True).indices
    return order[..., :k]


def topk_select_ref(x: torch.Tensor, k: int) -> tuple:
    """Top-k sparsification oracle: the ``k`` largest-|x| entries as a
    ``(values f32 (k,), indices int32 (k,))`` wire message."""
    xf = x.float()
    idx = topk_indices_ref(xf, k)
    return xf[idx], idx.to(torch.int32)


def topk_scatter_ref(vals: torch.Tensor, idx: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Densify a (values, indices) message into an ``(n,)`` f32 buffer
    (duplicate indices accumulate)."""
    return torch.zeros(n, dtype=torch.float32, device=vals.device) \
        .index_add_(0, idx.long(), vals.float())


def ring_hop_topk_ref(chunks: torch.Tensor, vals: torch.Tensor,
                      idx: torch.Tensor, c) -> torch.Tensor:
    """Oracle of ``kernels.ring.ring_hop_topk``: scatter the received sparse
    message dense and add the local partial of chunk ``c`` (f32).  The
    next hop's re-selection stays outside the kernel."""
    return topk_scatter_ref(vals, idx, chunks.shape[1]) + chunks[c].float()


def topk_mask_ref(x: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the ``k`` largest-|x| entries of ``x`` in place along the last
    dimension, zero the rest: the bucket sparsifier of the error-feedback
    update (``optim.dist.make_topk_ef_update``); the residual is
    ``x - mask``."""
    idx = topk_indices_ref(x, k)
    return torch.zeros_like(x).scatter_(-1, idx, x.gather(-1, idx))
