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
