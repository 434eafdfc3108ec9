"""Direct NHWC convolution: the Hopper kernel, its plain PyTorch version and
its autograd wrapper.

Port of ``repro.kernels.conv2d.conv2d_nhwc``: x (N, H, W, IFM) and HWIO
weights w (K, K, IFM, OFM), stride and symmetric zero padding, f32 in and
out.  The CUDA source, ``csrc/conv2d.cu``, states its design and its bound:
an implicit GEMM on the tensor cores in 3xTF32, on the mainloop it shares
with the blocked GEMM (``csrc/gemm_tf32x3.cuh``).

:func:`conv2d_nhwc` is the wrapper: on CPU tensors it computes the plain
version (that is how the CPU tests run it); on CUDA tensors it launches the
kernel or raises — it never falls back.
:func:`conv2d_nhwc_plain` repeats the TPU kernel's arithmetic (pad, then one
matmul per kernel tap, accumulated in f32); the kernel is checked against it.
:func:`conv2d` is what the CNN calls for ``use_kernel=True``: the kernel
computes the forward and the backward is the gradient of
``kernels.ref.conv2d_ref`` — kernel forward, reference backward, as the
reference's ``kernels/ops.attention`` does with a ``custom_vjp``.  The JAX
package has no backward kernel for the conv, so the backward runs PyTorch's
own (:func:`conv2d_ref_backward`, cuDNN on the card).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

_MAX_GRID_X = 2 ** 31 - 1
_BM = 128          # kBM in csrc/conv2d.cu: output pixels per block

# kernel launches since the last reset (the plain version is not counted)
launches = 0


def out_hw(h: int, w: int, k: int, stride: int, padding: int
           ) -> Tuple[int, int]:
    """Output height and width of a K x K conv."""
    return ((h + 2 * padding - k) // stride + 1,
            (w + 2 * padding - k) // stride + 1)


def conv2d_nhwc_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                      padding: int = 0) -> torch.Tensor:
    """The TPU kernel's arithmetic in PyTorch: zero-pad x, then for every
    tap (kh, kw) one (N*OH*OW x IFM) @ (IFM x OFM) product of the strided
    input window, accumulated in f32.  Returns (N, OH, OW, OFM) f32."""
    N, H, W, C = x.shape
    K, _, _, OFM = w.shape
    OH, OW = out_hw(H, W, K, stride, padding)
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    acc = torch.zeros(N * OH * OW, OFM, dtype=torch.float32, device=x.device)
    for kh in range(K):
        for kw in range(K):
            xs = x[:, kh:kh + (OH - 1) * stride + 1:stride,
                   kw:kw + (OW - 1) * stride + 1:stride, :]
            acc.addmm_(xs.reshape(-1, C), w[kh, kw])
    return acc.reshape(N, OH, OW, OFM)


def _check(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int):
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"x and w must be float32, got {x.dtype}/{w.dtype}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x must be (N, H, W, IFM) and w (K, K, IFM, OFM), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("x and w must be contiguous")
    if w.shape[0] != w.shape[1] or w.shape[2] != x.shape[3]:
        raise ValueError(f"w {tuple(w.shape)} must be (K, K, IFM, OFM) with "
                         f"IFM = x's {x.shape[3]} channels")
    if stride < 1 or padding < 0:
        raise ValueError(f"stride must be >= 1 and padding >= 0, got "
                         f"{stride}/{padding}")
    OH, OW = out_hw(x.shape[1], x.shape[2], w.shape[0], stride, padding)
    if OH < 1 or OW < 1:
        raise ValueError(f"a {w.shape[0]}x{w.shape[0]} kernel does not fit "
                         f"the padded {tuple(x.shape[1:3])} input")
    return OH, OW


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """x (N, H, W, IFM) conv w (K, K, IFM, OFM) -> (N, OH, OW, OFM), f32
    (see the module docstring)."""
    OH, OW = _check(x, w, stride, padding)
    if x.device.type == "cpu":
        return conv2d_nhwc_plain(x, w, stride=stride, padding=padding)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_nhwc runs on cuda or cpu, got {x.device}")
    N, H, W, C = x.shape
    K, _, _, OFM = w.shape
    if -(-N * OH * OW // _BM) > _MAX_GRID_X:
        raise ValueError(f"{N * OH * OW} output pixels exceed the kernel's "
                         "grid")
    out = torch.empty(N, OH, OW, OFM, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().conv2d_nhwc_f32(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), N, H, W, C, K, OFM,
            int(stride), int(padding), OH, OW, stream)
    if rc != 0:
        raise RuntimeError(f"conv2d_nhwc launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out


def conv2d_ref_backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                        stride: int, padding: int, need_x: bool = True,
                        need_w: bool = True):
    """Gradients of ``kernels.ref.conv2d_ref`` at (x, w) for the output
    gradient g (N, OH, OW, OFM): (dx NHWC or None, dw HWIO or None).  It is
    the one call ``F.conv2d``'s own backward makes, on the same NCHW/OIHW
    views ``conv2d_ref`` hands it, so given the same g both routes of the
    CNN compute the same gradients with the same algorithms."""
    gx, gw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
        None, [stride, stride], [padding, padding], [1, 1], False, [0, 0], 1,
        [need_x, need_w, False])
    return (gx.permute(0, 2, 3, 1) if need_x else None,
            gw.permute(2, 3, 1, 0) if need_w else None)


class _Conv2d(torch.autograd.Function):
    """Kernel forward, reference backward."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        return conv2d_nhwc(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx, gw = conv2d_ref_backward(x, w, g, ctx.stride, ctx.padding,
                                     *ctx.needs_input_grad[:2])
        return gx, gw, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """Differentiable :func:`conv2d_nhwc`: the kernel forward, the gradient
    of ``kernels.ref.conv2d_ref`` backward."""
    return _Conv2d.apply(x, w, stride, padding)


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("conv2d")
    fn = lib.conv2d_nhwc_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p] + [i] * 10 + [p]
        fn.restype = ctypes.c_int
    return lib
