"""Blocked GEMM: the Hopper kernel, its plain PyTorch version and its
autograd wrapper.

Port of ``repro.kernels.blocked_matmul.blocked_matmul``: C[M,N] = A[M,K] @
B[K,N] for f32 or bf16 A and B (the same type), f32 result, f32
accumulation, tiles from the paper's §2.2 blocking search
(``core.blocking.solve_h100_gemm_blocking``).  The CUDA source,
``csrc/blocked_matmul.cu``, states its design and its bound: it runs on the
tensor cores, f32 inputs as 3xTF32 (``csrc/gemm_tf32x3.cuh``, the mainloop
it shares with the conv), bf16 inputs as bf16 products.  Unlike the TPU
kernel it takes any M, N and K: it masks its ragged edges.

:func:`blocked_matmul` is the wrapper: on CPU tensors it computes the plain
version (that is how the CPU tests run it); on CUDA tensors it launches the
kernel or raises — it never falls back.
:func:`blocked_matmul_plain` repeats the TPU kernel's arithmetic (one f32
``addmm_`` into the accumulator per K slab); the kernel is checked against
it.
:func:`matmul` is what the DNN calls for ``use_kernel=True``: the kernel
computes the forward and the backward is ``grad @ b.T`` and ``a.T @ grad``
through ``torch.matmul``.  The JAX package has no backward kernel for the
GEMM (its DNN's backward products are XLA's, outside any Pallas kernel), so
the backward runs PyTorch's own (cuBLAS on the card).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.blocking import (
    H100_GEMM_TILE_K,
    H100_GEMM_TILES_MN,
    GemmBlocking,
    solve_h100_gemm_blocking,
)

_MAX_GRID_Y = 65535
_DTYPES = (torch.float32, torch.bfloat16)

# kernel launches since the last reset (the plain version is not counted)
launches = 0


def kernel_tile(blocking: GemmBlocking, M: int, N: int, K: int
                ) -> Tuple[int, int, int]:
    """The compiled (bm, bn, bk) instance that runs ``blocking`` on an
    (M, K) @ (K, N) product.  A tile the kernel is compiled for maps to
    itself; a tile equal to its whole extent, where that extent is smaller
    than the smallest compiled tile (the solver's choice for a small
    dimension), runs on the smallest tile with its edge masked.  Anything
    else has no instance and raises."""
    def pick(b, dim, tiles, name):
        if b in tiles:
            return b
        if b == dim and dim < min(tiles):
            return min(tiles)
        raise ValueError(f"the kernel has no instance for {name}={b} "
                         f"(extent {dim}); it is compiled for {name} in "
                         f"{tiles}")
    return (pick(blocking.bm, M, H100_GEMM_TILES_MN, "bm"),
            pick(blocking.bn, N, H100_GEMM_TILES_MN, "bn"),
            pick(blocking.bk, K, (H100_GEMM_TILE_K,), "bk"))


@functools.lru_cache(maxsize=None)
def _solver_tile(M: int, N: int, K: int, size_data: int) -> GemmBlocking:
    """The §2.2 search's choice under the H100 preset, searched once per
    shape: a training step asks for the same few shapes every step, and on
    the host the search costs about as much as the kernel takes on the card
    at CD-DNN's first layer."""
    return solve_h100_gemm_blocking(M, N, K, size_data=size_data)


def blocked_matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                         bk: int = H100_GEMM_TILE_K) -> torch.Tensor:
    """The TPU kernel's arithmetic in PyTorch: an f32 accumulator of
    (M, N) zeros and, for each K slab of depth ``bk``, one f32 ``addmm_`` of
    the slab's (M x bk) @ (bk x N) product into it (bf16 slabs widened
    first).  Returns (M, N) f32."""
    M, K = a.shape
    acc = torch.zeros(M, b.shape[1], dtype=torch.float32, device=a.device)
    for k0 in range(0, K, bk):
        acc.addmm_(a[:, k0:k0 + bk].float(), b[k0:k0 + bk].float())
    return acc


def _check(a: torch.Tensor, b: torch.Tensor):
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a and b must both be float32 or both bfloat16, "
                        f"got {a.dtype}/{b.dtype}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"a must be (M, K) and b (K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ "
                         "in K")
    if min(a.shape[0], a.shape[1], b.shape[1]) < 1:
        raise ValueError(f"empty product {tuple(a.shape)} @ {tuple(b.shape)}")
    if not a.is_contiguous() or not b.is_contiguous():
        raise ValueError("a and b must be contiguous")


def blocked_matmul(a: torch.Tensor, b: torch.Tensor, *,
                   blocking: Optional[GemmBlocking] = None) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] in f32 (see the module docstring).
    ``blocking`` defaults to the §2.2 search's choice under the H100
    preset; one the kernel has no instance for raises (:func:`kernel_tile`),
    on the CPU too."""
    _check(a, b)
    (M, K), N = a.shape, b.shape[1]
    if blocking is None:
        blocking = _solver_tile(M, N, K, a.element_size())
    bm, bn, bk = kernel_tile(blocking, M, N, K)
    if a.device.type == "cpu":
        return blocked_matmul_plain(a, b, bk=bk)
    if a.device.type != "cuda":
        raise ValueError(f"blocked_matmul runs on cuda or cpu, got "
                         f"{a.device}")
    if -(-M // bm) > _MAX_GRID_Y:
        raise ValueError(f"M = {M} exceeds the kernel's grid at bm = {bm}")
    out = torch.empty(M, N, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().blocked_matmul(a.data_ptr(), b.data_ptr(),
                                   out.data_ptr(), M, N, K, bm, bn,
                                   int(a.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"blocked_matmul launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out


class _Matmul(torch.autograd.Function):
    """Kernel forward, ``torch.matmul`` backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return blocked_matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.to(g.dtype).t()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(a.to(g.dtype).t(), g).to(b.dtype)
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Differentiable :func:`blocked_matmul`: the kernel forward, the
    backward products through ``torch.matmul``."""
    return _Matmul.apply(a, b)


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("blocked_matmul")
    fn = lib.blocked_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p] + [i] * 6 + [p]
        fn.restype = ctypes.c_int
    return lib
