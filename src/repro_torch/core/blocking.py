"""Paper §2.2 — cache blocking as constrained B/F minimization
(``repro.core.blocking``, value for value), with a preset for the H100.

The paper formulates block-size selection as:

    BS  = working-set bytes of one block (inputs + outputs + weights)
    CPB = FLOPs computed on that block
    minimize B/F = BS/CPB  subject to  BS < Size_cache

and solves it by brute-force search over loop-block sizes, with one dimension
pinned to a multiple of the SIMD width.

The reference fixes the TPU's alignment (lane 128, sublane 8) and its
candidate caps in the search; here they are keyword arguments whose
defaults are the reference's, so the same arguments give the same choice.
:func:`solve_h100_gemm_blocking` is the search under the card's budget and
the tiles ``kernels/csrc/blocked_matmul.cu`` is compiled for.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.configs.base import H100_SXM

LANE = 128      # the reference's TPU lane width / MXU tile edge
SUBLANE = 8     # the reference's f32 sublane

# The tiles kernels/csrc/blocked_matmul.cu is compiled for: bm, bn in
# {64, 128}, bk = 8.  The §2.2 B/F model does not depend on bk (the K slab
# is streamed once either way), so the search, which breaks a B/F tie
# towards the smaller working set, always takes the shallowest slab; the
# kernel is compiled for that one depth.
H100_GEMM_TILES_MN = (64, 128)
H100_GEMM_TILE_K = 8


def _candidates(dim: int, align: int, max_val: Optional[int] = None
                ) -> List[int]:
    """Aligned candidate block sizes for a dimension of extent ``dim``."""
    cap = dim if max_val is None else min(dim, max_val)
    out = []
    c = align
    while c <= cap:
        if dim % c == 0:
            out.append(c)
        c *= 2
    if dim <= cap and dim % align == 0 and dim not in out:
        out.append(dim)
    if not out:
        out = [min(dim, align)]
    return out


@dataclass(frozen=True)
class GemmBlocking:
    bm: int
    bn: int
    bk: int
    bytes_per_block: int
    bf_ratio: float     # bytes moved per FLOP at steady state


def solve_gemm_blocking(M: int, N: int, K: int,
                        vmem_bytes: int = 8 * 2**20,
                        size_data: int = 4,
                        acc_bytes: int = 4, *,
                        align_m: int = SUBLANE, align_n: int = LANE,
                        align_k: int = LANE, max_m: int = 512,
                        max_n: int = 2048, max_k: int = 2048
                        ) -> GemmBlocking:
    """Brute-force B/F minimization for C[M,N] += A[M,K] @ B[K,N].

    Working set (paper's BS, with the f32 accumulator tile counted once and
    A/B double-buffered by the caller's budget):
        BS = size*(bm*bk + bk*bn) + acc*bm*bn
    Steady-state device-memory traffic to produce one (bm, bn) output tile:
        bytes = size*(bm*K + K*bn) + acc*bm*bn
        flops = 2*bm*bn*K
    so B/F = size*(1/bn + 1/bm)/2 + acc/(2K): maximize the harmonic mean of
    (bm, bn) under the capacity constraint.  Candidates per dimension are
    ``align * 2^i`` up to the cap that divide the extent (``_candidates``).
    The keyword arguments default to the reference's TPU alignment and caps.
    """
    best: Optional[GemmBlocking] = None
    for bm in _candidates(M, align_m, max_m):
        for bn in _candidates(N, align_n, max_n):
            for bk in _candidates(K, align_k, max_k):
                bs = size_data * (bm * bk + bk * bn) + acc_bytes * bm * bn
                if bs > vmem_bytes:
                    continue
                traffic = size_data * (bm * K + K * bn) + acc_bytes * bm * bn
                flops = 2.0 * bm * bn * K
                bf = traffic / flops
                cand = GemmBlocking(bm, bn, bk, bs, bf)
                if best is None or bf < best.bf_ratio or (
                        bf == best.bf_ratio and bs < best.bytes_per_block):
                    best = cand
    if best is None:
        raise ValueError(f"no ({M}, {N}, {K}) blocking fits {vmem_bytes} B")
    return best


def solve_h100_gemm_blocking(M: int, N: int, K: int,
                             size_data: int = 4) -> GemmBlocking:
    """The §2.2 search under the H100 preset: the budget is the shared
    memory one block can use (``H100_SXM.cache_bytes``), the alignment the
    smallest compiled tile and the caps the largest.

    On Hopper the (bm, bn) accumulator tile lives in registers (an 8 x 8 or
    smaller micro-tile per thread of 256) and only the A and B slabs in
    shared memory; the reference's BS counts both against one VMEM budget.
    The preset keeps the reference's formula, which over-counts the shared
    memory, and with these caps even the largest tile's BS (73,728 B at
    128 x 128 x 8) is far inside the budget: the caps, set by the registers
    a thread has, bind, not the budget.  An extent smaller than the
    smallest tile, or divisible by none, yields ``min(extent, align)``
    (``_candidates``' fallback); the kernel masks the edge, so it runs on
    the smallest tile (``kernels.blocked_matmul``)."""
    lo, hi = min(H100_GEMM_TILES_MN), max(H100_GEMM_TILES_MN)
    return solve_gemm_blocking(
        M, N, K, vmem_bytes=H100_SXM.cache_bytes, size_data=size_data,
        align_m=lo, align_n=lo, align_k=H100_GEMM_TILE_K, max_m=hi,
        max_n=hi, max_k=H100_GEMM_TILE_K)


@dataclass(frozen=True)
class ConvBlocking:
    b_mb: int      # minibatch block
    b_ifm: int
    b_ofm: int
    b_oh: int
    b_ow: int
    bytes_per_block: int
    bf_ratio: float


def conv_block_bytes(b_mb, b_ifm, b_ofm, b_oh, b_ow, k, s,
                     size_data: int = 4) -> int:
    """Paper §2.2 BS: output block + input block + weight block."""
    in_h = b_oh * s + k - 1
    in_w = b_ow * s + k - 1
    return size_data * (b_mb * b_ofm * b_oh * b_ow
                        + b_mb * b_ifm * in_h * in_w
                        + b_ifm * b_ofm * k * k)


def conv_block_flops(b_mb, b_ifm, b_ofm, b_oh, b_ow, k) -> float:
    """Paper §2.2 CPB = 2 * mb * ifm * ofm * k_w * k_h * out_w * out_h."""
    return 2.0 * b_mb * b_ifm * b_ofm * b_oh * b_ow * k * k


def solve_conv_blocking(minibatch: int, ifm: int, ofm: int,
                        out_hw: int, kernel: int, stride: int = 1,
                        cache_bytes: int = 8 * 2**20,
                        size_data: int = 4,
                        simd: int = LANE) -> ConvBlocking:
    """The paper's brute-force state-space search (§2.2), with the ofm block
    pinned to a multiple of the SIMD/lane width.  Traffic model: traversing
    consecutive blocks along each dim reuses the overlapping input rows /
    resident outputs (the paper's 'traversal' observation); each block is
    charged its BS and reuse is accounted by preferring blocks that cover a
    whole dimension (the flops denominator grows with coverage)."""
    best: Optional[ConvBlocking] = None
    mb_cands = sorted({1, min(2, minibatch), min(4, minibatch),
                       min(8, minibatch), minibatch})
    ofm_cands = _candidates(ofm, min(simd, ofm))
    ifm_cands = sorted({1, *(c for c in (8, 16, 32, 64, 128, 256, 512, 1024)
                             if c <= ifm and ifm % c == 0), ifm})
    hw_cands = sorted({1, *(c for c in (2, 3, 4, 6, 7, 12, 14, 24, 28, 56)
                            if c <= out_hw and out_hw % c == 0), out_hw})
    for b_mb in mb_cands:
        for b_ifm in ifm_cands:
            for b_ofm in ofm_cands:
                for b_oh in hw_cands:
                    for b_ow in hw_cands:
                        bs = conv_block_bytes(b_mb, b_ifm, b_ofm, b_oh, b_ow,
                                              kernel, stride, size_data)
                        if bs > cache_bytes:
                            continue
                        # bytes charged: input+weights stream per block; the
                        # output tile is resident while the ifm loop runs.
                        in_h = b_oh * stride + kernel - 1
                        in_w = b_ow * stride + kernel - 1
                        traffic = size_data * (
                            b_mb * b_ofm * b_oh * b_ow            # out, once
                            + b_mb * ifm * in_h * in_w            # all ifm
                            + ifm * b_ofm * kernel * kernel)      # all wts
                        flops = conv_block_flops(b_mb, ifm, b_ofm, b_oh, b_ow,
                                                 kernel)
                        bf = traffic / flops
                        cand = ConvBlocking(b_mb, b_ifm, b_ofm, b_oh, b_ow,
                                            bs, bf)
                        if best is None or bf < best.bf_ratio:
                            best = cand
    if best is None:
        raise ValueError(f"no conv blocking fits {cache_bytes} B")
    return best


def layer_bf_unblocked(l_out_hw: int, kernel: int, stride: int = 1,
                       size_data: int = 4) -> float:
    """Paper §2.2 row-at-a-time B/F:
    size*(out_w*out_h + in_w*in_h + k_w*k_h)/(2*k_w*k_h*out_w*out_h).
    For OverFeat-FAST C5 (12x12 out, 3x3 kernel) this is 0.54."""
    out_w = out_h = l_out_hw
    in_w = out_w * stride + kernel - 1
    in_h = out_h * stride + kernel - 1
    return size_data * (out_w * out_h + in_w * in_h + kernel * kernel) / (
        2.0 * kernel * kernel * out_w * out_h)


def layer_bf_fully_cached(minibatch: int, ifm: int, ofm: int, out_hw: int,
                          kernel: int, stride: int = 1,
                          size_data: int = 4) -> float:
    """Paper §2.2 best-case B/F when everything fits on chip:
    for OverFeat-FAST C5 at minibatch 256 this is ~0.003."""
    out_w = out_h = out_hw
    in_w = out_w * stride + kernel - 1
    in_h = out_h * stride + kernel - 1
    num = size_data * (minibatch * ofm * out_w * out_h
                       + minibatch * ifm * in_w * in_h
                       + ifm * ofm * kernel * kernel)
    den = 2.0 * minibatch * ofm * ifm * kernel * kernel * out_w * out_h
    return num / den
