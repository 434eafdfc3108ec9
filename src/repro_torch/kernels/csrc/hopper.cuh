// Hopper (sm_90a) building blocks in raw PTX: mbarriers, TMA tile loads
// (and the host's tensor-map encoder), wgmma descriptors and the few wgmma
// shapes the port's kernels issue (bf16, and tf32 with its rounding), and
// register hand-over between warpgroups (setmaxnreg).
//
// Shared-memory operand layouts are the ones TMA writes with a 64- or
// 128-byte swizzle: rows of R bytes (R = 64 or 128), eight rows an atom of
// 8 R bytes, each atom aligned to its size.  A K-major operand (the product's
// depth contiguous) advances along K by moving the start address 32 bytes a
// k16 step inside a row; an MN-major operand (rows along K) by 16 rows.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

// f(std::integral_constant<int, I>) for I = B ... E - 1, unrolled at compile
// time (the wgmma offsets below are immediates)
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive once and expect `bytes` more of transactions (TMA completions)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed; a wait that never
// ends (a lost arrival) traps after ~2^30 polls instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// ---- TMA ------------------------------------------------------------------
// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// the driver's tensor-map encoder, found at run time (no -lcuda); null
// where the driver has none
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// ---- register hand-over ---------------------------------------------------
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma ----------------------------------------------------------------
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (1 = 128 B, 2 = 64 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, uint32_t swizzle) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HK_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HK_F8(d, i) HK_F4(d, i), HK_F4(d, i + 4)
#define HK_F16(d, i) HK_F4(d, i), HK_F4(d, i + 4), HK_F4(d, i + 8), HK_F4(d, i + 12)
#define HK_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define HK_R16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HK_R32                                                                              \
  HK_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"

// The products take base descriptors and compile-time offsets OA, OB (in
// 16-byte units) that are added inside the instruction's own asm block, so
// that only the base descriptors stay live in registers.

// d (64 x N, f32) (+)= A (64 x 16, bf16, from registers)
//                      . B (16 x N, bf16, MN-major in shared memory),
// N = 32 or 64 (the flash kernels' P V); the product is added to d where
// accumulate != 0, else it overwrites d
template <int N, int OB>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
  static_assert(N == 32 || N == 64, "no such shape");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %21, 0;\n"
        "add.s64 db, %20, %22;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" HK_R16
        "}, {%16, %17, %18, %19}, db, p, 1, 1, 1;\n}\n"
        : HK_F16(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(OB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %37, 0;\n"
        "add.s64 db, %36, %38;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HK_R32
        "}, {%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
        : HK_F16(d, 0), HK_F16(d, 16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(OB));
  }
}

// The products of the blocked GEMM and the direct conv (gemm_tf32x3.cuh)
// and the flash kernels' S:
// d (64 x N, f32) += A (64 x K, K-major in shared memory)
//                  . B (K x N, K-major in shared memory),
// K = 8 tf32 (f32 bits of which the instruction reads the top 19) or 16
// bf16, N = 32, 64 or 128 (bf16 also 16, for the 16-key tiles that
// experiments/flash_f32_variants.py times); the product is added to d where
// accumulate != 0, else it overwrites d.
#define HK_R64                                                                              \
  HK_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
         "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
// operands after the accumulator: descriptors a, b, accumulate, OA, OB
#define HK_WGMMA_SS(SHAPE, TYPES, TAIL, RLIST, A, B, ACC, OA, OB)                              \
  asm volatile("{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %" ACC ", 0;\n"          \
               "add.s64 da, %" A ", %" OA ";\nadd.s64 db, %" B ", %" OB ";\n"                   \
               "wgmma.mma_async.sync.aligned." SHAPE "." TYPES " {" RLIST "}, da, db, p, 1, 1" \
               TAIL ";\n}\n"

template <int N, bool TF32, int OA, int OB>
__device__ __forceinline__ void wgmma_ss_kmajor(float (&d)[N / 2], uint64_t a, uint64_t b,
                                                int accumulate) {
  static_assert(N == 32 || N == 64 || N == 128 || (N == 16 && !TF32), "no such shape");
  // tf32 takes no transpose operands; bf16 takes two, both 0 (K-major)
  if constexpr (N == 16) {
    HK_WGMMA_SS("m64n16k16", "f32.bf16.bf16", ", 0, 0", HK_R8, "8", "9", "10", "11", "12")
        : HK_F8(d, 0) : "l"(a), "l"(b), "r"(accumulate), "n"(OA), "n"(OB));
  } else if constexpr (N == 32 && TF32) {
    HK_WGMMA_SS("m64n32k8", "f32.tf32.tf32", "", HK_R16, "16", "17", "18", "19", "20")
        : HK_F16(d, 0) : "l"(a), "l"(b), "r"(accumulate), "n"(OA), "n"(OB));
  } else if constexpr (N == 32) {
    HK_WGMMA_SS("m64n32k16", "f32.bf16.bf16", ", 0, 0", HK_R16, "16", "17", "18", "19", "20")
        : HK_F16(d, 0) : "l"(a), "l"(b), "r"(accumulate), "n"(OA), "n"(OB));
  } else if constexpr (N == 64 && TF32) {
    HK_WGMMA_SS("m64n64k8", "f32.tf32.tf32", "", HK_R32, "32", "33", "34", "35", "36")
        : HK_F16(d, 0), HK_F16(d, 16) : "l"(a), "l"(b), "r"(accumulate), "n"(OA), "n"(OB));
  } else if constexpr (N == 64) {
    HK_WGMMA_SS("m64n64k16", "f32.bf16.bf16", ", 0, 0", HK_R32, "32", "33", "34", "35", "36")
        : HK_F16(d, 0), HK_F16(d, 16) : "l"(a), "l"(b), "r"(accumulate), "n"(OA), "n"(OB));
  } else if constexpr (TF32) {
    HK_WGMMA_SS("m64n128k8", "f32.tf32.tf32", "", HK_R64, "64", "65", "66", "67", "68")
        : HK_F16(d, 0), HK_F16(d, 16), HK_F16(d, 32), HK_F16(d, 48)
        : "l"(a), "l"(b), "r"(accumulate), "n"(OA), "n"(OB));
  } else {
    HK_WGMMA_SS("m64n128k16", "f32.bf16.bf16", ", 0, 0", HK_R64, "64", "65", "66", "67", "68")
        : HK_F16(d, 0), HK_F16(d, 16), HK_F16(d, 32), HK_F16(d, 48)
        : "l"(a), "l"(b), "r"(accumulate), "n"(OA), "n"(OB));
  }
}

#undef HK_WGMMA_SS
#undef HK_R64
#undef HK_F4
#undef HK_F8
#undef HK_F16
#undef HK_R8
#undef HK_R16
#undef HK_R32

// x rounded to tf32 (10 mantissa bits, to nearest, ties away from zero):
// the f32 bits a tf32 wgmma reads, with the 13 it ignores zero
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// orders this thread's generic-proxy writes to shared memory before later
// reads of it by the async proxy (a wgmma's operand fetch)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// two floats as one bf16x2 register, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace hopper
