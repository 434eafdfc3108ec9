// Blocked GEMM for NVIDIA Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N], A and B
// row-major f32 or bf16 (both the same type), C row-major f32, f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/blocked_matmul.py::blocked_matmul
// (Pallas body _matmul_kernel) and computes what it computes.  Its tiles come
// from the paper's §2.2 blocking search, here under the H100 preset
// (repro_torch/core/blocking.py::solve_h100_gemm_blocking).
//
// Design, and what changed from the TPU kernel:
//   * The TPU grid walks K as its last, sequential axis and keeps the (bm, bn)
//     f32 accumulator tile resident in its output block across those steps.
//     Hopper blocks run in no order, so each block owns one (BM, BN) output
//     tile and loops over all of K itself, with the accumulator in the
//     registers of two warpgroups.
//   * The products run on the tensor cores through the mainloop this kernel
//     shares with the direct conv (gemm_tf32x3.cuh, which states the layout,
//     the loads and the pipeline): f32 inputs as 3xTF32 (each operand split
//     into a tf32 hi and lo, three wgmma products a k8 step, f32
//     accumulation), which keeps f32-level accuracy where one TF32 product
//     would lose it; bf16 inputs as one bf16 wgmma a k16 step, whose products
//     are exact.
//   * Tiles: BM, BN in {64, 128}, each (BM, BN) an instance for f32 and for
//     bf16 inputs; the wrapper maps the solver's choice (bk = 8, the tf32
//     wgmma's depth) onto its instance.  A shared-memory stage is 16 deep
//     (32 for bf16; twice that at 128 x 128), three stages rotate.
//   * Any M, N and K: loads past an edge read 0 and stores past it are skipped
//     (the TPU kernel asserts that its tiles divide M, N and K; CD-DNN's
//     K = 440 and N = 9304 divide by no 128).  Rows of A that are not 16-byte
//     aligned (K % 4 != 0 for f32, K % 8 != 0 for bf16) are loaded one element
//     at a time.
//
// Bound on this card, per call: the larger of
//   3 x 2 M N K tf32 operations / 494.7 TFLOP/s (f32 inputs; the data sheet's
//   dense TF32 rate; bf16 inputs 2 M N K / 989 TFLOP/s) and
//   (|A| + |B| + 4 M N) bytes / 3.35 TB/s.
// CD-DNN's forward pass at M = 1024 is bound by operations: 0.56 ms for its
// 8 products (1.38 ms at the 67 TFLOP/s of f32 outside the tensor cores,
// which bounded the FFMA kernel this one replaces).  Its times are in PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (repro_torch/kernels/build.py).  The C entry launches on the given stream,
// never synchronises, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_tf32x3.cuh"

namespace {

using tc_gemm::Cfg;

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(tc_gemm::kThreads, (tc_gemm::Cfg<T, BM, BN>::MIN_CTAS))
blocked_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ c,
                      int M, int N, int K, int vec) {
  extern __shared__ __align__(1024) uint8_t smem[];
  using C = Cfg<T, BM, BN>;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  const tc_gemm::DenseRows<T, C::A_LOADS> rows(
      a, M, K, vec != 0, m0 + threadIdx.x / C::CHUNKS, C::A_ROW_STEP);
  tc_gemm::tile<T, BM, BN>(smem, rows, b, c, M, N, K, m0, n0);
}

template <typename T>
int launch(const void* a, const void* b, void* c, int M, int N, int K, int bm, int bn,
           cudaStream_t stream) {
  const auto* pa = static_cast<const T*>(a);
  const auto* pb = static_cast<const T*>(b);
  auto* pc = static_cast<float*>(c);
  const dim3 grid(static_cast<unsigned>((N + bn - 1) / bn), static_cast<unsigned>((M + bm - 1) / bm));
  // 16-byte loads of A's rows where every row starts 16-byte aligned
  const int vec = K % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  if (bm == 128 && bn == 128) {
    return tc_gemm::launch<T, 128, 128>(blocked_matmul_kernel<T, 128, 128>, grid, stream, pa, pb,
                                        pc, M, N, K, vec);
  } else if (bm == 128 && bn == 64) {
    return tc_gemm::launch<T, 128, 64>(blocked_matmul_kernel<T, 128, 64>, grid, stream, pa, pb,
                                       pc, M, N, K, vec);
  } else if (bm == 64 && bn == 128) {
    return tc_gemm::launch<T, 64, 128>(blocked_matmul_kernel<T, 64, 128>, grid, stream, pa, pb,
                                       pc, M, N, K, vec);
  } else if (bm == 64 && bn == 64) {
    return tc_gemm::launch<T, 64, 64>(blocked_matmul_kernel<T, 64, 64>, grid, stream, pa, pb, pc,
                                      M, N, K, vec);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// a (M, K), b (K, N): contiguous, both float32 (bf16 = 0) or both bfloat16
// (bf16 = 1); c (M, N) contiguous float32; all on the device.  bm, bn in
// {64, 128}.  The caller has checked M, N, K >= 1 and that ceil(M / bm) fits
// the grid's y dimension.  Returns cudaErrorInvalidValue for a tile with no
// instance, else cudaGetLastError() after the launch.
extern "C" int blocked_matmul(const void* a, const void* b, void* c, int M, int N, int K,
                              int bm, int bn, int bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, b, c, M, N, K, bm, bn, s)
              : launch<float>(a, b, c, M, N, K, bm, bn, s);
}
