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
//     tile and loops over all of K itself, 8 at a time: an A slab (BM x 8,
//     stored k-major) and a B slab (8 x BN) in shared memory, double-buffered,
//     with the next slab's global loads in registers while the current one is
//     consumed.  One barrier per slab (the conv kernel's scheme).
//   * The accumulator tile lives in registers: 256 threads in a 16 x 16 grid,
//     each holding a (BM/16) x (BN/16) micro-tile (8 x 8 at 128 x 128, the
//     most registers a thread can give it at two blocks per SM) and doing
//     (BM/16)(BN/16) FFMAs per k.  A thread's rows and columns come in groups
//     of 4, BM/2 (BN/2) apart when it has two groups, so that its float4
//     reads of the B slab (and A's) fall on distinct banks across a half warp.
//   * The A slab is padded by 4 floats a row: the transposing stores then hit
//     32 distinct banks and the float4 reads stay 16-byte aligned.
//   * Tiles: BM, BN in {64, 128} and BK = 8, each (BM, BN) an instance of the
//     template for f32 and for bf16 inputs; the wrapper maps the solver's
//     choice onto its instance.  BK = 8 keeps the two slabs of the largest
//     tile at 16.5 KB, inside the 48 KB of static shared memory, with two
//     blocks per SM.
//   * Any M, N and K: loads past an edge read 0 and stores past it are skipped
//     (the TPU kernel asserts that its tiles divide M, N and K; CD-DNN's
//     K = 440 and N = 9304 divide by no 128).
//   * bf16 inputs are widened to f32 as they are loaded (exact), and every
//     product is a plain f32 FFMA: no tensor cores, no TF32, so the kernel
//     agrees with its plain version and with cuBLAS at allow_tf32=False to f32
//     rounding.
//
// Bound on this card, per call: the larger of
//   2 M N K operations / 67 TFLOP/s (f32 outside the tensor cores) and
//   (|A| + |B| + 4 M N) bytes / 3.35 TB/s.
// CD-DNN's layers at M = 1024 are bound by operations: 0.128 ms for each of
// the six 2048 x 2048 layers, 0.582 ms for 2048 -> 9304 and 0.028 ms for
// 440 -> 2048, 1.38 ms a forward pass.  This first kernel reaches a fraction
// of that; its times are in PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (repro_torch/kernels/build.py).  The C entry launches on the given stream,
// never synchronises, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 8;      // K slab depth
constexpr int kAPad = 4;    // A slab row padding (floats)

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads, 2)
blocked_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      float* __restrict__ c, int M, int N, int K) {
  constexpr int TM = BM / 16;                    // rows per thread
  constexpr int TN = BN / 16;                    // columns per thread
  constexpr int GM = TM / 4;                     // groups of 4 rows
  constexpr int GN = TN / 4;                     // groups of 4 columns
  constexpr int kALoads = BM * kBK / kThreads;   // A elements each thread loads
  constexpr int kBLoads = BN * kBK / kThreads;   // B elements each thread loads
  constexpr int kARowStep = kThreads / kBK;      // A rows one load round covers
  constexpr int kBRowStep = kThreads / BN;       // B rows one load round covers
  static_assert(TM % 4 == 0 && TN % 4 == 0, "micro-tile is whole groups of 4");
  static_assert(kARowStep * kALoads == BM, "A loader covers the slab");
  static_assert(kBRowStep * kBLoads == kBK, "B loader covers the slab");

  __shared__ __align__(16) float As[2][kBK][BM + kAPad];   // A slab, k-major
  __shared__ __align__(16) float Bs[2][kBK][BN];

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;

  // A loader: column a_k of the slab, rows a_r + 32 i; B loader: slab rows
  // b_k + kBRowStep i, column b_n.  Consecutive threads read consecutive
  // addresses of A (along k) and of B (along n).
  const int a_k = tid % kBK;
  const int a_r = tid / kBK;
  const int b_k = tid / BN;
  const int b_n = tid % BN;
  const bool b_col = n0 + b_n < N;

  float a_reg[kALoads], b_reg[kBLoads];
  auto load = [&](int k0) {
    const int k = k0 + a_k;
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      const long long row = m0 + a_r + kARowStep * i;
      a_reg[i] = (row < M && k < K) ? widen(a[row * K + k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int kb = k0 + b_k + kBRowStep * i;
      b_reg[i] = (b_col && kb < K)
                     ? widen(b[static_cast<long long>(kb) * N + n0 + b_n])
                     : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kALoads; ++i) As[buf][a_k][a_r + kARowStep * i] = a_reg[i];
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) Bs[buf][b_k + kBRowStep * i][b_n] = b_reg[i];
  };

  // Consumer: thread (ty, tx) owns rows  g * BM/GM + ty*4 + 0..3 (g < GM)
  //                             and cols g * BN/GN + tx*4 + 0..3 (g < GN).
  const int ty = tid / 16;
  const int tx = tid % 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int slabs = (K + kBK - 1) / kBK;
  load(0);
  for (int t = 0; t < slabs; ++t) {
    const int buf = t & 1;
    // Safe with one barrier: buffer buf was last read in iteration t - 2, and
    // every thread has left that iteration before any passes iteration t - 1's
    // barrier.
    store(buf);
    __syncthreads();
    if (t + 1 < slabs) load((t + 1) * kBK);   // in flight during the FFMAs
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&As[buf][kk][g * (BM / GM) + ty * 4]);
        av[4 * g] = v.x; av[4 * g + 1] = v.y; av[4 * g + 2] = v.z; av[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < GN; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[buf][kk][g * (BN / GN) + tx * 4]);
        bv[4 * g] = v.x; bv[4 * g + 1] = v.y; bv[4 * g + 2] = v.z; bv[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  const bool vec = (N % 4) == 0;   // rows of C start 16-byte aligned
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long row = m0 + (i / 4) * (BM / GM) + ty * 4 + (i % 4);
    if (row >= M) continue;
#pragma unroll
    for (int g = 0; g < GN; ++g) {
      const int col = n0 + g * (BN / GN) + tx * 4;
      float* o = c + row * N + col;
      if (vec && col + 4 <= N) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < N) o[j] = acc[i][4 * g + j];
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int M, int N, int K, int bm, int bn,
           cudaStream_t stream) {
  const auto* pa = static_cast<const T*>(a);
  const auto* pb = static_cast<const T*>(b);
  auto* pc = static_cast<float*>(c);
  const dim3 grid(static_cast<unsigned>((N + bn - 1) / bn), static_cast<unsigned>((M + bm - 1) / bm));
  if (bm == 128 && bn == 128) {
    blocked_matmul_kernel<T, 128, 128><<<grid, kThreads, 0, stream>>>(pa, pb, pc, M, N, K);
  } else if (bm == 128 && bn == 64) {
    blocked_matmul_kernel<T, 128, 64><<<grid, kThreads, 0, stream>>>(pa, pb, pc, M, N, K);
  } else if (bm == 64 && bn == 128) {
    blocked_matmul_kernel<T, 64, 128><<<grid, kThreads, 0, stream>>>(pa, pb, pc, M, N, K);
  } else if (bm == 64 && bn == 64) {
    blocked_matmul_kernel<T, 64, 64><<<grid, kThreads, 0, stream>>>(pa, pb, pc, M, N, K);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
