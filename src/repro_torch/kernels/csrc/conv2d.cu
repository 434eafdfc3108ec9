// Direct NHWC x HWIO convolution for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel src/repro/kernels/conv2d.py::conv2d_nhwc (Pallas body
// _conv_kernel) and computes what it computes:
//   out[n, oh, ow, f] = sum_{kh, kw, c} xpad[n, oh*s + kh, ow*s + kw, c] * w[kh, kw, c, f]
// in f32, for any square kernel K, stride s and symmetric zero pad p; xpad is x
// with p zeros on each side of H and W.
//
// Design, and what changed from the TPU kernel:
//   * The conv is an implicit GEMM.  Rows are the M = N*OH*OW output pixels,
//     columns the F output channels, and the reduction runs over
//     K_gemm = K*K*C taps ordered (kh, kw, c).  HWIO weights already are the
//     row-major (K_gemm, F) B matrix.  A's rows are gathered from NHWC x on the
//     fly; with channels innermost, consecutive k of one row are consecutive
//     addresses whenever they share a tap (kh, kw).
//   * The products run on the tensor cores as 3xTF32 (each operand split into
//     a tf32 hi and lo, three wgmma products a k8 step, f32 accumulation),
//     through the mainloop this kernel shares with the blocked GEMM
//     (gemm_tf32x3.cuh, which states the layout, the loads and the pipeline).
//     Only the loader of A's rows is the conv's own (Im2colRows below).
//   * Zero padding is a predicate on each gathered chunk: nothing padded is
//     written to device memory (the TPU wrapper pads x with jnp.pad first).
//   * The TPU grid carries a resident output block across its sequential ifm
//     axis.  Here blocks run in no order, so each block owns one 128 x BN tile
//     of the output (BN = 128 where F >= 128, else 64) and loops over the whole
//     reduction itself, 16 taps a shared-memory stage (32 at BN = 128).
//   * With C % 4 == 0 (every layer but the first of VGG-A and OverFeat-FAST)
//     four consecutive taps are one 16-byte load of x; with C = 3 (VGG-A conv1:
//     K_gemm = 27; OverFeat conv1: 11x11, stride 4, K_gemm = 363) each tap is
//     its own 4-byte load, and the reduction's ragged end loads zeros.
//   * Offsets into x and out are 64-bit: at batch 64 VGG-A conv1's output
//     alone holds 205 M elements.
//
// Bound on this card, per call: the larger of
//   3 x 2 * N*OH*OW * F * K*K*C tf32 operations / 494.7 TFLOP/s (the data
//   sheet's dense TF32 rate) and
//   4 B * (|x| + |w| + |out|) / 3.35 TB/s.
// At batch 64 VGG-A conv1 (C = 3) is bound by bytes, about 0.25 ms; its other
// seven conv layers are bound by operations, about 5.8 ms for all eight per
// forward pass (14.4 ms at the 67 TFLOP/s of f32 outside the tensor cores,
// which bounded the FFMA kernel this one replaces).  Its times are in PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (repro_torch/kernels/build.py).  The C entry launches on the given stream,
// never synchronises, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "gemm_tf32x3.cuh"

namespace {

constexpr int kBM = 128;            // output pixels per block
constexpr int kNoRow = -(1 << 30);  // input row of a pixel past M: never inside the image

// A's rows gathered from NHWC x: row m is output pixel (n, oh, ow), depth k
// the tap (kh, kw, c) with k = (kh K + kw) C + c.  This thread loads the
// chunk of 4 taps from depth k of pixels m_first + step i.
template <int LOADS>
struct Im2colRows {
  const float* x;
  int H, W, C, K, Kg;
  bool vec;   // C % 4 == 0 and x 16-byte aligned: a chunk is one 16-byte load
  long long img[LOADS];   // offset of the pixel's image
  int ih0[LOADS], iw0[LOADS];   // its top-left input corner, kNoRow past M

  __device__ __forceinline__ Im2colRows(const float* x_, int H_, int W_, int C_, int K_,
                                        int stride, int pad, int OH, int OW, long long M,
                                        bool vec_, long long m_first, int step)
      : x(x_), H(H_), W(W_), C(C_), K(K_), Kg(K_ * K_ * C_), vec(vec_) {
    const long long ohw = static_cast<long long>(OH) * OW;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const long long m = m_first + static_cast<long long>(step) * i;
      if (m < M) {
        const long long n = m / ohw;
        const int rem = static_cast<int>(m - n * ohw);
        const int oh = rem / OW, ow = rem - (rem / OW) * OW;
        img[i] = n * H * W * C;
        ih0[i] = oh * stride - pad;
        iw0[i] = ow * stride - pad;
      } else {
        img[i] = 0;
        ih0[i] = kNoRow;
        iw0[i] = 0;
      }
    }
  }

  // x at tap (kh, kw, c) of the thread's pixel i, or null in the padding
  __device__ __forceinline__ const float* at(int i, int kh, int kw, int c) const {
    const int ih = ih0[i] + kh, iw = iw0[i] + kw;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) return nullptr;
    return x + img[i] + (static_cast<long long>(ih) * W + iw) * C + c;
  }

  __device__ __forceinline__ void load(int k, uint4 (&out)[LOADS]) const {
    if (vec) {   // the 4 taps share (kh, kw): k % 4 == 0 and C % 4 == 0
      const int r = k / C, c = k - (k / C) * C, kh = r / K, kw = r - (r / K) * K;
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const float* p = k < Kg ? at(i, kh, kw, c) : nullptr;
        out[i] = p ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
      }
    } else {
      uint32_t v[LOADS][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k + j;
        const int r = kj / C, c = kj - (kj / C) * C, kh = r / K, kw = r - (r / K) * K;
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
          const float* p = kj < Kg ? at(i, kh, kw, c) : nullptr;
          v[i][j] = p ? __float_as_uint(__ldg(p)) : 0u;
        }
      }
#pragma unroll
      for (int i = 0; i < LOADS; ++i) out[i] = make_uint4(v[i][0], v[i][1], v[i][2], v[i][3]);
    }
  }
};

template <int BN>
__global__ void __launch_bounds__(tc_gemm::kThreads, (tc_gemm::Cfg<float, kBM, BN>::MIN_CTAS))
conv2d_nhwc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int H, int W, int C, int K, int F, int stride,
                   int pad, int OH, int OW, long long M, int vec) {
  extern __shared__ __align__(1024) uint8_t smem[];
  using Cf = tc_gemm::Cfg<float, kBM, BN>;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * BN;
  const Im2colRows<Cf::A_LOADS> rows(x, H, W, C, K, stride, pad, OH, OW, M, vec != 0,
                                     m0 + threadIdx.x / Cf::CHUNKS, Cf::A_ROW_STEP);
  tc_gemm::tile<float, kBM, BN>(smem, rows, w, out, M, F, K * K * C, m0, n0);
}

}  // namespace

// x (N, H, W, C), w (K, K, C, F) and out (N, OH, OW, F): contiguous float32 on
// the device.  The caller has checked the shapes, that OH = (H + 2 pad - K) /
// stride + 1 and OW likewise are >= 1, and that ceil(N*OH*OW / 128) fits the
// grid's x dimension.
extern "C" int conv2d_nhwc_f32(const void* x, const void* w, void* out, int N, int H,
                               int W, int C, int K, int F, int stride, int pad, int OH,
                               int OW, void* stream) {
  const long long M = static_cast<long long>(N) * OH * OW;
  const auto* px = static_cast<const float*>(x);
  const auto* pw = static_cast<const float*>(w);
  auto* po = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const unsigned m_tiles = static_cast<unsigned>((M + kBM - 1) / kBM);
  if (F >= 128) {
    return tc_gemm::launch<float, kBM, 128>(conv2d_nhwc_kernel<128>,
                                            dim3(m_tiles, (F + 127) / 128), s, px, pw, po, H,
                                            W, C, K, F, stride, pad, OH, OW, M, vec);
  }
  return tc_gemm::launch<float, kBM, 64>(conv2d_nhwc_kernel<64>, dim3(m_tiles, (F + 63) / 64), s,
                                         px, pw, po, H, W, C, K, F, stride, pad, OH, OW, M, vec);
}
