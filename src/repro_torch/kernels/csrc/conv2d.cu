// Direct NHWC x HWIO convolution for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel src/repro/kernels/conv2d.py::conv2d_nhwc (Pallas body
// _conv_kernel) and computes exactly what it computes:
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
//   * Zero padding is a predicate on each gathered element: nothing padded is
//     written to device memory (the TPU wrapper pads x with jnp.pad first).
//   * The TPU grid carries a resident output block across its sequential ifm
//     axis.  Here blocks run in no order, so each block owns one 128 x 64 tile
//     of the output and loops over the whole reduction itself, 16 taps at a
//     time: an A slice (128 x 16) and a B slice (16 x 64) in shared memory,
//     double-buffered, with the next slice's global loads in registers while
//     the current one is consumed.  256 threads; each keeps an 8 x 4 block of
//     the output in f32 registers and does 32 FFMAs per tap.
//   * Ragged edges (M, F and K_gemm not multiples of the tile: VGG-A conv1 has
//     K_gemm = 27, OverFeat conv1 F = 96) are predicated loads of 0 and
//     predicated stores.
//   * Offsets into x and out are 64-bit: at batch 64 VGG-A conv1's output
//     alone holds 205 M elements.
//   * Plain f32 FFMA: no wgmma, TMA or TF32, which would round the inputs to
//     10 mantissa bits and no longer match the f32 reference.
//
// Bound on this card, per call: the larger of
//   2 * N*OH*OW * F * K*K*C operations / 67 TFLOP/s (f32 outside the tensor cores)
//   4 B * (|x| + |w| + |out|) / 3.35 TB/s.
// At batch 64 VGG-A conv1 (C = 3) is bound by bytes, about 0.25 ms against
// 0.17 ms of operations; its other seven conv layers are bound by operations,
// and the FLOP bound of all eight is about 14.3 ms per forward pass.  This
// first kernel reaches a fraction of that; its times are in PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (repro_torch/kernels/build.py).  The C entry launches on the given stream,
// never synchronises, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;           // output pixels per block
constexpr int kBN = 64;            // output channels per block
constexpr int kBK = 16;            // reduction taps per shared-memory slice
constexpr int kThreads = 256;
constexpr int kTM = 8;             // pixels per thread
constexpr int kTN = 4;             // channels per thread
constexpr int kAPad = 4;           // keeps A rows 16-byte aligned, halves store conflicts
constexpr int kARows = kBM * kBK / kThreads;   // A elements each thread loads: 8
constexpr int kBRows = kBK * kBN / kThreads;   // B elements each thread loads: 4
constexpr int kNoRow = -(1 << 30); // input row of a pixel past M: never inside the image

static_assert(kBM == (kThreads / kBK) * kARows, "A loader covers the tile");
static_assert(kBK == (kThreads / kBN) * kBRows, "B loader covers the tile");
static_assert((kBM / kTM) * (kBN / kTN) == kThreads, "micro-tiles cover the tile");

__global__ void __launch_bounds__(kThreads, 2)
conv2d_nhwc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int H, int W, int C, int K, int F,
                   int stride, int pad, int OH, int OW, long long M) {
  __shared__ __align__(16) float As[2][kBK][kBM + kAPad];   // A slice, k-major
  __shared__ __align__(16) float Bs[2][kBK][kBN];

  const int tid = threadIdx.x;
  const int Kg = K * K * C;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // A loader: tap column a_k of the slice, pixel rows a_r + 16 i.  Each
  // pixel's image offset and top-left input corner are fixed for the block.
  const int a_k = tid % kBK;
  const int a_r = tid / kBK;
  long long a_img[kARows];
  int a_ih[kARows], a_iw[kARows];
  const long long ohw = static_cast<long long>(OH) * OW;
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const long long m = m0 + a_r + (kThreads / kBK) * i;
    if (m < M) {
      const long long n = m / ohw;
      const int rem = static_cast<int>(m - n * ohw);
      const int oh = rem / OW, ow = rem - (rem / OW) * OW;
      a_img[i] = n * H * W * C;
      a_ih[i] = oh * stride - pad;
      a_iw[i] = ow * stride - pad;
    } else {
      a_img[i] = 0;
      a_ih[i] = kNoRow;
      a_iw[i] = 0;
    }
  }
  // B loader: reduction rows b_k + 4 i, output channel b_n.
  const int b_k = tid / kBN;
  const int b_n = tid % kBN;
  const bool b_col = n0 + b_n < F;

  float a_reg[kARows], b_reg[kBRows];
  auto load = [&](int k0) {
    const int k = k0 + a_k;
    const bool k_in = k < Kg;
    int c = 0, kh = 0, kw = 0;
    if (k_in) {
      const int r = k / C;
      c = k - r * C;
      kh = r / K;
      kw = r - kh * K;
    }
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int ih = a_ih[i] + kh, iw = a_iw[i] + kw;
      const bool in = k_in && ih >= 0 && ih < H && iw >= 0 && iw < W;
      a_reg[i] = in ? __ldg(x + a_img[i] + (static_cast<long long>(ih) * W + iw) * C + c)
                    : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBRows; ++i) {
      const int kb = k0 + b_k + (kThreads / kBN) * i;
      b_reg[i] = (b_col && kb < Kg)
                     ? __ldg(w + static_cast<long long>(kb) * F + n0 + b_n)
                     : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kARows; ++i) As[buf][a_k][a_r + (kThreads / kBK) * i] = a_reg[i];
#pragma unroll
    for (int i = 0; i < kBRows; ++i) Bs[buf][b_k + (kThreads / kBN) * i][b_n] = b_reg[i];
  };

  // Consumer: thread (ty, tx) owns pixels ty*8 .. +7 and channels tx*4 .. +3.
  const int ty = tid / (kBN / kTN);
  const int tx = tid % (kBN / kTN);
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int tiles = (Kg + kBK - 1) / kBK;
  load(0);
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    // Safe with one barrier: buffer buf was last read in iteration t - 2, and
    // every thread has left that iteration before any passes iteration t - 1's
    // barrier.
    store(buf);
    __syncthreads();
    if (t + 1 < tiles) load((t + 1) * kBK);   // in flight during the FFMAs
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * kTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * kTM + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * kTN]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }

  const int col = n0 + tx * kTN;
  const bool vec = (F % 4 == 0) && (col + kTN <= F);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + ty * kTM + i;
    if (m >= M) break;
    float* o = out + m * F + col;
    if (vec) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (col + j < F) o[j] = acc[i][j];
    }
  }
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
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>((F + kBN - 1) / kBN));
  conv2d_nhwc_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out),
      H, W, C, K, F, stride, pad, OH, OW, M);
  return static_cast<int>(cudaGetLastError());
}
