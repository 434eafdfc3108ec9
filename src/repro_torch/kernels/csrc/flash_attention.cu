// Flash attention (forward) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (Pallas body _flash_kernel) and computes what it computes:
//   out[b,i,h,:] = sum_j softmax_j(mask(cap(scale * q[b,i,h] . k[b,j,h/g]))) v[b,j,h/g]
// with g = Hq / Hkv (GQA), q widened to f32 and multiplied by scale before the
// product; cap(s) = tanh(s / softcap) * softcap when softcap > 0, before the
// mask; the mask keeps k_pos <= q_pos when causal and k_pos > q_pos - window
// when window > 0, with q_pos = i + Skv - Sq (queries right-aligned against the
// keys); masked scores are -1e30, never -inf; an online softmax carries the
// running max m, denominator l and accumulator in f32 over the KV tiles; the
// output is acc / max(l, 1e-30), written once in q's type.
//
// Design, and what changed from the TPU kernel:
//   * The TPU walks a sequential kv grid axis and carries m, l and acc in VMEM
//     scratch from one grid step to the next.  Hopper blocks run in no order, so
//     one block owns (batch b, q head h, a 64-row q tile) and loops over the KV
//     tiles itself; m, l and the (64, D) accumulator stay in registers the whole
//     time (4 rows x D/16 columns a thread, 256 threads).
//   * The 16 threads that share a row group are one half-warp, so each row's max
//     and sum are butterfly shuffles, identical in all 16 lanes: the scores never
//     leave registers; only the probabilities go to shared memory for P @ V.
//   * Tiles in shared memory, f32: scaled q (64 x D), the K tile transposed
//     (D x BKV) and the V tile (BKV x D), rows padded by one word so that no
//     access conflicts on a bank.  BKV = 64, and 32 at D = 256 (140 KB of shared
//     memory, under the 227 KB a block may have; set with cudaFuncSetAttribute).
//   * A KV tile with no live (q, k) pair for any row of the block (past the
//     causal frontier, or wholly older than the window) is skipped before it is
//     loaded, as the TPU kernel's pl.when(needed) does.  A row that is wholly
//     masked inside a live tile takes p = exp(-1e30 - m) = 0 once it has a live
//     key, or weights exp(0) = 1 that the next live key's alpha = exp(-1e30 - m)
//     = 0 wipes exactly: that holds only because the fill is finite.
//   * Unlike the TPU kernel, Sq and Skv need not be multiples of a tile: rows
//     past Sq are computed on zeros and not stored; keys past Skv load as zeros
//     and take p = 0.
//
// Bound on this card: operations.  One call does 4 * B * Hq * D flops per live
// (q, k) pair (about half of Sq * Skv under causal masking) and moves q, k, v in
// and o out once, so at D = 256 it does ~1000 flops per byte, above the card's
// ridge in every type.  The least time is those flops at the bf16 tensor-core
// peak (989 TFLOP/s); this first kernel computes in f32 FFMA (67 TFLOP/s), so
// its own ceiling is ~15x that.  No wgmma, TMA, cp.async or warp specialisation
// yet: that is the redesign's work (see PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (repro_torch/kernels/build.py).  The C entry launches on the given stream,
// never synchronises, allocates nothing and returns the CUDA error of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;      // query rows per block
constexpr int kRows = 4;     // rows per thread
constexpr int kLanes = 16;   // threads per row group: one half-warp
constexpr float kNegInf = -1e30f;

static_assert(kThreads == kLanes * kBQ / kRows, "one thread per (row group, lane)");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// xor offsets below 16 stay inside each half-warp; every lane ends with the
// same value (each butterfly stage adds or compares the same two operands)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr int kv_tile() { return D >= 256 ? 32 : 64; }

template <int D, int BKV>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)kBQ * (D + 1) + (size_t)D * (BKV + 1) + (size_t)BKV * D + (size_t)kBQ * (BKV + 1));
}

template <typename T, int D, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int Sq, int Skv, int Hq, int Hkv, int causal, int window,
             float softcap, float scale) {
  constexpr int NC = BKV / kLanes;  // score columns per thread
  constexpr int ND = D / kLanes;    // output columns per thread
  constexpr int QS = D + 1;         // padded row strides
  constexpr int KS = BKV + 1;
  extern __shared__ float smem[];
  float* q_s = smem;              // (kBQ, QS)  scale * q
  float* k_s = q_s + kBQ * QS;    // (D, KS)    K tile, transposed
  float* v_s = k_s + D * KS;      // (BKV, D)   V tile
  float* p_s = v_s + BKV * D;     // (kBQ, KS)  probabilities

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / kLanes;    // this thread's rows: ty * kRows + i
  const int tx = tid % kLanes;
  const int shift = Skv - Sq;     // q_pos = row + shift
  const int rows = min(kBQ, Sq - q0);
  const int pos_lo = q0 + shift, pos_hi = q0 + rows - 1 + shift;

  const size_t q_row = (size_t)Hq * D;   // elements between two positions of q / out
  const size_t k_row = (size_t)Hkv * D;  // ... of k / v
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * Skv * k_row + (size_t)hk * D;
  const T* vb = v + (size_t)b * Skv * k_row + (size_t)hk * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_s[r * QS + d] = r < rows ? to_f32(qb[(size_t)(q0 + r) * q_row + d]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][ND];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Skv; k0 += BKV) {
    if (causal && k0 > pos_hi) break;                          // past the causal frontier
    const int kk = min(BKV, Skv - k0);                         // keys in this tile
    if (window > 0 && k0 + kk - 1 <= pos_lo - window) continue;  // older than the window
    __syncthreads();  // q_s written; the previous tile's k_s, v_s, p_s read
    for (int i = tid; i < BKV * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const size_t off = (size_t)(k0 + c) * k_row + d;
      k_s[d * KS + c] = c < kk ? to_f32(kb[off]) : 0.f;
      v_s[c * D + d] = c < kk ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[kRows][NC];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qr[kRows], kc[NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qr[i] = q_s[(ty * kRows + i) * QS + d];
#pragma unroll
      for (int j = 0; j < NC; ++j) kc[j] = k_s[d * KS + tx + kLanes * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int qp = q0 + r + shift;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = tx + kLanes * j;
        const int kp = k0 + c;
        float x = s[i][j];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const bool keep = (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
        s[i][j] = keep ? x : kNegInf;
        if (c < kk) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = tx + kLanes * j;
        const float p = c < kk ? expf(s[i][j] - m_new) : 0.f;
        p_s[r * KS + c] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kk; ++c) {
      float pr[kRows], vc[ND];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pr[i] = p_s[(ty * kRows + i) * KS + c];
#pragma unroll
      for (int j = 0; j < ND; ++j) vc[j] = v_s[c * D + tx + kLanes * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(pr[i], vc[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (r >= rows) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + (size_t)b * Sq * q_row + (size_t)(q0 + r) * q_row + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) store(o + tx + kLanes * j, acc[i][j] * inv_l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
           int Hq, int Hkv, int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  constexpr int BKV = kv_tile<D>();
  constexpr size_t smem = smem_bytes<D, BKV>();
  auto kernel = flash_kernel<T, D, BKV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, Hq, Hkv, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
             int Hq, int Hkv, int D, int causal, int window, float softcap, float scale,
             cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, softcap, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, softcap, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, softcap, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, softcap, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  q and out are
// (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), all contiguous.  The caller has
// checked shapes, Hq % Hkv == 0, D in {32, 64, 128, 256}, B and Hq <= 65535,
// and Sq <= Skv when causal.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                               int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
                               float softcap, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal, window, softcap,
                                   scale, s);
  return dispatch<float>(q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, scale, s);
}
