// Paged-decode attention for NVIDIA Hopper (sm_90a), each request's pages
// split over blocks.
//
// Replaces the TPU kernel src/repro/kernels/paged_attn.py::paged_decode_attention
// (Pallas body _paged_kernel) and computes exactly what it computes: one decode
// token per request attends over that request's KV history, scattered across
// fixed-size pages of a physical pool and addressed through a page table.
//   scale = D**-0.5 applied to q in f32; tanh softcap when softcap > 0;
//   position p is valid iff p < length and, when window > 0,
//   p > length - 1 - window; masked logits are -1e30; online softmax with
//   m, l and acc in f32; output = acc / max(l, 1e-30) in q's dtype.
//
// Bound on this card: bytes.  One call must read the K and V row of every
// position it attends, 2 * sum_b attended_b * Hkv * D * sizeof(T), and does
// about 4 * Hq * D operations per attended row, far below an H100's
// operations per byte.  At the serving shapes (llama3-8b: 4 requests of up to
// 544 positions, 8 kv heads of 128) that is ~3.5 MB, ~1 us at 3.35 TB/s, so
// a call is set by how many bytes are in flight and by launch latency.
//
// Design (two launches a call):
//   * The TPU walks a sequential grid axis over a request's logical pages and
//     carries m/l/acc in VMEM from one grid step to the next.  The first
//     design here put that walk in one block per (kv head, request): 32
//     blocks on 132 SMs, a serial chain per page, 2 bytes a lane in flight.
//     Now each request's pages are split, flash-decoding style, over a grid
//     of (kv head x head group, request, split): split s takes pages
//     [s * pps, (s + 1) * pps), pps chosen by the wrapper so that the grid
//     fills the SMs several times (paged_attn.py's split_pages).
//   * A block serves one kv head and up to kMaxHeads = 8 of its g = Hq / Hkv
//     query heads, which share every K/V row it reads (so each row is read
//     from device memory once per call for g <= 8); the instance keeps
//     registers for H = 1, 2, 4 or 8 heads, the least that holds g.
//   * Only valid positions are touched: the block clips its split to
//     [max(0, length - window), length) before loading anything, so a page
//     with no valid position is never read (nor its page-table entry).
//   * Each lane holds 8 head-dim elements of a row (one 16-byte load for
//     bf16, two for f32, kept as loaded and widened to f32 where used); D / 8
//     lanes (rounded up to a power of two) take a row, so a warp load covers
//     32 / that rows.  A warp issues the K and V loads of kBatch such row
//     groups before it uses any of them, and reads the page-table entries of
//     its next batch while they are in flight.
//   * Scores are reduced with warp shuffles within a row's lanes; each warp
//     keeps its own online-softmax statistics and accumulators (m per warp,
//     l and acc per row group of lanes, summed at the end), so no
//     __syncthreads runs inside the walk.
//   * The block merges its warps through shared memory and writes the
//     split's partial (m, l, acc) in f32 to scratch that the wrapper
//     allocates; a second launch, one block per (request, query head), merges
//     the splits: M = max m_s, w_s = exp(m_s - M), out = sum w_s acc_s /
//     max(sum w_s l_s, 1e-30).  A split with no valid position writes
//     m = -1e30, l = 0, acc = 0, whose weight is 0 beside any valid split;
//     every request has one (length >= 1).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (repro_torch/kernels/build.py).  The C entry launches on the given stream,
// never synchronises, allocates nothing and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kE = 8;            // head-dim elements a lane holds of a row
constexpr int kMaxHeads = 8;     // query heads a block serves, at most
constexpr int kMaxD = 256;
constexpr int kBatch = 4;        // row groups a warp loads before it uses them
constexpr int kCombineThreads = 128;
constexpr int kMaxSplits = 4096;  // the combine keeps one weight a split in shared memory
constexpr float kNegInf = -1e30f;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// 8 consecutive elements of a row as loaded (16-byte aligned: D % 32 == 0):
// one 16-byte load for bf16, two for f32; widened to f32 where they are used
template <typename T>
struct Raw;
template <>
struct Raw<__nv_bfloat16> {
  uint4 a;
};
template <>
struct Raw<float> {
  float4 a, b;
};

__device__ __forceinline__ void load_raw(const __nv_bfloat16* p, Raw<__nv_bfloat16>& r) {
  r.a = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void load_raw(const float* p, Raw<float>& r) {
  r.a = reinterpret_cast<const float4*>(p)[0];
  r.b = reinterpret_cast<const float4*>(p)[1];
}
__device__ __forceinline__ void zero_raw(Raw<__nv_bfloat16>& r) { r.a = make_uint4(0, 0, 0, 0); }
__device__ __forceinline__ void zero_raw(Raw<float>& r) {
  r.a = r.b = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void widen(const Raw<__nv_bfloat16>& r, float (&x)[kE]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.a);
#pragma unroll
  for (int i = 0; i < kE / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void widen(const Raw<float>& r, float (&x)[kE]) {
  x[0] = r.a.x, x[1] = r.a.y, x[2] = r.a.z, x[3] = r.a.w;
  x[4] = r.b.x, x[5] = r.b.y, x[6] = r.b.z, x[7] = r.b.w;
}

// H: a power of two >= the block's query heads (registers for H heads)
template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ pages_k,
                   const T* __restrict__ pages_v, const int* __restrict__ page_table,
                   const int* __restrict__ lengths, float* __restrict__ part_ml,
                   float* __restrict__ part_acc, int num_pages, int Hq, int Hkv, int D,
                   int ps, int n, int pps, int window, float softcap, float scale) {
  const int g = Hq / Hkv;
  const int head_groups = (g + H - 1) / H;
  const int kvh = blockIdx.x / head_groups;
  const int h0 = kvh * g + (blockIdx.x % head_groups) * H;          // first query head
  const int gb = min(H, (kvh + 1) * g - h0);                        // heads of this block
  const int b = blockIdx.y, s = blockIdx.z, S = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = D / kE;                                      // lanes a row: 4..32
  const int Lp = L <= 4 ? 4 : L <= 8 ? 8 : L <= 16 ? 16 : 32;  // as a power of two
  const int R = 32 / Lp;                                     // rows a warp load
  const int sub = lane / Lp;                                 // this lane's row of the group
  const bool active = lane % Lp < L;
  const int d0 = (lane % Lp) * kE;

  extern __shared__ float smem[];
  float* q_s = smem;                         // (H, D) scaled query heads
  float* acc_s = q_s + H * D;                // (kWarps, H, D) each warp's acc
  float* m_s = acc_s + kWarps * H * D;       // (kWarps, H)
  float* l_s = m_s + kWarps * H;             // (kWarps, H)

  const T* qb = q + ((size_t)b * Hq + h0) * D;
  for (int i = tid; i < gb * D; i += kThreads) q_s[i] = to_f32(qb[i]) * scale;

  const int length = lengths[b];
  const int start = max(s * pps * ps, window > 0 ? max(0, length - window) : 0);
  const int end = min(min(s * pps + pps, n) * ps, length);   // valid: [start, end)
  const int n_groups = end > start ? (end - start + R - 1) / R : 0;
  const size_t row = (size_t)Hkv * D;                        // elements between rows
  const int* ptb = page_table + (size_t)b * n;

  float m[H], l[H], acc[H][kE];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[h][e] = 0.f;
  }
  __syncthreads();   // q_s

  // page of each of this lane's kBatch rows, read one batch ahead
  auto page_of = [&](int rg, int u) {
    const int pos = start + (rg + u * kWarps) * R + sub;
    return pos < end ? ptb[pos / ps] : 0;
  };
  int page[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) page[u] = page_of(warp, u);

  for (int rg = warp; rg < n_groups; rg += kWarps * kBatch) {
    Raw<T> kr[kBatch], vr[kBatch];
    bool valid[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int pos = start + (rg + u * kWarps) * R + sub;
      valid[u] = pos < end;
      if (valid[u] && active) {
        if (page[u] < 0 || page[u] >= num_pages) __trap();   // as an out-of-range gather
        const size_t off = ((size_t)page[u] * ps + pos % ps) * row + (size_t)kvh * D + d0;
        load_raw(pages_k + off, kr[u]);
        load_raw(pages_v + off, vr[u]);
      } else {
        zero_raw(kr[u]);
        zero_raw(vr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) page[u] = page_of(rg + kWarps * kBatch, u);

    // scores of every head, then each head's online-softmax step
    float sc[H][kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      float k[kE];
      widen(kr[u], k);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (h >= gb) break;
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) part += active ? q_s[h * D + d0 + e] * k[e] : 0.f;
        for (int off = Lp / 2; off > 0; off >>= 1) part += __shfl_xor_sync(kAll, part, off);
        if (softcap > 0.f) part = tanhf(part / softcap) * softcap;
        sc[h][u] = valid[u] ? part : kNegInf;
      }
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
      if (h >= gb) break;
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) mx = fmaxf(mx, sc[h][u]);
      for (int off = Lp; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, off));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = expf(m[h] - m_new);
      m[h] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        sc[h][u] = valid[u] ? expf(sc[h][u] - m_new) : 0.f;
        psum += sc[h][u];
      }
      l[h] = l[h] * alpha + psum;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[h][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      float v[kE];
      widen(vr[u], v);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (h >= gb) break;
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[h][e] += sc[h][u] * v[e];
      }
    }
  }

  // the warp's row groups share m: sum their l and acc, then merge the warps
#pragma unroll
  for (int h = 0; h < H; ++h) {
    if (h >= gb) break;
    for (int off = Lp; off < 32; off <<= 1) {
      l[h] += __shfl_xor_sync(kAll, l[h], off);
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[h][e] += __shfl_xor_sync(kAll, acc[h][e], off);
    }
    if (lane < L) {
#pragma unroll
      for (int e = 0; e < kE; ++e) acc_s[(warp * H + h) * D + d0 + e] = acc[h][e];
    }
    if (lane == 0) {
      m_s[warp * H + h] = m[h];
      l_s[warp * H + h] = l[h];
    }
  }
  __syncthreads();
  for (int i = tid; i < gb * D; i += kThreads) {
    const int h = i / D;
    float M = m_s[h];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, m_s[w * H + h]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w * H + h] - M);
      a += c * acc_s[w * H * D + i];
      lsum += c * l_s[w * H + h];
    }
    const size_t r = ((size_t)b * Hq + h0 + h) * S + s;     // (b, query head, split)
    part_acc[r * D + i % D] = a;
    if (i % D == 0) {
      part_ml[2 * r] = M;
      part_ml[2 * r + 1] = lsum;
    }
  }
}

// one block per (request, query head): merge its S splits
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
paged_combine_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                     T* __restrict__ out, int D, int S) {
  extern __shared__ float w_s[];               // (S,) each split's weight
  __shared__ float red[kCombineThreads / 32];
  const size_t r = blockIdx.x;                 // b * Hq + query head
  const float* ml = part_ml + r * S * 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float M = kNegInf;
  for (int s = tid; s < S; s += kCombineThreads) M = fmaxf(M, ml[2 * s]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(kAll, M, off));
  if (lane == 0) red[warp] = M;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kCombineThreads / 32; ++w) M = fmaxf(M, red[w]);
  __syncthreads();                             // red is reused below
  float lsum = 0.f;
  for (int s = tid; s < S; s += kCombineThreads) {
    w_s[s] = expf(ml[2 * s] - M);
    lsum += w_s[s] * ml[2 * s + 1];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) lsum += __shfl_xor_sync(kAll, lsum, off);
  if (lane == 0) red[warp] = lsum;
  __syncthreads();
  lsum = 0.f;
#pragma unroll
  for (int w = 0; w < kCombineThreads / 32; ++w) lsum += red[w];
  const float* acc = part_acc + r * S * D;
  for (int d = tid; d < D; d += kCombineThreads) {
    float a = 0.f;
    for (int s = 0; s < S; ++s) a += w_s[s] * acc[(size_t)s * D + d];
    store(out + r * D + d, a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int H>
void launch(const void* q, const void* pages_k, const void* pages_v, const void* page_table,
            const void* lengths, float* part_ml, float* part_acc, void* out, int B, int Hq,
            int Hkv, int D, int num_pages, int ps, int n, int pps, int window, float softcap,
            float scale, cudaStream_t stream) {
  const int g = Hq / Hkv;
  const int S = (n + pps - 1) / pps;
  const dim3 grid(Hkv * ((g + H - 1) / H), B, S);
  const size_t smem = sizeof(float) * ((size_t)(1 + kWarps) * H * D + 2 * kWarps * H);
  paged_split_kernel<T, H><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pages_k), static_cast<const T*>(pages_v),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths), part_ml, part_acc,
      num_pages, Hq, Hkv, D, ps, n, pps, window, softcap, scale);
  paged_combine_kernel<T><<<B * Hq, kCombineThreads, sizeof(float) * S, stream>>>(
      part_ml, part_acc, static_cast<T*>(out), D, S);
}

template <typename T>
void launch_heads(const void* q, const void* pages_k, const void* pages_v,
                  const void* page_table, const void* lengths, float* part_ml, float* part_acc,
                  void* out, int B, int Hq, int Hkv, int D, int num_pages, int ps, int n,
                  int pps, int window, float softcap, float scale, cudaStream_t stream) {
  const int g = Hq / Hkv;
  auto go = [&](auto heads) {
    launch<T, decltype(heads)::value>(q, pages_k, pages_v, page_table, lengths, part_ml,
                                      part_acc, out, B, Hq, Hkv, D, num_pages, ps, n, pps,
                                      window, softcap, scale, stream);
  };
  if (g == 1)
    go(std::integral_constant<int, 1>());
  else if (g == 2)
    go(std::integral_constant<int, 2>());
  else if (g <= 4)
    go(std::integral_constant<int, 4>());
  else
    go(std::integral_constant<int, kMaxHeads>());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, both pools and out share it).
// scratch: B * Hq * S * (2 + D) floats, S = ceil(n / pages_per_split): the
// splits' (m, l) pairs, then their acc rows.  The caller has checked shapes,
// Hq % Hkv == 0, D % 32 == 0, D <= 256 and the pools' 16-byte alignment.
extern "C" int paged_decode_attention(const void* q, const void* pages_k, const void* pages_v,
                                      const void* page_table, const void* lengths,
                                      void* scratch, void* out, int B, int Hq, int Hkv, int D,
                                      int num_pages, int ps, int n, int pages_per_split,
                                      int window, float softcap, float scale, int dtype,
                                      void* stream) {
  if (B < 1 || B > 65535 || Hkv < 1 || Hq % Hkv || D % 32 || D > kMaxD || ps < 1 || n < 1 ||
      pages_per_split < 1 || (n + pages_per_split - 1) / pages_per_split > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t rows = (size_t)B * Hq * ((n + pages_per_split - 1) / pages_per_split);
  float* part_ml = static_cast<float*>(scratch);
  float* part_acc = part_ml + 2 * rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch_heads<__nv_bfloat16>(q, pages_k, pages_v, page_table, lengths, part_ml, part_acc,
                                out, B, Hq, Hkv, D, num_pages, ps, n, pages_per_split, window,
                                softcap, scale, s);
  else
    launch_heads<float>(q, pages_k, pages_v, page_table, lengths, part_ml, part_acc, out, B,
                        Hq, Hkv, D, num_pages, ps, n, pages_per_split, window, softcap, scale,
                        s);
  return static_cast<int>(cudaGetLastError());
}
