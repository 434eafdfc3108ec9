// Paged-decode attention for NVIDIA Hopper (sm_90a).
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
// Design, and what changed from the TPU kernel:
//   * The TPU walks a sequential grid axis over a request's logical pages and
//     carries m/l/acc in VMEM scratch from one grid step to the next.  Here
//     blocks run in no order, so the page walk is a loop inside one block.
//   * The TPU's scalar-prefetch index map becomes the block reading its own
//     page_table[b, i].
//   * One block per (request b, kv head).  Its g = Hq/Hkv query heads share
//     every K/V row the block reads, so each page is read from device memory
//     once, not g times (the Pallas body repeats K/V g-fold in VMEM).
//   * A page with no valid position (past length, or wholly older than the
//     window) is skipped before anything of it is loaded; within a page only
//     the valid rows are read.
//   * Scores: each warp takes whole token rows of the page; its lanes split D
//     and a shuffle reduction finishes each of the g dot products.  Softmax
//     statistics: one thread per query head.  P @ V: each thread owns D
//     columns (all g heads of them), so every V element is read once.
//
// Bound on this card: bytes.  One call must read the K and V row of every
// position it attends, 2 * sum_b attended_b * Hkv * D * sizeof(T), and
// does about 4 * Hq * D operations per attended row - far below the
// operations-per-byte of an H100 - so the least time is those bytes over
// 3.35 TB/s.  No wgmma, TMA or split over pages yet: with B * Hkv blocks
// (32 at the serving shapes) most SMs idle and launch latency is a large part
// of a call; see PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (repro_torch/kernels/build.py).  The C entry launches on the given stream,
// never synchronises, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDPerLane = 8;   // D <= 256
constexpr int kMaxAcc = 32;       // g * ceil(D / kThreads) accumulators per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pages_k,
                    const T* __restrict__ pages_v, const int* __restrict__ page_table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int num_pages, int Hq, int Hkv, int D, int ps, int n,
                    int window, float softcap, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;            // (g, D) scaled query heads
  float* s_s = q_s + g * D;     // (g, ps) scores, then probabilities
  float* m_s = s_s + g * ps;    // (g,) running max
  float* l_s = m_s + g;         // (g,) running sum
  float* a_s = l_s + g;         // (g,) rescale factor of this page

  const T* qb = q + ((size_t)b * Hq + (size_t)kvh * g) * D;
  for (int i = tid; i < g * D; i += kThreads) q_s[i] = to_f32(qb[i]) * scale;
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;
  const int ncols = (D + kThreads - 1) / kThreads;
  const int nd = D / 32;
  const int length = lengths[b];
  const int oldest = length - 1 - window;  // with window > 0: valid iff pos > oldest
  const size_t row = (size_t)Hkv * D;      // elements between a page's token rows
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    const int start = i * ps;
    if (start >= length) break;                            // this and later pages empty
    if (window > 0 && start + ps - 1 <= oldest) continue;  // wholly outside the window
    const int page = page_table[(size_t)b * n + i];
    if (page < 0 || page >= num_pages) __trap();           // as an out-of-range gather
    const size_t base = (size_t)page * ps * row + (size_t)kvh * D;
    const T* kp = pages_k + base;
    const T* vp = pages_v + base;
    const int t_lo = window > 0 ? max(0, oldest + 1 - start) : 0;
    const int t_hi = min(ps, length - start);              // valid rows: [t_lo, t_hi)

    // scores s[h, t] = softcap(q_h . k_t), -1e30 outside the valid rows
    for (int t = warp; t < ps; t += kWarps) {
      if (t < t_lo || t >= t_hi) {
        for (int h = lane; h < g; h += 32) s_s[h * ps + t] = kNegInf;
        continue;
      }
      float kr[kMaxDPerLane];
#pragma unroll
      for (int j = 0; j < kMaxDPerLane; ++j)
        kr[j] = j < nd ? to_f32(kp[t * row + lane + 32 * j]) : 0.f;
      for (int h = 0; h < g; ++h) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxDPerLane; ++j)
          if (j < nd) part += q_s[h * D + lane + 32 * j] * kr[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) {
          if (softcap > 0.f) part = tanhf(part / softcap) * softcap;
          s_s[h * ps + t] = part;
        }
      }
    }
    __syncthreads();

    // online-softmax statistics, one thread per query head
    if (tid < g) {
      float* s = s_s + tid * ps;
      float mx = kNegInf;
      for (int t = 0; t < ps; ++t) mx = fmaxf(mx, s[t]);
      const float m_prev = m_s[tid];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float p = expf(s[t] - m_new);
        s[t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * alpha + sum;
      a_s[tid] = alpha;
      m_s[tid] = m_new;
    }
    __syncthreads();

    // acc[h, d] = acc[h, d] * alpha[h] + sum_t p[h, t] * v[t, d]
    for (int c = 0; c < ncols; ++c) {
      const int d = tid + c * kThreads;
      if (d >= D) break;
      float* a = acc + c * g;
      for (int h = 0; h < g; ++h) a[h] *= a_s[h];
      for (int t = t_lo; t < t_hi; ++t) {
        const float v = to_f32(vp[t * row + d]);
        for (int h = 0; h < g; ++h) a[h] += s_s[h * ps + t] * v;
      }
    }
    __syncthreads();  // s_s and a_s are rewritten by the next page
  }

  T* ob = out + ((size_t)b * Hq + (size_t)kvh * g) * D;
  for (int c = 0; c < ncols; ++c) {
    const int d = tid + c * kThreads;
    if (d >= D) break;
    for (int h = 0; h < g; ++h) store(ob + h * D + d, acc[c * g + h] / fmaxf(l_s[h], 1e-30f));
  }
}

template <typename T>
void launch(const void* q, const void* pages_k, const void* pages_v,
            const void* page_table, const void* lengths, void* out, int B, int Hq,
            int Hkv, int D, int num_pages, int ps, int n, int window, float softcap,
            float scale, cudaStream_t stream) {
  const int g = Hq / Hkv;
  const size_t smem = sizeof(float) * ((size_t)g * D + (size_t)g * ps + 3 * (size_t)g);
  paged_decode_kernel<T><<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pages_k),
      static_cast<const T*>(pages_v), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<T*>(out), num_pages, Hq, Hkv, D,
      ps, n, window, softcap, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, both pools and out share it).
// The caller has checked shapes, D % 32 == 0, D <= 256, Hq % Hkv == 0,
// g * ceil(D / 128) <= 32 and the shared-memory size.
extern "C" int paged_decode_attention(const void* q, const void* pages_k,
                                      const void* pages_v, const void* page_table,
                                      const void* lengths, void* out, int B, int Hq,
                                      int Hkv, int D, int num_pages, int ps, int n,
                                      int window, float softcap, float scale, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch<__nv_bfloat16>(q, pages_k, pages_v, page_table, lengths, out, B, Hq, Hkv, D,
                          num_pages, ps, n, window, softcap, scale, s);
  else
    launch<float>(q, pages_k, pages_v, page_table, lengths, out, B, Hq, Hkv, D,
                  num_pages, ps, n, window, softcap, scale, s);
  return static_cast<int>(cudaGetLastError());
}
