// The compressed wire formats of the paper's §3.4 ring for NVIDIA Hopper
// (sm_90a), f32 messages in, int8 or sparse messages out.
//
// Replaces the TPU kernels of src/repro/kernels/ring.py:
//   int8_quantize   (Pallas body _int8_quantize_kernel)  s = max|x|/127, q = round(x/s)
//   ring_hop_int8   (Pallas body _hop_int8_kernel)       q'(s') of q*s + chunks[c]
//   ring_hop_topk   (Pallas body _hop_topk_kernel)       zeros.at[idx].add(vals) + chunks[c]
//
// Every entry takes M members at once (grid.y = member), so that a local
// mesh runs one hop of all G members in one call; the process mesh calls it
// with M = 1.  Member m:
//   chunk row    x + m * x_ms + c_m * x_cs
//   message row  r = (m + msg_shift) mod M: a hop reads what its left
//                neighbour sent (msg_shift = -1) without a rolled copy
//   output row   out + m * o_ms
//   c_m          (m + c_shift + *c_dev) mod G   (*c_dev counts 0 when null)
// Offsets are 64-bit elements (a chunk reaches 25,690,112 elements at
// VGG-A's fc13_w bucket, G = 4).
//
// int8 (int8_quantize, ring_hop_int8): two launches.
//   Pass 1 computes acc = q*s + x (x alone for int8_quantize), with
//   __fmul_rn / __fadd_rn so that nvcc cannot contract it into an FMA (the
//   plain PyTorch version rounds the product and the sum apart), takes each
//   block's max |acc| and folds it into member m's slot with atomicMax on
//   the bits: non-negative floats order as their bits, and a max is exact in
//   any order, so the scale is the same in every run.  The slots are zeroed
//   on the stream first.
//   Pass 2 computes s = amax / 127 (IEEE division, __fdiv_rn), 1 where that
//   is 0, recomputes acc the same way and writes q' = round-half-even(acc/s)
//   and s.  The result is bitwise the plain version's.
// topk (ring_hop_topk): the dense pass and the scatter, range by range.
//   The result is out = 0 + x (the 0 + turns -0 into +0, as the reference's
//   dense zeros do) with vals[j] added at idx[j].  The indices of one top-k
//   message are unique (the wrapper's contract; a top-k selection's are), so
//   no two threads touch one word: each entry is a plain load, one IEEE add
//   and a store, (0 + x) + v, bitwise the reference's (0 + v) + x,
//   subnormals kept (atom.add.f32 would flush them).  Indices outside
//   [0, n) are dropped, as JAX's scatter drops them.
//   The first design wrote all of out, then added each entry in place with a
//   compare-and-swap loop: at fc13_w (n = 25,690,112, k = 1,284,506) out
//   is twice the 50 MB L2, so each entry's read-modify-write of a 32-byte
//   sector went to DRAM.  Now out is written in ranges of at most kRange
//   elements (32 MB), and right after each range's dense pass a scatter
//   launch adds the entries whose index falls in it, while the range is
//   still in L2.  Each scatter reads the message's indices (4k bytes) once,
//   and only its own entries' values.
// Loads are 16 bytes a thread (4 floats; 4 int8 for the messages) when every
// row start allows it, else scalar: VGG-A's ragged strips (fc15_b, 250
// elements at G = 4) start at c * 250 floats.
//
// Bound on this card, bytes over 3.35 TB/s, per member and chunk of n:
// int8_quantize must read 4n and write n, a hop read n + 4n and write n; the
// two passes read the inputs twice (9n and 11n moved).  ring_hop_topk must
// read 4n + 8k and write 4n; it reads the indices once a range (4k bytes
// each).  Their times are in PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (repro_torch/kernels/build.py), never with --use_fast_math.  The C entries
// launch on the given stream, never synchronise, allocate nothing and return
// cudaGetLastError() (or cudaErrorInvalidValue for arguments they do not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1024;   // per launch, spread over the members
constexpr long long kRange = 8LL << 20;  // top-k: out elements a dense pass and scatter
constexpr int kScatter = 4;              // top-k: entries a thread, loads before stores

__device__ __forceinline__ long long wrap(long long i, long long m) {
  long long r = i % m;
  return r < 0 ? r + m : r;
}

struct WireArgs {
  const float* x;          // chunks
  long long x_ms, x_cs;
  const void* msg;         // int8 q (int8) or top-k values (f32); null: none
  const void* msg2;        // its scales (f32, one per row) or indices (int32)
  long long msg_ms;        // message row stride, elements
  int msg_shift;
  long long k;             // top-k entries per message
  void* out;               // int8 q' or f32 dense
  float* s_out;            // int8: the new scales, one per member
  long long o_ms;
  unsigned* amax;          // int8: (M,) slots, zeroed before pass 1
  const int* c_dev;
  int c_shift, G, M;
  long long n;
};

struct Member {
  const float* x;
  long long r;             // message row
};

__device__ __forceinline__ Member member(const WireArgs& p) {
  const long long m = blockIdx.y;
  const long long c = wrap(m + p.c_shift + (p.c_dev ? *p.c_dev : 0), p.G);
  return {p.x + m * p.x_ms + c * p.x_cs, wrap(m + p.msg_shift, p.M)};
}

__device__ __forceinline__ float acc1(float x, const int8_t* q, float s, long long i) {
  return q ? __fadd_rn(__fmul_rn(static_cast<float>(q[i]), s), x) : x;
}

__device__ __forceinline__ float4 acc4(float4 x, const int8_t* q, float s, long long i) {
  if (!q) return x;
  const char4 v = reinterpret_cast<const char4*>(q)[i];
  return make_float4(__fadd_rn(__fmul_rn(static_cast<float>(v.x), s), x.x),
                     __fadd_rn(__fmul_rn(static_cast<float>(v.y), s), x.y),
                     __fadd_rn(__fmul_rn(static_cast<float>(v.z), s), x.z),
                     __fadd_rn(__fmul_rn(static_cast<float>(v.w), s), x.w));
}

__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(fabsf(v)); }

__device__ __forceinline__ signed char quant1(float acc, float s) {
  return static_cast<signed char>(__float2int_rn(__fdiv_rn(acc, s)));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) int8_amax_kernel(WireArgs p) {
  const Member mb = member(p);
  const int8_t* q = p.msg ? static_cast<const int8_t*>(p.msg) + mb.r * p.msg_ms : nullptr;
  const float s = p.msg ? static_cast<const float*>(p.msg2)[mb.r] : 0.f;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned best = 0;
  long long done = 0;
  if (kVec) {
    const long long nv = p.n / 4;
    const float4* xv = reinterpret_cast<const float4*>(mb.x);
    for (long long i = tid; i < nv; i += stride) {
      const float4 a = acc4(xv[i], q, s, i);
      best = max(best, max(max(abs_bits(a.x), abs_bits(a.y)), max(abs_bits(a.z), abs_bits(a.w))));
    }
    done = nv * 4;
  }
  for (long long i = done + tid; i < p.n; i += stride)
    best = max(best, abs_bits(acc1(mb.x[i], q, s, i)));
  best = __reduce_max_sync(0xffffffffu, best);
  __shared__ unsigned warp_best[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) best = max(best, warp_best[w]);
    atomicMax(p.amax + blockIdx.y, best);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) int8_quant_kernel(WireArgs p) {
  const Member mb = member(p);
  const int8_t* q = p.msg ? static_cast<const int8_t*>(p.msg) + mb.r * p.msg_ms : nullptr;
  const float s = p.msg ? static_cast<const float*>(p.msg2)[mb.r] : 0.f;
  float sc = __fdiv_rn(__uint_as_float(p.amax[blockIdx.y]), 127.0f);
  sc = sc > 0.f ? sc : 1.0f;
  signed char* o = static_cast<signed char*>(p.out) + static_cast<long long>(blockIdx.y) * p.o_ms;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (kVec) {
    const long long nv = p.n / 4;
    const float4* xv = reinterpret_cast<const float4*>(mb.x);
    char4* ov = reinterpret_cast<char4*>(o);
    for (long long i = tid; i < nv; i += stride) {
      const float4 a = acc4(xv[i], q, s, i);
      ov[i] = make_char4(quant1(a.x, sc), quant1(a.y, sc), quant1(a.z, sc), quant1(a.w, sc));
    }
    done = nv * 4;
  }
  for (long long i = done + tid; i < p.n; i += stride) o[i] = quant1(acc1(mb.x[i], q, s, i), sc);
  if (blockIdx.x == 0 && threadIdx.x == 0) p.s_out[blockIdx.y] = sc;
}

// out[lo, hi) = 0 + x[lo, hi) for member blockIdx.y (lo % 4 == 0)
template <bool kVec>
__global__ void __launch_bounds__(kThreads) topk_dense_kernel(WireArgs p, long long lo,
                                                               long long hi) {
  const Member mb = member(p);
  const float* x = mb.x + lo;
  float* o = static_cast<float*>(p.out) + static_cast<long long>(blockIdx.y) * p.o_ms + lo;
  const long long len = hi - lo;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (kVec) {
    const long long nv = len / 4;
    const float4* xv = reinterpret_cast<const float4*>(x);
    float4* ov = reinterpret_cast<float4*>(o);
    for (long long i = tid; i < nv; i += stride) {
      const float4 a = __ldcs(xv + i);
      ov[i] = make_float4(__fadd_rn(0.f, a.x), __fadd_rn(0.f, a.y), __fadd_rn(0.f, a.z),
                          __fadd_rn(0.f, a.w));
    }
    done = nv * 4;
  }
  for (long long i = done + tid; i < len; i += stride) o[i] = __fadd_rn(0.f, __ldcs(x + i));
}

// out[idx[j]] += vals[j] for the entries with idx[j] in [lo, hi)
__global__ void __launch_bounds__(kThreads) topk_scatter_kernel(WireArgs p, long long lo,
                                                                 long long hi) {
  const long long r = wrap(static_cast<long long>(blockIdx.y) + p.msg_shift, p.M);
  const float* vals = static_cast<const float*>(p.msg) + r * p.msg_ms;
  const int* idx = static_cast<const int*>(p.msg2) + r * p.msg_ms;
  float* o = static_cast<float*>(p.out) + static_cast<long long>(blockIdx.y) * p.o_ms;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads * kScatter + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * kScatter;
  for (long long j0 = first; j0 < p.k; j0 += stride) {
    long long i[kScatter];
    float v[kScatter], cur[kScatter];
#pragma unroll
    for (int u = 0; u < kScatter; ++u) {
      const long long j = j0 + u * kThreads;
      i[u] = j < p.k ? idx[j] : -1;
      i[u] = i[u] >= lo && i[u] < hi ? i[u] : -1;
      v[u] = i[u] >= 0 ? vals[j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kScatter; ++u) cur[u] = i[u] >= 0 ? o[i[u]] : 0.f;
#pragma unroll
    for (int u = 0; u < kScatter; ++u)
      if (i[u] >= 0) o[i[u]] = __fadd_rn(cur[u], v[u]);
  }
}

unsigned blocks_for(long long work, int rows) {
  long long want = (work + kThreads - 1) / kThreads;
  long long cap = kMaxBlocks / rows > 0 ? kMaxBlocks / rows : 1;
  long long g = want < cap ? want : cap;
  return static_cast<unsigned>(g > 0 ? g : 1);
}

bool aligned(const void* ptr, long long stride_bytes, long long align) {
  return reinterpret_cast<uintptr_t>(ptr) % align == 0 && stride_bytes % align == 0;
}

bool bad_common(const WireArgs& p) {
  return p.G < 1 || p.M < 1 || p.M > 65535 || p.n < 1 || !p.x || !p.out;
}

}  // namespace

// int8_quantize (msg null) and ring_hop_int8: out (M, n) int8 at o_ms bytes a
// row, s_out (M,) f32, amax (M,) scratch of 4 bytes each.  Strides and n
// count elements of their own type.
extern "C" int ring_wire_int8(const void* x, long long x_ms, long long x_cs, const void* q,
                              const void* qs, long long q_ms, int q_shift, void* out,
                              void* s_out, long long o_ms, void* amax, const void* c_dev,
                              int c_shift, int G, int M, long long n, void* stream) {
  WireArgs p{static_cast<const float*>(x), x_ms, x_cs, q, qs, q_ms, q_shift, 0, out,
             static_cast<float*>(s_out), o_ms, static_cast<unsigned*>(amax),
             static_cast<const int*>(c_dev), c_shift, G, M, n};
  if (bad_common(p) || !s_out || !amax || (q && !qs)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned(x, x_ms * 4, 16) && aligned(x, x_cs * 4, 16) &&
                   aligned(out, o_ms, 4) && (!q || aligned(q, q_ms, 4));
  const dim3 grid(blocks_for(vec ? n / 4 + 1 : n, M), static_cast<unsigned>(M));
  cudaError_t rc = cudaMemsetAsync(amax, 0, static_cast<size_t>(M) * sizeof(unsigned), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (vec) {
    int8_amax_kernel<true><<<grid, kThreads, 0, s>>>(p);
    int8_quant_kernel<true><<<grid, kThreads, 0, s>>>(p);
  } else {
    int8_amax_kernel<false><<<grid, kThreads, 0, s>>>(p);
    int8_quant_kernel<false><<<grid, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// ring_hop_topk: vals (f32) and idx (int32) rows of k at v_ms elements a row;
// out (M, n) f32 at o_ms elements a row.
extern "C" int ring_wire_topk(const void* x, long long x_ms, long long x_cs, const void* vals,
                              const void* idx, long long v_ms, int v_shift, long long k,
                              void* out, long long o_ms, const void* c_dev, int c_shift, int G,
                              int M, long long n, void* stream) {
  WireArgs p{static_cast<const float*>(x), x_ms, x_cs, vals, idx, v_ms, v_shift, k, out,
             nullptr, o_ms, nullptr, static_cast<const int*>(c_dev), c_shift, G, M, n};
  if (bad_common(p) || k < 0 || (k > 0 && (!vals || !idx)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned(x, x_ms * 4, 16) && aligned(x, x_cs * 4, 16) &&
                   aligned(out, o_ms * 4, 16);
  // ranges of equal size, a multiple of 4 elements, at most kRange
  const long long ranges = (n + kRange - 1) / kRange;
  const long long size = ((n + ranges - 1) / ranges + 3) / 4 * 4;
  const long long per = static_cast<long long>(kThreads) * kScatter;
  const long long sblocks = (k + per - 1) / per < 65535 ? (k + per - 1) / per : 65535;
  for (long long lo = 0; lo < n; lo += size) {
    const long long hi = lo + size < n ? lo + size : n;
    const dim3 grid(blocks_for(vec ? (hi - lo) / 4 + 1 : hi - lo, M), static_cast<unsigned>(M));
    if (vec)
      topk_dense_kernel<true><<<grid, kThreads, 0, s>>>(p, lo, hi);
    else
      topk_dense_kernel<false><<<grid, kThreads, 0, s>>>(p, lo, hi);
    if (k > 0)
      topk_scatter_kernel<<<dim3(static_cast<unsigned>(sblocks), static_cast<unsigned>(M)),
                            kThreads, 0, s>>>(p, lo, hi);
  }
  return static_cast<int>(cudaGetLastError());
}
