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
// int8 (int8_quantize, ring_hop_int8): one cooperative launch a call.
//   The scale is the max over the whole message, so every element is read
//   twice, with a grid-wide barrier between the passes.  A member's units
//   (16-byte vectors of 4 floats, or floats) fall in tiles of kThreads *
//   kLoads units; block b of a member's B blocks takes tiles b, b + B, ...
//   Each thread issues its kLoads loads of a tile before their arithmetic.
//   Pass 1 walks the block's tiles forward and computes acc = q*s + x (x
//   alone for int8_quantize) with __fmul_rn / __fadd_rn, so that nvcc cannot
//   contract it into an FMA (the plain PyTorch version rounds the product
//   and the sum apart), and writes the block's max |acc| bits into its own
//   slot of a workspace: non-negative floats order as their bits.  The
//   slots are written every call, so nothing is zeroed.  Then
//   cooperative_groups::this_grid().sync(), and every block folds its
//   member's slots; a max is exact in any order, so the scale is the same
//   in every run.  s = amax / 127 (IEEE division, __fdiv_rn), 1 where that
//   is 0.  Pass 2 walks the block's tiles backward, recomputes acc the same
//   way and writes q' = round-half-even(acc/s) with streaming stores, and
//   s.  The result is bitwise the plain version's.  Backward, pass 2 starts
//   on what pass 1 read last, which is still in the 50 MB L2; the streaming
//   loads and stores of pass 2 keep the lines it has yet to read there.
//   The grid is the card's co-resident blocks (occupancy x SMs), spread
//   over the members; a cooperative launch refuses more, so with more
//   members than that (each needs a block) the entry returns
//   cudaErrorCooperativeLaunchTooLarge and launches nothing.
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
// two passes read the inputs twice (9n and 11n moved) where pass 2 misses
// L2, as it must for a chunk of twice the L2 (fc13_w's 4 members hold 514
// MB: pass 2 finds ~50 MB of it there).  ring_hop_topk must
// read 4n + 8k and write 4n; it reads the indices once a range (4k bytes
// each).  Their times are in PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (repro_torch/kernels/build.py), never with --use_fast_math.  The C entries
// launch on the given stream, never synchronise, allocate nothing and return
// cudaGetLastError() (or cudaErrorInvalidValue for arguments they do not take).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1024;   // top-k: per launch, spread over the members
constexpr long long kRange = 8LL << 20;  // top-k: out elements a dense pass and scatter
constexpr int kScatter = 4;              // top-k: entries a thread, loads before stores
constexpr int kLoads = 4;                // int8: loads a thread in flight, a tile
constexpr long long kTile = static_cast<long long>(kThreads) * kLoads;  // int8: units a tile
constexpr int kDevices = 64;             // int8: devices whose occupancy is cached

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
  unsigned* slots;         // int8: one per block of the grid, member-major
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

// the int8 arithmetic on one float or one vector of 4
__device__ __forceinline__ float dq(signed char q, float s, float x) {
  return __fadd_rn(__fmul_rn(static_cast<float>(q), s), x);
}
__device__ __forceinline__ float acc_of(float x, signed char q, float s) { return dq(q, s, x); }
__device__ __forceinline__ float4 acc_of(float4 x, char4 q, float s) {
  return make_float4(dq(q.x, s, x.x), dq(q.y, s, x.y), dq(q.z, s, x.z), dq(q.w, s, x.w));
}
__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(fabsf(v)); }
__device__ __forceinline__ unsigned abs_bits(float4 v) {
  return max(max(abs_bits(v.x), abs_bits(v.y)), max(abs_bits(v.z), abs_bits(v.w)));
}
__device__ __forceinline__ signed char quant(float acc, float s) {
  return static_cast<signed char>(__float2int_rn(__fdiv_rn(acc, s)));
}
__device__ __forceinline__ char4 quant(float4 a, float s) {
  return make_char4(quant(a.x, s), quant(a.y, s), quant(a.z, s), quant(a.w, s));
}

template <bool kVec> struct Unit;
template <> struct Unit<true> { using X = float4; using Q = char4; };
template <> struct Unit<false> { using X = float; using Q = signed char; };

// One member's view for the int8 passes: its units (n / 4 vectors, or n
// floats), its message row, and the vector path's ragged end (n % 4
// elements, taken by block 0's first threads in both passes).
template <bool kVec, bool kHop>
struct Int8View {
  using X = typename Unit<kVec>::X;
  using Q = typename Unit<kVec>::Q;
  const float* x;
  const signed char* q;    // message row (kHop)
  float s;                 // its scale (kHop)
  long long units, tiles, tail;

  __device__ __forceinline__ explicit Int8View(const WireArgs& p) {
    const Member mb = member(p);
    x = mb.x;
    q = kHop ? static_cast<const signed char*>(p.msg) + mb.r * p.msg_ms : nullptr;
    s = kHop ? static_cast<const float*>(p.msg2)[mb.r] : 0.f;
    units = kVec ? p.n / 4 : p.n;
    tiles = (units + kTile - 1) / kTile;
    tail = kVec && blockIdx.x == 0 ? p.n - 4 * units : 0;
  }
  // unit i of x (and of the message, into qv); kLast: pass 2's loads, the
  // data's last use
  template <bool kLast>
  __device__ __forceinline__ X load(long long i, Q& qv) const {
    const X* xv = reinterpret_cast<const X*>(x) + i;
    if constexpr (kHop) {
      const Q* qp = reinterpret_cast<const Q*>(q) + i;
      qv = kLast ? __ldcs(qp) : __ldg(qp);
    }
    return kLast ? __ldcs(xv) : __ldg(xv);
  }
  __device__ __forceinline__ X acc(X xv, Q qv) const {
    if constexpr (kHop) return acc_of(xv, qv, s);
    return xv;
  }
  __device__ __forceinline__ float tail_acc(long long e) const {
    return kHop ? dq(q[e], s, x[e]) : x[e];
  }
};

// max over the block of each thread's v (every thread gets it)
__device__ __forceinline__ unsigned block_max(unsigned v) {
  __shared__ unsigned warp_best[kThreads / 32];
  v = __reduce_max_sync(0xffffffffu, v);
  __syncthreads();   // warp_best's last readers are done
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = v;
  __syncthreads();
  for (int w = 0; w < kThreads / 32; ++w) v = max(v, warp_best[w]);
  return v;
}

// pass 1: the block's tiles forward; its max |acc| bits into its slot
template <bool kVec, bool kHop>
__device__ __forceinline__ void int8_pass1(const WireArgs& p) {
  const Int8View<kVec, kHop> v(p);
  const long long B = gridDim.x;
  unsigned best = 0;
  for (long long t = blockIdx.x; t < v.tiles; t += B) {
    const long long base = t * kTile + threadIdx.x;
    typename Unit<kVec>::X xv[kLoads];
    typename Unit<kVec>::Q qv[kLoads] = {};
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (base + u * kThreads < v.units) xv[u] = v.template load<false>(base + u * kThreads, qv[u]);
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (base + u * kThreads < v.units) best = max(best, abs_bits(v.acc(xv[u], qv[u])));
  }
  if (threadIdx.x < v.tail) best = max(best, abs_bits(v.tail_acc(4 * v.units + threadIdx.x)));
  best = block_max(best);
  if (threadIdx.x == 0) p.slots[blockIdx.y * B + blockIdx.x] = best;
}

// pass 2: fold the member's slots into its scale; the block's tiles
// backward, q' = round(acc / s) with streaming stores
template <bool kVec, bool kHop>
__device__ __forceinline__ void int8_pass2(const WireArgs& p) {
  using Q = typename Unit<kVec>::Q;
  const Int8View<kVec, kHop> v(p);
  const long long B = gridDim.x;
  unsigned amax = 0;
  for (long long b = threadIdx.x; b < B; b += kThreads)
    amax = max(amax, __ldcg(p.slots + blockIdx.y * B + b));
  amax = block_max(amax);
  float sc = __fdiv_rn(__uint_as_float(amax), 127.0f);
  sc = sc > 0.f ? sc : 1.0f;
  signed char* ob = static_cast<signed char*>(p.out) + static_cast<long long>(blockIdx.y) * p.o_ms;
  Q* o = reinterpret_cast<Q*>(ob);
  if (blockIdx.x < v.tiles) {
    for (long long t = blockIdx.x + (v.tiles - 1 - blockIdx.x) / B * B; t >= 0; t -= B) {
      const long long base = t * kTile + threadIdx.x;
      typename Unit<kVec>::X xv[kLoads];
      Q qv[kLoads] = {};
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (base + u * kThreads < v.units) xv[u] = v.template load<true>(base + u * kThreads, qv[u]);
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (base + u * kThreads < v.units) __stcs(o + base + u * kThreads, quant(v.acc(xv[u], qv[u]), sc));
    }
  }
  if (threadIdx.x < v.tail) {
    const long long e = 4 * v.units + threadIdx.x;
    ob[e] = quant(v.tail_acc(e), sc);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) p.s_out[blockIdx.y] = sc;
}

template <bool kVec, bool kHop>
__global__ void __launch_bounds__(kThreads) int8_wire_kernel(WireArgs p) {
  int8_pass1<kVec, kHop>(p);
  cooperative_groups::this_grid().sync();
  int8_pass2<kVec, kHop>(p);
}

template <bool kVec, bool kHop>
cudaError_t launch_int8(dim3 grid, WireArgs p, cudaStream_t s) {
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&int8_wire_kernel<kVec, kHop>),
                                     grid, dim3(kThreads), args, 0, s);
}

// blocks of each int8 instance the device holds at once (occupancy x SMs),
// the current device's, cached; 0 on error
int resident(int which) {
  static int cache[kDevices][4];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kDevices) return 0;
  if (cache[dev][which] > 0) return cache[dev][which];
  const void* fns[4] = {reinterpret_cast<const void*>(&int8_wire_kernel<false, false>),
                        reinterpret_cast<const void*>(&int8_wire_kernel<false, true>),
                        reinterpret_cast<const void*>(&int8_wire_kernel<true, false>),
                        reinterpret_cast<const void*>(&int8_wire_kernel<true, true>)};
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fns[which], kThreads, 0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  cache[dev][which] = per_sm * sms;
  return cache[dev][which];
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

// The workspace slots ring_wire_int8 may need on the current device: the
// most blocks any int8 instance holds at once.  0 on a CUDA error.
extern "C" long long ring_wire_int8_slots() {
  long long most = 0;
  for (int which = 0; which < 4; ++which) {
    const long long r = resident(which);
    if (r == 0) return 0;
    most = r > most ? r : most;
  }
  return most;
}

// int8_quantize (msg null) and ring_hop_int8: out (M, n) int8 at o_ms bytes a
// row, s_out (M,) f32, slots a workspace of n_slots 4-byte words (at least
// ring_wire_int8_slots(); a call writes each slot it uses before reading
// it).  Strides and n count elements of their own type.  One cooperative
// launch; cudaErrorCooperativeLaunchTooLarge when M exceeds the blocks the
// device holds at once.
extern "C" int ring_wire_int8(const void* x, long long x_ms, long long x_cs, const void* q,
                              const void* qs, long long q_ms, int q_shift, void* out,
                              void* s_out, long long o_ms, void* slots, long long n_slots,
                              const void* c_dev, int c_shift, int G, int M, long long n,
                              void* stream) {
  WireArgs p{static_cast<const float*>(x), x_ms, x_cs, q, qs, q_ms, q_shift, 0, out,
             static_cast<float*>(s_out), o_ms, static_cast<unsigned*>(slots),
             static_cast<const int*>(c_dev), c_shift, G, M, n};
  if (bad_common(p) || !s_out || !slots || (q && !qs)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned(x, x_ms * 4, 16) && aligned(x, x_cs * 4, 16) &&
                   aligned(out, o_ms, 4) && (!q || aligned(q, q_ms, 4));
  const long long held = resident(2 * vec + (q != nullptr));
  if (held == 0) {
    const cudaError_t rc = cudaGetLastError();
    return static_cast<int>(rc != cudaSuccess ? rc : cudaErrorInvalidDevice);
  }
  const long long units = vec ? n / 4 : n;
  const long long tiles = (units + kTile - 1) / kTile;
  long long per = held / M < tiles ? held / M : tiles;   // blocks a member
  per = per > 0 ? per : 1;
  if (per * M > held) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (per * M > n_slots) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(per), static_cast<unsigned>(M));
  cudaError_t rc;
  if (vec)
    rc = q ? launch_int8<true, true>(grid, p, s) : launch_int8<true, false>(grid, p, s);
  else
    rc = q ? launch_int8<false, true>(grid, p, s) : launch_int8<false, false>(grid, p, s);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
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
