// The paper's §3.4 ring collectives for NVIDIA Hopper (sm_90a), f32 and bf16.
//
// Replaces the TPU kernels of src/repro/kernels/ring.py:
//   ring_reduce_scatter  (Pallas body _reduce_scatter_kernel) stacked ring, G-1 hops
//   ring_hop_accum       (Pallas body _hop_accum_kernel)    recv + chunks[c]
//   ring_all_gather      (Pallas body _all_gather_kernel)   stacked ring all-gather
//
// fold_kernel  strip p of P is a left fold of rows, element by element, each
//   add rounded in the input dtype (bf16: in f32, then to nearest even, as jnp
//   and torch round it): row 0 at a + p * n (row 1 when a is null), then
//   rows k = 1 .. R at x + ((p + k) mod G) * x_ms + c * x_cs, c = (p + c_shift
//   + *c_dev) mod G (*c_dev, 0 when null, is read once: no hop waits on the host).
//   * ring_reduce_scatter is one launch, P = R = G, c = p.  In the reference's
//     (step, member) grid (ring.py:75-99) member p adds its chunk (p-2-s) mod G
//     at step s to what p - 1 sent, so strip p is ((x[p+1, p] + x[p+2, p]) +
//     ...) + x[p, p], members mod G.  One thread folds that in registers in
//     that order, bitwise, without the mailbox and step barriers the TPU needed
//     to run its grid in order on one core.  At a member stride of 0 (zero1's
//     one gradient viewed G times) the row is read once: ((v + v) + v) + v.
//   * ring_hop_accum is recv then chunks[c]: P = R = 1, a = recv, x_ms = 0.
//   * A thread takes kUnroll 16-byte words of a row and issues kBatch rows'
//     loads before their adds (__restrict__, streaming loads and stores); one
//     block a tile (a grid that fills the SMs once ran slower).  Rows not all 16-byte
//     aligned go an element at a time (VGG-A's fc15_b strip of 250 at G = 4,
//     CD-DNN's 2326).  Offsets are 64-bit (G = 8 partials: up to 3.3 GB).
//
// all_gather_kernel  out[p, o*n : (o+1)*n] = x[o] for every member p and
//   owner o, in one launch: each thread reads a word of x[o] once and writes
//   it to all G rows.  Pure data movement, exact in any dtype; the word is
//   the widest of 16, 8, 4, 2 bytes that every row start allows.
//
// Bound on this card: bytes over 3.35 TB/s.  The reduce-scatter must read the
// (G, N) stack once (N elements at a member stride of 0) and write N, as the
// fold does; a hop reads 2n and writes n; the all-gather reads N, writes G*N.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared (kernels/build.py).
// The C entries launch on the given stream, never synchronise, allocate nothing
// and return cudaGetLastError() (cudaErrorInvalidValue for arguments not taken).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;               // fold: words of a row a thread takes a trip
constexpr int kBatch = 4;                // fold: rows whose loads precede their adds
constexpr long long kTile = kThreads * kUnroll;   // fold: words a block takes a trip
constexpr long long kMaxBlocks = 1024;   // all-gather: blocks a launch, over the rows

__device__ __forceinline__ float add(float x, float y, float) { return x + y; }
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 x, __nv_bfloat16 y, __nv_bfloat16) {
  return __float2bfloat16_rn(__bfloat162float(x) + __bfloat162float(y));
}

// 16 bytes of T added lane by lane, each lane rounded as the scalar add rounds it
template <typename T>
__device__ __forceinline__ uint4 add(uint4 x, uint4 y, T) {
  T* a = reinterpret_cast<T*>(&x);
  const T* b = reinterpret_cast<const T*>(&y);
#pragma unroll
  for (int k = 0; k < 16 / static_cast<int>(sizeof(T)); ++k) a[k] = add(a[k], b[k], T());
  return x;
}

struct FoldArgs {   // as ring_fold takes them
  const void *a, *x, *c_dev;
  void* out;
  long long x_ms, x_cs, n;
  int c_shift, G, R;
};

// One strip's fold at words i + u * kThreads (u < U) below nw: it starts from
// row0 and adds rows k0 .. R, row k at xs + ((p + k) mod G) * ms.
template <typename T, int U, typename W>
__device__ __forceinline__ void fold_tile(const W* __restrict__ row0, const W* __restrict__ xs,
                                          long long ms, int p, int G, int k0, int R,
                                          W* __restrict__ o, long long i, long long nw) {
  W acc[U], one[U];   // one: at ms = 0 every row of x is one row, read once (row0 if k0 = 2)
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = i + u * kThreads < nw;
    acc[u] = in ? __ldcs(row0 + i + u * kThreads) : W();
    one[u] = k0 == 2 || ms || !in ? acc[u] : __ldcs(xs + i + u * kThreads);
  }
  for (int k = k0; k <= R; k += kBatch) {
    W v[kBatch][U];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const long long row = (p + k + b < G ? p + k + b : p + k + b - G) * ms;   // p + k + b < 2G
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[b][u] = ms && k + b <= R && i + u * kThreads < nw ? __ldcs(xs + row + i + u * kThreads)
                                                            : one[u];
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k + b <= R) acc[u] = add(acc[u], v[b][u], T());
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (i + u * kThreads < nw) __stcs(o + i + u * kThreads, acc[u]);
}

// W: uint4 (16 bytes of T; every row start aligned) or T.  Block (x, p) walks strip p.
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads) fold_kernel(const FoldArgs f) {
  constexpr int kV = sizeof(W) / sizeof(T);
  const int p = blockIdx.y;
  const int* c_dev = static_cast<const int*>(f.c_dev);
  const long long c = (static_cast<long long>(p) + f.c_shift + (c_dev ? *c_dev : 0)) % f.G;
  const T* xs = static_cast<const T*>(f.x) + (c < 0 ? c + f.G : c) * f.x_cs;
  const T* row0 = f.a ? static_cast<const T*>(f.a) + p * f.n
                      : xs + (p + 1 < f.G ? p + 1 : 0) * f.x_ms;
  const int k0 = f.a ? 1 : 2;
  T* o = static_cast<T*>(f.out) + p * f.n;
  const long long nw = f.n / kV;
  for (long long t = blockIdx.x; t * kTile < nw; t += gridDim.x)
    fold_tile<T, kUnroll>(reinterpret_cast<const W*>(row0), reinterpret_cast<const W*>(xs),
                          f.x_ms / kV, p, f.G, k0, f.R, reinterpret_cast<W*>(o),
                          t * kTile + threadIdx.x, nw);
  if (kV > 1 && blockIdx.x == 0 && threadIdx.x < f.n - nw * kV)   // the row's last elements
    fold_tile<T, 1>(row0, xs, f.x_ms, p, f.G, k0, f.R, o, nw * kV + threadIdx.x, f.n);
}

template <typename T, typename W>
int launch_fold(const FoldArgs& f, int P, void* stream) {
  const long long tiles = (f.n / static_cast<long long>(sizeof(W) / sizeof(T)) + kTile - 1) / kTile;
  const long long blocks = tiles;   // one tile a block
  fold_kernel<T, W><<<dim3(static_cast<unsigned>(blocks > 1 ? blocks : 1), P), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(f);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
all_gather_kernel(const char* x, long long x_ms, char* out, int G, long long row_bytes) {
  const long long o = blockIdx.y;
  const W* src = reinterpret_cast<const W*>(x + o * x_ms);
  const long long words = row_bytes / static_cast<long long>(sizeof(W));
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = tid; i < words; i += stride) {
    const W v = src[i];
    for (int p = 0; p < G; ++p)
      reinterpret_cast<W*>(out + (static_cast<long long>(p) * G + o) * row_bytes)[i] = v;
  }
}

unsigned blocks_for(long long work, int rows) {
  long long want = (work + kThreads - 1) / kThreads;
  long long cap = kMaxBlocks / rows > 0 ? kMaxBlocks / rows : 1;
  long long g = want < cap ? want : cap;
  return static_cast<unsigned>(g > 0 ? g : 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  a (may be null) and out are (P, n), strides
// and n in elements; 1 <= R, P <= G.
extern "C" int ring_fold(int dtype, const void* a, const void* x, long long x_ms, long long x_cs,
                         void* out, const void* c_dev, int c_shift, int G, int R, int P,
                         long long n, void* stream) {
  if (G < 1 || R < 1 || R > G || P < 1 || P > G || P > 65535 || n < 1 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const FoldArgs f{a, x, c_dev, out, x_ms, x_cs, n, c_shift, G, R};
  const long long es = dtype == 0 ? 4 : 2;   // 16-byte words need every row start aligned
  const bool vec = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) % 16 == 0) &&
                   (x_ms * es) % 16 == 0 && (x_cs * es) % 16 == 0 &&
                   (P == 1 || (n * es) % 16 == 0);
  if (dtype == 0)
    return vec ? launch_fold<float, uint4>(f, P, stream) : launch_fold<float, float>(f, P, stream);
  return vec ? launch_fold<__nv_bfloat16, uint4>(f, P, stream)
             : launch_fold<__nv_bfloat16, __nv_bfloat16>(f, P, stream);
}

// out (G, G * row_bytes) bytes, contiguous; row o of x starts at x + o * x_ms
// bytes.  row_bytes is a multiple of 2 (an f32 or bf16 strip).
extern "C" int ring_all_gather(const void* x, long long x_ms, void* out, int G,
                               long long row_bytes, void* stream) {
  if (G < 1 || G > 65535 || row_bytes < 2 || row_bytes % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long bits = reinterpret_cast<uintptr_t>(x) |
                                  reinterpret_cast<uintptr_t>(out) |
                                  static_cast<unsigned long long>(x_ms) |
                                  static_cast<unsigned long long>(row_bytes);
  const char* src = static_cast<const char*>(x);
  char* dst = static_cast<char*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kThreads);
  if (bits % 16 == 0) {
    all_gather_kernel<uint4><<<dim3(blocks_for(row_bytes / 16, G), G), block, 0, s>>>(
        src, x_ms, dst, G, row_bytes);
  } else if (bits % 8 == 0) {
    all_gather_kernel<uint2><<<dim3(blocks_for(row_bytes / 8, G), G), block, 0, s>>>(
        src, x_ms, dst, G, row_bytes);
  } else if (bits % 4 == 0) {
    all_gather_kernel<unsigned><<<dim3(blocks_for(row_bytes / 4, G), G), block, 0, s>>>(
        src, x_ms, dst, G, row_bytes);
  } else {
    all_gather_kernel<unsigned short><<<dim3(blocks_for(row_bytes / 2, G), G), block, 0, s>>>(
        src, x_ms, dst, G, row_bytes);
  }
  return static_cast<int>(cudaGetLastError());
}
