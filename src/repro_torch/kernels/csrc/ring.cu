// The paper's §3.4 ring collectives for NVIDIA Hopper (sm_90a), f32 and bf16.
//
// Replaces the TPU kernels of src/repro/kernels/ring.py:
//   ring_hop_accum       (Pallas body _hop_accum_kernel)    recv + chunks[c]
//   ring_reduce_scatter  (Pallas body _reduce_scatter_kernel) stacked ring, G-1 hops
//   ring_all_gather      (Pallas body _all_gather_kernel)   stacked ring all-gather
//
// Two kernels serve all three:
//
// hop_kernel  out[m] = a[m] + b[m][c_m] for M members at once, row by row:
//   a row    a + ((m + a_shift) mod M) * a_ms + c_m * a_cs
//   b row    b + m * b_ms + c_m * b_cs
//   out row  out + ((m + o_shift) mod M) * o_ms
//   c_m      (m + c_shift + *c_dev) mod G   (*c_dev counts 0 when c_dev is null)
//   All offsets are 64-bit elements: a VGG-A bucket row holds up to 102.8 M
//   elements, and at G = 8 a gathered (G, G*n) buffer passes 2^31 bytes.
//   * ring_hop_accum is one launch with M = 1: a = recv, b = chunks, and the
//     chunk index either a host int (c_shift) or an int32 on the card (c_dev),
//     read by the kernel so that a hop never waits for the host.
//   * ring_reduce_scatter is G - 1 launches with M = G, one per step of the
//     reference's step-major ring (ring.py:75-99): at step s member p adds its
//     own x[p, c] to what its left neighbour sent, x[p-1, c] at s = 0 or
//     mailbox slot s % 2 row p after, with c = (p - 2 - s) mod G, and sends it
//     to mailbox slot (s + 1) % 2 row p + 1, or to its output row at the last
//     step.  The TPU ran the (step, member) grid in order on one core; Hopper
//     blocks run in no order, so the kernel boundary is the step barrier.  The
//     ring's order of additions is kept, in the input dtype, so the result is
//     bitwise the reference kernel's.  A member stride of 0 (one replicated
//     gradient viewed G times) is read as it is, never copied.
//   * bf16 adds the way the reference's jnp add does: in f32, rounded to
//     nearest even (__float2bfloat16_rn), bitwise torch's bf16 add.
//   * Loads and stores are 16 bytes a thread when every row start is 16-byte
//     aligned (bases and strides), with a scalar tail; otherwise scalar.  A
//     chunk starts at c * n, so VGG-A's ragged strips (fc15_b's 250 elements
//     at G = 4) take the scalar path.
//
// all_gather_kernel  out[p, o*n : (o+1)*n] = x[o] for every member p and
//   owner o, in one launch: each thread reads a word of x[o] once and writes
//   it to all G rows.  Pure data movement, exact in any dtype; the word is
//   the widest of 16, 8, 4, 2 bytes that every row start allows.
//
// Bound on this card: bytes over 3.35 TB/s.  reduce-scatter must read the
// (G, N) stack once and write the (G, N/G) result once; the mailbox ring
// moves about 9/5 of that at G = 4 (each step reads two chunk rows per member
// and writes one).  all-gather reads N and writes G*N.  A hop reads 2n and
// writes n.  Their times are in PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (repro_torch/kernels/build.py).  The C entries launch on the given stream,
// never synchronise, allocate nothing and return cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernels do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1024;   // per launch, spread over the members

__device__ __forceinline__ long long wrap(long long i, long long m) {
  long long r = i % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ float add1(float x, float y) { return x + y; }

__device__ __forceinline__ __nv_bfloat16 add1(__nv_bfloat16 x, __nv_bfloat16 y) {
  return __float2bfloat16_rn(__bfloat162float(x) + __bfloat162float(y));
}

// 16 bytes of T added lane by lane, each lane rounded as add1 rounds it
__device__ __forceinline__ uint4 add16(uint4 x, uint4 y, float) {
  float4 a = *reinterpret_cast<float4*>(&x), b = *reinterpret_cast<float4*>(&y);
  float4 r = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  return *reinterpret_cast<uint4*>(&r);
}

__device__ __forceinline__ uint4 add16(uint4 x, uint4 y, __nv_bfloat16) {
  uint4 r;
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 fa = __bfloat1622float2(a[k]), fb = __bfloat1622float2(b[k]);
    o[k] = __floats2bfloat162_rn(fa.x + fb.x, fa.y + fb.y);
  }
  return r;
}

struct HopArgs {
  const void* a;
  long long a_ms, a_cs;
  int a_shift;
  const void* b;
  long long b_ms, b_cs;
  void* out;
  long long o_ms;
  int o_shift;
  const int* c_dev;
  int c_shift, G, M;
  long long n;
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) hop_kernel(HopArgs p) {
  const long long m = blockIdx.y;
  const long long c = wrap(m + p.c_shift + (p.c_dev ? *p.c_dev : 0), p.G);
  const T* a = static_cast<const T*>(p.a) + wrap(m + p.a_shift, p.M) * p.a_ms + c * p.a_cs;
  const T* b = static_cast<const T*>(p.b) + m * p.b_ms + c * p.b_cs;
  T* o = static_cast<T*>(p.out) + wrap(m + p.o_shift, p.M) * p.o_ms;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (kVec) {
    constexpr int kV = 16 / sizeof(T);
    const long long nv = p.n / kV;
    const uint4* av = reinterpret_cast<const uint4*>(a);
    const uint4* bv = reinterpret_cast<const uint4*>(b);
    uint4* ov = reinterpret_cast<uint4*>(o);
    for (long long i = tid; i < nv; i += stride) ov[i] = add16(av[i], bv[i], T());
    done = nv * kV;
  }
  for (long long i = done + tid; i < p.n; i += stride) o[i] = add1(a[i], b[i]);
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

template <typename T>
int launch_hop(const HopArgs& p, cudaStream_t stream) {
  const long long es = sizeof(T);
  const bool vec = ((reinterpret_cast<uintptr_t>(p.a) | reinterpret_cast<uintptr_t>(p.b) |
                     reinterpret_cast<uintptr_t>(p.out)) % 16 == 0) &&
                   (p.a_ms * es) % 16 == 0 && (p.a_cs * es) % 16 == 0 &&
                   (p.b_ms * es) % 16 == 0 && (p.b_cs * es) % 16 == 0 &&
                   (p.o_ms * es) % 16 == 0;
  const long long work = vec ? p.n / (16 / es) + 1 : p.n;
  dim3 grid(blocks_for(work, p.M), static_cast<unsigned>(p.M));
  if (vec)
    hop_kernel<T, true><<<grid, kThreads, 0, stream>>>(p);
  else
    hop_kernel<T, false><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides and n count elements.
extern "C" int ring_hop(int dtype, const void* a, long long a_ms, long long a_cs, int a_shift,
                        const void* b, long long b_ms, long long b_cs, void* out,
                        long long o_ms, int o_shift, const void* c_dev, int c_shift, int G,
                        int M, long long n, void* stream) {
  if (G < 1 || M < 1 || M > 65535 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  HopArgs p{a, a_ms, a_cs, a_shift, b, b_ms, b_cs, out, o_ms, o_shift,
            static_cast<const int*>(c_dev), c_shift, G, M, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hop<float>(p, s);
  if (dtype == 1) return launch_hop<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
