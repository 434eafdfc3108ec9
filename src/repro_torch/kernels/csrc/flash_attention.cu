// Flash attention (forward) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:86
// flash_attention (its pl.pallas_call at :105, Pallas body _flash_kernel) and
// computes what it computes:
//   out[b,i,h,:] = sum_j softmax_j(mask(cap(scale * q[b,i,h] . k[b,j,h/g]))) v[b,j,h/g]
// with g = Hq / Hkv (GQA); cap(s) = tanh(s / softcap) * softcap when
// softcap > 0, before the mask; the mask keeps k_pos <= q_pos when causal and k_pos > q_pos - window
// when window > 0, with q_pos = i + Skv - Sq (queries right-aligned against the
// keys); masked scores are -1e30, never -inf; an online softmax carries the
// running max m, denominator l and accumulator in f32 over the KV tiles; the
// output is acc / max(l, 1e-30), written once in q's type.
//
// Two designs behind one entry, picked by the type:
//   * bf16 (the training path's type): tensor cores.  The bound on this card
//     is operations: one call does 4 * B * Hq * D flops per live (q, k) pair
//     (about half of Sq * Skv under causal masking) and moves q, k, v in and o
//     out once, ~1000 flops a byte at D = 256, far above the ridge; the least
//     time is those flops at the bf16 tensor-core peak (989 TFLOP/s), which
//     only wgmma reaches.  So:
//       - one CTA owns (q head h, batch b, a q tile); a consumer warpgroup
//         takes 64 of its rows (the wgmma M) and one producer warp issues
//         every load.  The (64, D) f32 accumulator alone is D / 2 registers
//         a thread: at D = 256 the CTA has one consumer warpgroup and 255
//         registers a thread; below, two that share every K/V tile, and
//         setmaxnreg moves the producer's registers to them;
//       - TMA brings q in once and K and V in tiles of 64 keys through two
//         rings of 3 stages (D = 256) or 4 in shared memory, each stage with
//         full and empty mbarriers, so a K tile is refilled as soon as its
//         S is done; the 4-D tensor maps (D, H, S, B) carry the real strides
//         and fill rows past Sq or Skv with zeros, and their 128-byte swizzle
//         (64-byte at D = 32) is the layout wgmma reads;
//       - each consumer issues tile i's S together with tile i - 1's P V and
//         runs tile i's softmax while the tensor cores do that P V;
//       - S = q k^T is wgmma from shared memory (both operands K-major, as
//         they lie), f32 accumulators; scale, softcap, mask and the online
//         softmax run on the accumulator fragments in registers (a row's max
//         and sum are shuffles over the 4 lanes that share it); exponentials
//         are base 2 on log2(e)-scaled scores;
//       - O += P V is wgmma with P from registers, rounded once to bf16 in
//         place, and V from shared memory through the transpose bit (V is
//         MN-major for this product); l sums the unrounded f32 p;
//       - the live K/V tiles (not past the causal frontier of the CTA's last
//         row, not wholly older than the window of its first) are one
//         contiguous range that producer and consumers compute alike; the
//         heaviest q tiles launch first.
//     Against the f32 reference arithmetic this rounds the scaled scores
//     after the bf16 products (not q before them) and P to bf16 before P V:
//     tests/test_torch_flash_numerics.py emulates it and holds it to the same
//     one-ulp bf16 tolerance as the kernel.
//   * f32: the first port's FFMA kernel (67 TFLOP/s ceiling outside the
//     tensor cores).  The TPU walks a sequential kv grid axis and carries m,
//     l and acc in VMEM scratch; here one block owns (batch b, q head h, a
//     64-row q tile) and loops over the KV tiles itself; m, l and the (64, D)
//     accumulator stay in registers (4 rows x D/16 columns a thread, 256
//     threads); the 16 threads that share a row group are one half-warp, so
//     each row's max and sum are butterfly shuffles; q, the K tile transposed,
//     the V tile and the probabilities sit in shared memory as f32, rows
//     padded by one word (140 KB at D = 256, BKV = 32).
//
// Both skip a KV tile with no live (q, k) pair for any row of the block, as
// the TPU kernel's pl.when(needed) does.  A row that is wholly masked inside
// a live tile takes p = exp(-1e30 - m) = 0 once it has a live key, or weights
// exp(0) = 1 that the next live key's alpha = exp(-1e30 - m) = 0 wipes
// exactly: that holds only because the fill is finite.  Unlike the TPU
// kernel, Sq and Skv need not be multiples of a tile: rows past Sq are
// computed on zeros and not stored; keys past Skv load as zeros and are
// masked (the bf16 kernel: a stored row has a live key, its own position, no
// later than the last tile, so its m is real there and they take p = 0).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (repro_torch/kernels/build.py; no -lcuda: the tensor-map encoder comes from
// cudaGetDriverEntryPoint).  The C entry launches on the given stream, never
// synchronises, allocates nothing and returns the CUDA error of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;      // query rows per block
constexpr int kRows = 4;     // rows per thread
constexpr int kLanes = 16;   // threads per row group: one half-warp
constexpr float kNegInf = -1e30f;

static_assert(kThreads == kLanes * kBQ / kRows, "one thread per (row group, lane)");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---- bf16: wgmma on TMA-fed tiles ------------------------------------------

constexpr int kWgRows = 64;   // q rows of a consumer warpgroup
constexpr int kTK = 64;       // keys a K/V tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tc {
  // consumer warpgroups a CTA: at D = 256 one, so that its 64 x 256 f32
  // accumulator has the 255 registers a thread that a 256-thread block
  // allows (two, even with setmaxnreg, serialize the wgmmas and spill);
  // below two, sharing each K/V tile
  static constexpr int CONSUMERS = D == 256 ? 1 : 2;
  static constexpr int TQ = kWgRows * CONSUMERS;          // q rows a CTA
  static constexpr int THREADS = 128 * (CONSUMERS + 1);   // and the producer warpgroup
  static constexpr int CB = D < 64 ? D : 64;               // columns of one swizzled row
  static constexpr int RB = 2 * CB;                        // its bytes: 64 or 128
  static constexpr int NCB = D / CB;                       // column blocks of a tile
  static constexpr uint32_t SWIZZLE = RB == 128 ? 1 : 2;   // descriptor code
  static constexpr int STAGES = D == 256 ? 3 : 4;   // 225 KB of shared memory at D = 256
  static constexpr uint32_t Q_BYTES = TQ * D * 2;
  static constexpr uint32_t KV_BYTES = kTK * D * 2;        // one K or V tile
  static constexpr int OB = D < 64 ? 1 : D / 64;           // output accumulator blocks
  static constexpr int ON = D < 64 ? 16 : 32;              // and their registers
  // 1024 bytes of slack to align the swizzle atoms, then q, the K and V
  // rings and the barriers (q's, and four a stage)
  static constexpr size_t SMEM =
      1024 + Q_BYTES + (size_t)STAGES * 2 * KV_BYTES + (1 + 4 * STAGES) * 8;
  static_assert(SMEM <= 232448, "over the 227 KB a block may have");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// what a consumer thread's softmax needs of its rows and the call
struct RowCtx {
  float c1, c2, softcap;   // scores in log2 units: s c1, or tanh(s c1) c2 with the softcap
  int Skv, causal, window;
  int qp0, qp_min, qp_max;   // q_pos of the thread's row r0; of the warpgroup's rows
  int cq;                    // the thread's columns in each 8-column group
};

// One S tile's online softmax in registers, in place: the scores become
// p = exp2(x - m) of the scaled, capped and masked scores x (log2 units);
// m is the running row max, alpha its correction for the old sums, and l
// this thread's share of the row's sum.  Accumulator element j is row
// r0 + 8 ((j / 2) % 2), column 8 (j / 4) + cq + j % 2.
__device__ __forceinline__ void softmax_tile(float (&p)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, const RowCtx& r) {
  const bool edge = k0 + kTK > r.Skv || (r.causal && k0 + kTK - 1 > r.qp_min) ||
                    (r.window > 0 && k0 <= r.qp_max - r.window);
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int h = (j >> 1) & 1;
    float x = p[j] * r.c1;
    if (r.softcap > 0.f) x = tanhf(x) * r.c2;
    if (edge) {
      const int kp = k0 + 8 * (j >> 2) + r.cq + (j & 1), qp = r.qp0 + 8 * h;
      const bool keep =
          kp < r.Skv && (!r.causal || kp <= qp) && (r.window <= 0 || kp > qp - r.window);
      x = keep ? x : kNegInf;
    }
    p[j] = x;
    mx[h] = fmaxf(mx[h], x);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = ex2(m[h] - m_new);
    m[h] = m_new;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int h = (j >> 1) & 1;
    p[j] = ex2(p[j] - m[h]);
    l[h] += p[j];
  }
}

template <int D>
__global__ void __launch_bounds__(Tc<D>::THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                int Sq, int Skv, int Hq, int Hkv, int causal, int window, float softcap,
                float scale) {
  using namespace hopper;
  using C = Tc<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t k_ring = q_s + C::Q_BYTES;                   // K tile of stage s at + s KV_BYTES
  const uint32_t v_ring = k_ring + C::STAGES * C::KV_BYTES;   // V tile of stage s likewise
  const uint32_t q_bar = v_ring + C::STAGES * C::KV_BYTES;
  // barriers: q's, then for each stage K full, K empty, V full, V empty
  auto bar = [&](int kind, int s) { return q_bar + 8 * (1 + 4 * s + kind); };
  constexpr int K_FULL = 0, K_EMPTY = 1, V_FULL = 2, V_EMPTY = 3;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::TQ;   // the heaviest q tiles first
  const int hk = h / (Hq / Hkv);
  const int shift = Skv - Sq;                             // q_pos = row + shift
  // the live K/V tiles of the CTA's rows are one range [t_begin, t_end)
  const int pos_lo = q0 + shift, pos_hi = q0 + min(C::TQ, Sq - q0) - 1 + shift;
  const int n_kv = (Skv + kTK - 1) / kTK;
  const int first_key = pos_lo - window + 1;
  const int t_begin = window > 0 && first_key > 0 ? first_key / kTK : 0;
  const int t_end = causal ? min(n_kv, pos_hi / kTK + 1) : n_kv;
  const int n = t_end - t_begin;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar(K_FULL, s), 1);
      mbar_init(bar(V_FULL, s), 1);
      mbar_init(bar(K_EMPTY, s), C::CONSUMERS * 4);   // lane 0 of every consumer warp
      mbar_init(bar(V_EMPTY, s), C::CONSUMERS * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == C::CONSUMERS) {
    // ---- producer: one thread issues every TMA load, K then V of each tile ----
    if constexpr (C::CONSUMERS > 1) regs_dealloc<40>();
    if (threadIdx.x == C::CONSUMERS * 128) {
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      mbar_arrive_expect_tx(q_bar, C::Q_BYTES);
      for (int c = 0; c < C::NCB; ++c)
        tma_load_4d(q_s + c * C::TQ * C::RB, &qmap, q_bar, c * C::CB, h, q0, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % C::STAGES, use = i / C::STAGES, k0 = (t_begin + i) * kTK;
        if (use > 0) mbar_wait(bar(K_EMPTY, s), (use - 1) & 1);
        mbar_arrive_expect_tx(bar(K_FULL, s), C::KV_BYTES);
        for (int c = 0; c < C::NCB; ++c)
          tma_load_4d(k_ring + s * C::KV_BYTES + c * kTK * C::RB, &kmap, bar(K_FULL, s),
                      c * C::CB, hk, k0, b);
        if (use > 0) mbar_wait(bar(V_EMPTY, s), (use - 1) & 1);
        mbar_arrive_expect_tx(bar(V_FULL, s), C::KV_BYTES);
        for (int c = 0; c < C::NCB; ++c)
          tma_load_4d(v_ring + s * C::KV_BYTES + c * kTK * C::RB, &vmap, bar(V_FULL, s),
                      c * C::CB, hk, k0, b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: q rows q0 + 64 wg ... q0 + 64 wg + 63.
    // Tile i's S = q k^T is issued with tile i - 1's O += P V, and tile i's
    // softmax runs while the tensor cores do that P V.  The first and last
    // tiles are peeled off the loop: a wgmma issued under a branch makes
    // ptxas serialize them all. ----
    if constexpr (C::CONSUMERS > 1) regs_alloc<232>();
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int r0 = (tid / 32) * 16 + lane / 4;
    const int row0 = q0 + wg * kWgRows;
    RowCtx rc;
    rc.c1 = softcap > 0.f ? scale / softcap : scale * kLog2e;
    rc.c2 = softcap * kLog2e;
    rc.softcap = softcap;
    rc.Skv = Skv;
    rc.causal = causal;
    rc.window = window;
    rc.cq = 2 * (lane % 4);
    rc.qp0 = row0 + r0 + shift;
    rc.qp_min = row0 + shift;
    rc.qp_max = row0 + kWgRows - 1 + shift;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
    float o[C::OB][C::ON];
#pragma unroll
    for (int c = 0; c < C::OB; ++c)
#pragma unroll
      for (int j = 0; j < C::ON; ++j) o[c][j] = 0.f;
    uint32_t pa[4][4];   // the last tile's P in bf16: the A operands of four k16 steps
    float sc[32];        // one tile's S, then its P in f32
    const uint64_t dq = make_desc(q_s + wg * kWgRows * C::RB, 16, 8 * C::RB, C::SWIZZLE);

    // S = q k^T from stage s: D / 16 steps, each inside one swizzled row
    auto issue_qk = [&](int s) {
      const uint64_t dk = make_desc(k_ring + s * C::KV_BYTES, 16, 8 * C::RB, C::SWIZZLE);
      static_for<0, D / 16>([&](auto kk_) {
        constexpr int kk = decltype(kk_)::value;
        constexpr int blk = kk * 16 / C::CB, off = (kk * 16 % C::CB) * 2;
        wgmma_ss_m64n64k16<(blk * C::TQ * C::RB + off) / 16, (blk * kTK * C::RB + off) / 16>(
            sc, dq, dk, kk > 0);
      });
      wgmma_commit();
    };
    // O += P V from stage s; V is MN-major (its rows are the product's depth)
    auto issue_pv = [&](int s) {
      const uint64_t dv = make_desc(v_ring + s * C::KV_BYTES, kTK * C::RB, 8 * C::RB, C::SWIZZLE);
      static_for<0, 4>([&](auto kk_) {
        static_for<0, C::OB>([&](auto c_) {
          constexpr int kk = decltype(kk_)::value, c = decltype(c_)::value;
          constexpr int off = (c * kTK * C::RB + kk * 16 * C::RB) / 16;
          if constexpr (C::ON == 32)
            wgmma_rs_m64n64k16<off>(o[c], pa[kk], dv);
          else
            wgmma_rs_m64n32k16<off>(o[c], pa[kk], dv);
        });
      });
      wgmma_commit();
    };
    // P rounded to bf16 in the A operand's layout: the accumulator's,
    // regrouped (rows r0 and r0 + 8 by columns cq and cq + 8)
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    };

    mbar_wait(q_bar, 0);
    // the first tile: S, then its softmax
    mbar_wait(bar(K_FULL, 0), 0);
    wgmma_fence();
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(K_EMPTY, 0));
    softmax_tile(sc, m, l, alpha, t_begin * kTK, rc);
    pack();
    // steady state: S of tile i and P V of tile i - 1 in flight together
    for (int i = 1; i < n; ++i) {
      const int s = i % C::STAGES, sp = (i - 1) % C::STAGES;
      mbar_wait(bar(K_FULL, s), (i / C::STAGES) & 1);
      mbar_wait(bar(V_FULL, sp), ((i - 1) / C::STAGES) & 1);
#pragma unroll
      for (int c = 0; c < C::OB; ++c) fence_regs(o[c]);
      wgmma_fence();
      issue_qk(s);
      issue_pv(sp);
      wgmma_wait<1>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(K_EMPTY, s));
      softmax_tile(sc, m, l, alpha, (t_begin + i) * kTK, rc);
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < C::OB; ++c) fence_regs(o[c]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(V_EMPTY, sp));
#pragma unroll
      for (int c = 0; c < C::OB; ++c)
#pragma unroll
        for (int j = 0; j < C::ON; ++j) o[c][j] *= alpha[(j >> 1) & 1];
      pack();
    }
    {   // the last tile's P V
      const int sp = (n - 1) % C::STAGES;
      mbar_wait(bar(V_FULL, sp), ((n - 1) / C::STAGES) & 1);
#pragma unroll
      for (int c = 0; c < C::OB; ++c) fence_regs(o[c]);
      wgmma_fence();
      issue_pv(sp);
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < C::OB; ++c) fence_regs(o[c]);
    }

    // out = acc / max(l, 1e-30), the four shares of each row's l summed first
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float lr = fmaxf(l[r], 1e-30f);
      const int row = row0 + r0 + 8 * r;
      if (row >= Sq) continue;
      __nv_bfloat16* dst = out + ((size_t)b * Sq + row) * Hq * D + (size_t)h * D;
#pragma unroll
      for (int c = 0; c < C::OB; ++c)
#pragma unroll
        for (int g = 0; g < C::ON / 4; ++g)
          *reinterpret_cast<uint32_t*>(dst + c * 64 + 8 * g + rc.cq) =
              pack_bf16(o[c][4 * g + 2 * r] / lr, o[c][4 * g + 2 * r + 1] / lr);
    }
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// the driver's tensor-map encoder, found at run time (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a contiguous (B, S, H, D) bf16 tensor as a 4-D map (D, H, S, B) with boxes
// of (CB, 1, rows, 1); coordinates past S read as zeros
template <int D>
int tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int S, int H,
               int rows) {
  using C = Tc<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::CB, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            C::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
              int Hq, int Hkv, int causal, int window, float softcap, float scale,
              cudaStream_t stream) {
  using C = Tc<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  int err = tensor_map<D>(encode, &qm, q, B, Sq, Hq, C::TQ);
  if (!err) err = tensor_map<D>(encode, &km, k, B, Skv, Hkv, kTK);
  if (!err) err = tensor_map<D>(encode, &vm, v, B, Skv, Hkv, kTK);
  if (err) return err;
  auto kernel = flash_tc_kernel<D>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hq, B, (Sq + C::TQ - 1) / C::TQ);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(qm, km, vm, static_cast<__nv_bfloat16*>(out), Sq,
                                               Skv, Hq, Hkv, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

int dispatch_tc(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
                int Hq, int Hkv, int D, int causal, int window, float softcap, float scale,
                cudaStream_t s) {
  switch (D) {
    case 32: return launch_tc<32>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, softcap, scale, s);
    case 64: return launch_tc<64>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, softcap, scale, s);
    case 128: return launch_tc<128>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, softcap, scale, s);
    case 256: return launch_tc<256>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, softcap, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (the FFMA kernel), 1 = bfloat16 (the tensor-core
// kernel); q, k, v and out share it.  q and out are (B, Sq, Hq, D), k and v
// (B, Skv, Hkv, D), all contiguous; bf16 tensors start 16-byte aligned (TMA).
// The caller has checked shapes, Hq % Hkv == 0, D in {32, 64, 128, 256}, B
// and Hq <= 65535, and Sq <= Skv when causal.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                               int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
                               float softcap, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_tc(q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, scale, s);
  return dispatch<float>(q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, scale, s);
}
