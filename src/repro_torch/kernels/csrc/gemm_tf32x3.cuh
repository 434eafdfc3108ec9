// The mainloop that the blocked GEMM (blocked_matmul.cu) and the direct conv
// (conv2d.cu) share: one (BM x BN) f32 output tile of C = A B on the tensor
// cores of an sm_90a card, A (M x K) given by a row loader, B (K x N)
// row-major in device memory.  The two kernels differ only in how a row of
// A is loaded: a dense row of the GEMM's A, or an im2col row gathered from
// the conv's NHWC input.
//
// f32 inputs run 3xTF32.  Each operand x is split into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi) (x - hi is exact in f32), and every k8 step adds
// a_lo b_hi, then a_hi b_lo, then a_hi b_hi to an f32 partial sum; the
// dropped a_lo b_lo is 2^-22 of the product.  A tf32 wgmma reads an f32's
// top 19 bits, so hi is rounded explicitly: fed raw, x would be truncated.
// bf16 inputs run one bf16 wgmma a k16 step: their products are exact in
// f32 and need no split.
//
// Promotion.  The tensor cores add each wgmma's products to the accumulator
// with a rounding that leans toward zero, so over VGG-A's convs (K*K*C up to
// 4608, 1728 such additions) the error reaches 3.5e-5 of the output's
// scale, over the 2e-5 gate (experiments/tf32x3_variants.py on an H100;
// tests/test_torch_tf32x3_numerics.py models it).  So the wgmmas sum 32 of
// the depth at a time (a stage at least) into a fresh partial sum (the
// first wgmma of a run does not add), which is then added to the thread's
// f32 sum with an ordinary rounded FADD.  What leaning remains shrinks
// every output by a relative ~1.9e-7 (3.7e-7 at runs of 64, 7.5e-7 at 128,
// 1.4e-5 unpromoted), in proportion to the run's length, for ~3% more conv
// time than runs of 64 (the same script).
//
// Layout.  A tf32 wgmma has no transpose bit, so both shared-memory operands
// are K-major: each row of a tile (an m of A, an n of B) holds ROW bytes of
// the product's depth, eight rows an atom with the ROW-byte swizzle (16-byte
// chunk c of row r at chunk c ^ (r % 8) for 128-byte rows, c ^ ((r / 2) % 4)
// for 64-byte rows).  ROW is 128 (32 f32 or 64 bf16 a stage) at the 128 x 128
// tile, whose two sums leave one CTA an SM and so want more of the depth in
// flight, and 64 at the smaller tiles, which fit two CTAs an SM.  A stage
// holds A_hi, A_lo, B_hi, B_lo (bf16: A, B); three stages rotate.
//
// Loads.  Every operand passes through registers on its way into shared
// memory, since it is split there (bf16 too, to be transposed): all 256
// threads load the next stage's global data into registers during the
// current stage's products, split it and store it swizzled.  A's rows are
// K-contiguous: 16-byte loads where the rows are 16-byte aligned, else one
// element at a time.  B is N-contiguous in device memory and K-major in
// shared memory: a thread loads the 4 (8) consecutive k of one n, one
// element at a time (each load coalesced across the warp along n), and
// stores them as one 16-byte chunk.  Rows past M, columns past N and depth
// past K load zeros, so any M, N and K run; no TMA, whose 16-byte stride
// rule CD-DNN's shapes meet but the ragged ones do not, and whose tiles
// would need a second pass through shared memory to be split.
//
// Pipeline, per stage t: barrier; issue stage t's wgmmas and commit; store
// the registers (stage t + 1's data) into ring slot (t + 1) % 3; load stage
// t + 2 into the registers; wait until at most one group is in flight.  Slot
// (t + 1) % 3 was last read by stage t - 2's group, which both warpgroups
// saw complete before the barrier (the wait of stage t - 1).  At the end of
// a run (32 of the depth, or one stage where a stage is deeper) the wait is
// for every group, and the partial sum is promoted.  The wgmmas are issued
// unconditionally in straight-line code (a wgmma under a branch makes ptxas
// serialize them all), the first stage of a run peeled so that their scale
// is a constant, and the partial sum is read only after the wait for every
// group.
//
// Threads: two warpgroups.  BM = 128: each takes 64 rows and all BN columns;
// BM = 64: each takes the 64 rows and BN / 2 columns.  The 128 x 128 tile
// (64 + 64 sums a thread, ~250 registers) runs one CTA an SM, the others
// two.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace tc_gemm {

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kPromoteDepth = 32;    // depth the wgmmas sum before a promotion

// byte offset of 16-byte chunk c of row r in a tile of ROW-byte rows
template <int ROW>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  const int x = ROW == 128 ? (r & 7) : ((r >> 1) & 3);
  return static_cast<uint32_t>(r * ROW + ((c ^ x) << 4));
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x));
}
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 ld(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// elements of T in a 16-byte chunk, packed into 4 words little-end first
template <typename T>
struct Chunk {
  static constexpr int E = 16 / sizeof(T);
  uint32_t w[E];
  __device__ __forceinline__ uint4 pack() const {
    if constexpr (E == 4) {
      return make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      return make_uint4(w[0] | (w[1] << 16), w[2] | (w[3] << 16), w[4] | (w[5] << 16),
                        w[6] | (w[7] << 16));
    }
  }
};

template <typename T, int BM, int BN>
struct Cfg {
  static constexpr bool TF32 = sizeof(T) == 4;
  static constexpr int E = 16 / sizeof(T);                // elements a chunk
  static constexpr int ROW = BM == 128 && BN == 128 ? 128 : 64;   // bytes a tile row
  static constexpr int MIN_CTAS = ROW == 128 ? 1 : 2;    // CTAs an SM (__launch_bounds__)
  static constexpr int CHUNKS = ROW / 16;                 // its 16-byte chunks
  static constexpr uint32_t SWIZZLE = ROW == 128 ? 1 : 2; // descriptor code
  static constexpr int BK = ROW / sizeof(T);              // depth a stage
  static constexpr int KSTEP = TF32 ? 8 : 16;             // depth a wgmma
  static constexpr int PARTS = TF32 ? 2 : 1;              // hi and lo, or the value
  static constexpr int WG_N = BM == 128 ? BN : BN / 2;    // columns a warpgroup's wgmma covers
  static constexpr int ACC = WG_N / 2;                    // accumulator registers a thread
  static constexpr int PROMOTE =                          // stages between promotions
      kPromoteDepth > BK ? kPromoteDepth / BK : 1;
  static constexpr uint32_t A_BYTES = BM * ROW;           // one part of the A tile
  static constexpr uint32_t B_BYTES = BN * ROW;
  static constexpr uint32_t STAGE = PARTS * (A_BYTES + B_BYTES);
  static constexpr size_t SMEM = 1024 + kStages * STAGE;  // slack to align the atoms
  static constexpr int A_LOADS = BM * CHUNKS / kThreads;  // chunks a thread loads
  static constexpr int B_LOADS = BN * CHUNKS / kThreads;
  static constexpr int A_ROW_STEP = kThreads / CHUNKS;    // rows one round of A loads covers
  static constexpr int B_COL_STEP = kThreads / BN;        // chunk columns one round of B covers
  static_assert(BM == 64 || BM == 128, "BM in {64, 128}");
  static_assert(BN == 64 || BN == 128, "BN in {64, 128}");
  static_assert((PROMOTE & (PROMOTE - 1)) == 0, "promotion interval a power of two");
  static_assert(SMEM <= (ROW == 128 ? 232448 : 232448 / 2), "CTAs an SM");
};

// A's rows are dense: row m of A at a + m K.  This thread loads one chunk
// column of rows m_first + step i.
template <typename T, int LOADS>
struct DenseRows {
  static constexpr int E = 16 / sizeof(T);
  const T* rows[LOADS];
  bool live[LOADS];
  int K;
  bool vec;   // rows 16-byte aligned: K % E == 0 and a aligned

  __device__ __forceinline__ DenseRows(const T* a, long long M, int K_, bool vec_,
                                       long long m_first, int step)
      : K(K_), vec(vec_) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const long long m = m_first + static_cast<long long>(step) * i;
      live[i] = m < M;
      rows[i] = a + (live[i] ? m : 0) * K;
    }
  }

  // the chunk of E elements from depth k of each of the thread's rows
  __device__ __forceinline__ void load(int k, uint4 (&out)[LOADS]) const {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      if (vec) {
        out[i] = live[i] && k < K ? __ldg(reinterpret_cast<const uint4*>(rows[i] + k))
                                  : make_uint4(0, 0, 0, 0);
      } else {
        Chunk<T> c;
#pragma unroll
        for (int j = 0; j < E; ++j) c.w[j] = live[i] && k + j < K ? bits(ld(rows[i] + k + j)) : 0u;
        out[i] = c.pack();
      }
    }
  }
};

// the 16-byte chunk B[k .. k + E - 1][n] of row-major B (K x N), zeros past
// the edges
template <typename T>
__device__ __forceinline__ uint4 load_b_chunk(const T* b, int k, int K, int N, int n) {
  Chunk<T> c;
  const bool col = n < N;
#pragma unroll
  for (int j = 0; j < Chunk<T>::E; ++j)
    c.w[j] = col && k + j < K ? bits(ld(b + static_cast<long long>(k + j) * N + n)) : 0u;
  return c.pack();
}

// store one chunk of raw data into a tile's parts: f32 split into hi (part
// 0) and lo (part 1, part_bytes further), bf16 as it is
template <bool TF32>
__device__ __forceinline__ void put(uint8_t* part0, uint32_t part_bytes, uint32_t off, uint4 v) {
  if constexpr (TF32) {
    const float x[4] = {__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
                        __uint_as_float(v.w)};
    float hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      hi[j] = hopper::tf32_rna(x[j]);
      lo[j] = hopper::tf32_rna(x[j] - hi[j]);
    }
    *reinterpret_cast<float4*>(part0 + off) = make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(part0 + part_bytes + off) = make_float4(lo[0], lo[1], lo[2], lo[3]);
  } else {
    *reinterpret_cast<uint4*>(part0 + off) = v;
  }
}

// One output tile: C[m0 .., n0 ..] (row-major, M rows and N columns in all)
// = A B over depth K.  `rows` loads A (DenseRows or the conv's gather), built
// for rows m0 + tid / CHUNKS + A_ROW_STEP i.
template <typename T, int BM, int BN, typename Rows>
__device__ __forceinline__ void tile(uint8_t* smem_raw, const Rows& rows, const T* __restrict__ b,
                                     float* __restrict__ c, long long M, int N, int K,
                                     long long m0, int n0) {
  using C = Cfg<T, BM, BN>;
  using namespace hopper;
  // the atoms' swizzle is a function of the address: align the ring to 1024
  uint8_t* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t s0 = smem_addr(smem);
  const int tid = threadIdx.x;
  const int wg = tid / 128;

  // loaders: A chunk column a_col of rows a_row + A_ROW_STEP i; B column
  // b_n, chunk columns b_col + B_COL_STEP i
  const int a_col = tid % C::CHUNKS;
  const int a_row = tid / C::CHUNKS;
  const int b_n = tid % BN;
  const int b_col = tid / BN;
  uint4 ra[C::A_LOADS], rb[C::B_LOADS];
  auto load = [&](int t) {
    const int k0 = t * C::BK;
    rows.load(k0 + a_col * C::E, ra);
#pragma unroll
    for (int i = 0; i < C::B_LOADS; ++i)
      rb[i] = load_b_chunk(b, k0 + (b_col + C::B_COL_STEP * i) * C::E, K, N, n0 + b_n);
  };
  auto store = [&](int slot) {
    uint8_t* st = smem + slot * C::STAGE;
#pragma unroll
    for (int i = 0; i < C::A_LOADS; ++i)
      put<C::TF32>(st, C::A_BYTES, swz<C::ROW>(a_row + C::A_ROW_STEP * i, a_col), ra[i]);
#pragma unroll
    for (int i = 0; i < C::B_LOADS; ++i)
      put<C::TF32>(st + C::PARTS * C::A_BYTES, C::B_BYTES,
                   swz<C::ROW>(b_n, b_col + C::B_COL_STEP * i), rb[i]);
    fence_proxy_async();
  };

  // this warpgroup's operands inside a stage: its 64 rows of A, its WG_N
  // rows of B
  const uint32_t a_off = BM == 128 ? wg * 64 * C::ROW : 0;
  const uint32_t b_off = C::PARTS * C::A_BYTES + (BM == 128 ? 0 : wg * C::WG_N * C::ROW);
  float acc[C::ACC];    // the f32 sum
  float part[C::ACC];   // the wgmmas' partial sum since the last promotion
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) acc[i] = part[i] = 0.f;

  // a stage's products; offsets in 16-byte units: lo parts one part
  // further, each k step 32 bytes along the row.  The first product of a
  // run (FRESH) overwrites the partial sum.
  auto issue = [&](int slot, auto fresh) {
    constexpr bool FRESH = decltype(fresh)::value;
    const uint32_t st = s0 + slot * C::STAGE;
    const uint64_t da = make_desc(st + a_off, 16, 8 * C::ROW, C::SWIZZLE);
    const uint64_t db = make_desc(st + b_off, 16, 8 * C::ROW, C::SWIZZLE);
    static_for<0, C::BK / C::KSTEP>([&](auto kk_) {
      constexpr int kk = decltype(kk_)::value * 2;
      constexpr int add = kk > 0 || !FRESH;
      if constexpr (C::TF32) {
        constexpr int lo_a = C::A_BYTES / 16, lo_b = C::B_BYTES / 16;
        wgmma_ss_kmajor<C::WG_N, true, lo_a + kk, kk>(part, da, db, add);
        wgmma_ss_kmajor<C::WG_N, true, kk, lo_b + kk>(part, da, db, 1);
        wgmma_ss_kmajor<C::WG_N, true, kk, kk>(part, da, db, 1);
      } else {
        wgmma_ss_kmajor<C::WG_N, false, kk, kk>(part, da, db, add);
      }
    });
  };

  const int n_stages = (K + C::BK - 1) / C::BK;
  int slot = 0;
  // stage t: its products, then stage t + 1 into the ring and stage t + 2
  // into the registers
  auto step = [&](int t, auto fresh) {
    __syncthreads();   // slot t % 3 stored and fenced by every thread
    fence_regs(part);
    wgmma_fence();
    issue(slot, fresh);
    wgmma_commit();
    fence_regs(part);
    slot = slot == kStages - 1 ? 0 : slot + 1;
    if (t + 1 < n_stages) store(slot);
    if (t + 2 < n_stages) load(t + 2);
    wgmma_wait<1>();
    fence_regs(part);
  };
  load(0);
  store(0);
  if (n_stages > 1) load(1);
  // runs of PROMOTE stages, each promoted once its wgmmas are done; the
  // first stage of a run is peeled so that the wgmmas' scale is constant
  for (int t = 0; t < n_stages;) {
    const int end = min(t + C::PROMOTE, n_stages);
    step(t++, std::true_type{});
    for (; t < end; ++t) step(t, std::false_type{});
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) acc[i] += part[i];
  }

  // accumulator element j: row r0 + 8 ((j / 2) % 2), column 8 (j / 4) +
  // 2 (lane % 4) + j % 2 of the warpgroup's 64 x WG_N block
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const long long r0 = m0 + (BM == 128 ? wg * 64 : 0) + warp * 16 + lane / 4;
  const int c0 = n0 + (BM == 128 ? 0 : wg * C::WG_N) + 2 * (lane % 4);
  const bool pairs = (N % 2) == 0;   // rows of C start 8-byte aligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = r0 + 8 * h;
    if (r >= M) continue;
    float* out = c + r * N;
#pragma unroll
    for (int j = 0; j < C::WG_N / 8; ++j) {
      const int col = c0 + 8 * j;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pairs && col + 1 < N) {
        *reinterpret_cast<float2*>(out + col) = make_float2(v0, v1);
      } else {
        if (col < N) out[col] = v0;
        if (col + 1 < N) out[col + 1] = v1;
      }
    }
  }
}

// Launch `kernel` (grid, 256 threads) with the dynamic shared memory of
// Cfg<T, BM, BN> on `stream`; returns cudaGetLastError().
template <typename T, int BM, int BN, typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, cudaStream_t stream, Args... args) {
  constexpr size_t smem = Cfg<T, BM, BN>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc_gemm
