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
// Both types run on the tensor cores.  The bound on this card is operations:
// one call does 4 * B * Hq * D flops per live (q, k) pair (about half of
// Sq * Skv under causal masking) and moves q, k, v in and o out once, ~1000
// flops a byte at D = 256, far above the ridge; the least time is those
// flops at the bf16 tensor-core peak (989 TFLOP/s; f32 below makes each
// product six bf16 ones), which only wgmma reaches.
//
//   * bf16 (the training path's type), flash_tc_kernel:
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
//   * f32, flash_f32_kernel: the same pipeline on bf16 pieces.  Every f32
//     operand x is split into x1 = rn_bf16(x), x2 = rn_bf16(x - x1) and x3 =
//     rn_bf16(x - x1 - x2) (each difference is exact in f32), and each
//     product a b is the six products of pieces that matter, summed smallest
//     first: a3 b1, a2 b2, a1 b3, a2 b1, a1 b2, a1 b1 (each exact in f32; the
//     dropped ones are ~2^-26 of a b, finer than 3xTF32's 2^-21).  Six bf16
//     products take the tensor time of three TF32 ones, and bf16 has what
//     tf32 lacks here: V (MN-major for P V) goes through the transpose bit,
//     and P's pieces come from the S accumulator in the register layout of
//     the A operand.  So:
//       - split_kv_kernel, a first launch, splits K and V once a call into
//         three bf16 planes each, (3, B, Skv, Hkv, D) in scratch the caller
//         gives: every K/V element is read by every q tile and every head of
//         its group, so it is split once, not on every read; TMA then loads
//         its tiles as it loads the bf16 kernel's, the piece in the map's
//         batch coordinate;
//       - each consumer warpgroup loads its 64 rows of q once with ordinary
//         f32 loads (any 4-byte alignment), multiplies them by the scale in
//         f32 as the reference does, splits them and stores the three pieces
//         with the swizzle wgmma reads (96 KB at D = 256);
//       - a K/V tile holds 32 keys.  At D = 256 q's three pieces and one
//         stage of the K and V rings fill 193 KB, so a K tile is refilled
//         while its S's softmax and P V run, a V tile while the next S
//         runs; two stages of 16-key tiles also fit, but their S wgmma,
//         m64n16, reads a 2 KB slab of q from shared memory for every 8
//         clocks of products and is ~25% slower end to end
//         (experiments/flash_f32_variants.py).  Below, two consumer
//         warpgroups share each tile, through two or more stages;
//       - S: six wgmma_ss a k16 step.  The tensor cores add each wgmma's
//         products with a rounding that leans toward zero (gemm_tf32x3.cuh),
//         so the depth is summed 32 at a time into a fresh partial sum that
//         is then added in f32 (two partials alternate, so that one run's
//         products overlap the previous run's addition);
//       - softcap (accurate tanhf), mask, -1e30 fill and the online softmax
//         as for bf16, in f32 registers; l sums the unrounded f32 p;
//       - P V: P split in registers into three pieces, six wgmma_rs a k16
//         step against V's pieces through the transpose bit, into a fresh
//         partial sum per 64 output columns, then o = fma(o, alpha, partial)
//         (the output accumulator is never a wgmma's);
//     tests/test_torch_flash_f32_numerics.py emulates this order on the CPU
//     (each wgmma's addition to nearest and toward zero) against the same
//     2e-5 gate as the kernel; three products (a1 b1, a1 b2, a2 b1) fail it
//     on sharp scores.  3xTF32 on this pipeline (V transposed by the split
//     pass and P through shared memory: tf32 wgmma has no transpose bit,
//     and its A fragment orders k unlike the accumulator) is slower
//     (experiments/flash_tf32x3.cuh).
//
// Every kernel that issues wgmma issues it unconditionally in straight-line
// code (a wgmma under a branch, a runtime scale, or an accumulator touched
// while its group is in flight make ptxas serialize them all).  Both skip
// a KV tile with no live (q, k) pair for any row of the CTA, as the TPU
// kernel's pl.when(needed) does.  A row that is wholly masked inside a live
// tile takes p = exp(-1e30 - m) = 0 once it has a live key, or weights
// exp(0) = 1 that the next live key's alpha = exp(-1e30 - m) = 0 wipes
// exactly: that holds only because the fill is finite.  Unlike the TPU
// kernel, Sq and Skv need not be multiples of a tile: rows past Sq are
// computed on zeros and not stored; keys past Skv load as zeros and are
// masked (a stored row has a live key, its own position, no later than the
// last tile, so its m is real there and they take p = 0).
//
// Head dims: the instances are compiled for D = 32, 64, 128 and 256, and a
// call of any head dim Dr % 8 == 0 up to 256 runs the least instance D >= Dr
// (zamba2's 80 and h2o-danube's 120 run the 128 one).  The tensor maps are
// Dr wide, so TMA fills a tile's columns past Dr with zeros: q k^T sums the
// same Dr products, P V writes zero columns past Dr, the epilogue stores
// only the first Dr, and the scale is the caller's (Dr ** -0.5).  The f32
// kernel's q rows load zeros past Dr likewise.  The rule Dr % 8 == 0 is
// TMA's: a row of Dr bf16 must be a multiple of 16 bytes.  A padded call
// costs what the instance it runs costs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (repro_torch/kernels/build.py; no -lcuda: the tensor-map encoder comes from
// cudaGetDriverEntryPoint).  The C entry launches on the given stream, never
// synchronises, allocates nothing and returns the CUDA error of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

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

// One S tile (TK keys) and its online softmax in registers, in place: the scores become
// p = exp2(x - m) of the scaled, capped and masked scores x (log2 units);
// m is the running row max, alpha its correction for the old sums, and l
// this thread's share of the row's sum.  Accumulator element j is row
// r0 + 8 ((j / 2) % 2), column 8 (j / 4) + cq + j % 2.
template <int TK>
__device__ __forceinline__ void softmax_tile(float (&p)[TK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, const RowCtx& r) {
  const bool edge = k0 + TK > r.Skv || (r.causal && k0 + TK - 1 > r.qp_min) ||
                    (r.window > 0 && k0 <= r.qp_max - r.window);
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < TK / 2; ++j) {
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
  for (int j = 0; j < TK / 2; ++j) {
    const int h = (j >> 1) & 1;
    p[j] = ex2(p[j] - m[h]);
    l[h] += p[j];
  }
}

template <int D>
__global__ void __launch_bounds__(Tc<D>::THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                int Sq, int Skv, int Hq, int Hkv, int Dr, int causal, int window, float softcap,
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
        wgmma_ss_kmajor<kTK, false, (blk * C::TQ * C::RB + off) / 16,
                        (blk * kTK * C::RB + off) / 16>(sc, dq, dk, kk > 0);
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
          wgmma_rs_mn<2 * C::ON, off>(o[c], pa[kk], dv, 1);
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
    softmax_tile<kTK>(sc, m, l, alpha, t_begin * kTK, rc);
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
      softmax_tile<kTK>(sc, m, l, alpha, (t_begin + i) * kTK, rc);
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
      __nv_bfloat16* dst = out + ((size_t)b * Sq + row) * Hq * Dr + (size_t)h * Dr;
#pragma unroll
      for (int c = 0; c < C::OB; ++c)
#pragma unroll
        for (int g = 0; g < C::ON / 4; ++g)
          if (c * 64 + 8 * g + rc.cq < Dr)   // the columns past Dr are zeros
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

// the compiled instance that runs head dim D: the least of 32, 64, 128 and
// 256 that holds it (D % 8 == 0, so that a row of D bf16 is a multiple of
// the 16 bytes TMA strides by); 0 for a D that none takes
int instance_dim(int D) {
  if (D < 8 || D > 256 || D % 8) return 0;
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

// a contiguous (B, S, H, Dr) bf16 tensor as a 4-D map (Dr, H, S, B) with
// boxes of (CB, 1, rows, 1) for instance D >= Dr; coordinates past S, and
// columns past Dr, read as zeros
template <int D>
int tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int S, int H,
               int Dr, int rows) {
  using C = Tc<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)Dr, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Dr * 2, (cuuint64_t)H * Dr * 2,
                                 (cuuint64_t)S * H * Dr * 2};
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
              int Hq, int Hkv, int Dr, int causal, int window, float softcap, float scale,
              cudaStream_t stream) {
  using C = Tc<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  int err = tensor_map<D>(encode, &qm, q, B, Sq, Hq, Dr, C::TQ);
  if (!err) err = tensor_map<D>(encode, &km, k, B, Skv, Hkv, Dr, kTK);
  if (!err) err = tensor_map<D>(encode, &vm, v, B, Skv, Hkv, Dr, kTK);
  if (err) return err;
  auto kernel = flash_tc_kernel<D>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hq, B, (Sq + C::TQ - 1) / C::TQ);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(qm, km, vm, static_cast<__nv_bfloat16*>(out), Sq,
                                               Skv, Hq, Hkv, Dr, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

int dispatch_tc(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
                int Hq, int Hkv, int D, int causal, int window, float softcap, float scale,
                cudaStream_t s) {
  switch (instance_dim(D)) {
    case 32: return launch_tc<32>(q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, scale, s);
    case 64: return launch_tc<64>(q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, scale, s);
    case 128: return launch_tc<128>(q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, scale, s);
    case 256: return launch_tc<256>(q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- f32: the same pipeline on bf16 pieces ----------------------------------

constexpr int kPieces = 3;
// the pieces of product j of the six that matter, smallest first (piece 0
// is x1): a3 b1, a2 b2, a1 b3, a2 b1, a1 b2, a1 b1
__host__ __device__ constexpr int piece_a(int j) { return j == 0 ? 2 : j == 1 || j == 3 ? 1 : 0; }
__host__ __device__ constexpr int piece_b(int j) { return j == 2 ? 2 : j == 1 || j == 4 ? 1 : 0; }
constexpr int kPromoteSteps = 2;   // k16 steps of S's depth between promotions: 32
constexpr int kSplitThreads = 256;

template <int D>
struct Tf {
  using T = Tc<D>;   // the swizzled tile layout, the bf16 kernel's
  // consumer warpgroups a CTA: at D = 256 one (its O takes 128 registers a
  // thread), below two that share each K/V tile
  static constexpr int CONSUMERS = D == 256 ? 1 : 2;
  static constexpr int TQ = kWgRows * CONSUMERS;           // q rows a CTA
  static constexpr int THREADS = 128 * (CONSUMERS + 1);    // and the producer warpgroup
  static constexpr int TK = 32;                            // keys a K/V tile
  static constexpr int STEPS = kPromoteSteps < D / 16 ? kPromoteSteps : D / 16;
  static constexpr int RUNS = D / 16 / STEPS;              // promotion runs of S
  static constexpr uint32_t Q_PIECE = TQ * D * 2;          // one bf16 piece of q
  static constexpr uint32_t KV_PIECE = TK * D * 2;         // one piece of a K or V tile
  static constexpr uint32_t KV_BYTES = kPieces * KV_PIECE; // a K or V tile
  // 1024 bytes of slack to align the swizzle atoms, q's pieces, then as many
  // stages of the K and V rings (up to 4) as fit (one at D = 256, two at
  // D = 128), and their four barriers
  static constexpr size_t FIXED = 1024 + kPieces * Q_PIECE;
  static constexpr int FIT = (232448 - FIXED - 4 * 4 * 8) / (2 * KV_BYTES);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr size_t SMEM = FIXED + (size_t)STAGES * 2 * KV_BYTES + 4 * STAGES * 8;
  static_assert(STAGES >= 1 && SMEM <= 232448, "a stage beside q's pieces");
};

// x ~ x1 + x2 + x3 in bf16 pieces: x1 = rn_bf16(x), x2 = rn_bf16(x - x1) and
// the rest, x - x1 - x2 (exact in f32), rounded to bf16 where it is packed
__device__ __forceinline__ void split3(float x, float (&p)[kPieces]) {
  p[0] = __bfloat162float(__float2bfloat16_rn(x));
  const float r = x - p[0];
  p[1] = __bfloat162float(__float2bfloat16_rn(r));
  p[2] = r - p[1];
}

// the 128 threads of consumer warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// K and V (n f32 elements each) into three bf16 planes each: piece p of
// element e at planes + p n + e, V's planes after K's
template <bool VEC>
__global__ void __launch_bounds__(kSplitThreads)
split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                __nv_bfloat16* __restrict__ planes, long long n) {
  const float* src = blockIdx.y == 0 ? k : v;
  __nv_bfloat16* dst = planes + blockIdx.y * kPieces * n;
  const long long step = 4LL * gridDim.x * kSplitThreads;
  for (long long i = 4LL * (blockIdx.x * kSplitThreads + threadIdx.x); i < n; i += step) {
    float x[4];
    if constexpr (VEC) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(src + i));
      x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = __ldg(src + i + e);
    }
    float a[4][kPieces];
#pragma unroll
    for (int e = 0; e < 4; ++e) split3(x[e], a[e]);
#pragma unroll
    for (int p = 0; p < kPieces; ++p)
      *reinterpret_cast<uint2*>(dst + p * n + i) =
          make_uint2(hopper::pack_bf16(a[0][p], a[1][p]), hopper::pack_bf16(a[2][p], a[3][p]));
  }
}

template <int D>
__global__ void __launch_bounds__(Tf<D>::THREADS, 1)
flash_f32_kernel(const float* __restrict__ q, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, float* __restrict__ out, int B, int Sq,
                 int Skv, int Hq, int Hkv, int Dr, int causal, int window, float softcap,
                 float scale, int q_vec) {
  using namespace hopper;
  using C = Tf<D>;
  using T = typename C::T;
  constexpr int TK = C::TK, NS = TK / 2;   // keys a tile, S registers a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t q_s = smem_addr(smem);                        // q's piece p at + p Q_PIECE
  const uint32_t k_ring = q_s + kPieces * C::Q_PIECE;          // K tile of stage s at + s KV_BYTES
  const uint32_t v_ring = k_ring + C::STAGES * C::KV_BYTES;    // V tile of stage s likewise
  const uint32_t bars = v_ring + C::STAGES * C::KV_BYTES;
  // barriers: for each stage K full, K empty, V full, V empty
  auto bar = [&](int kind, int s) { return bars + 8 * (4 * s + kind); };
  constexpr int K_FULL = 0, K_EMPTY = 1, V_FULL = 2, V_EMPTY = 3;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::TQ;   // the heaviest q tiles first
  const int hk = h / (Hq / Hkv);
  const int shift = Skv - Sq;                            // q_pos = row + shift
  // the live K/V tiles of the CTA's rows are one range [t_begin, t_end)
  const int pos_lo = q0 + shift, pos_hi = q0 + min(C::TQ, Sq - q0) - 1 + shift;
  const int n_kv = (Skv + TK - 1) / TK;
  const int first_key = pos_lo - window + 1;
  const int t_begin = window > 0 && first_key > 0 ? first_key / TK : 0;
  const int t_end = causal ? min(n_kv, pos_hi / TK + 1) : n_kv;
  const int n = t_end - t_begin;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
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
    // ---- producer: one thread issues every TMA load, the three pieces of
    // K, then of V, of each tile; piece p of batch b is the maps' batch
    // p B + b ----
    if constexpr (C::CONSUMERS > 1) regs_dealloc<40>();
    if (threadIdx.x == C::CONSUMERS * 128) {
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      for (int i = 0; i < n; ++i) {
        const int s = i % C::STAGES, use = i / C::STAGES, k0 = (t_begin + i) * TK;
        if (use > 0) mbar_wait(bar(K_EMPTY, s), (use - 1) & 1);
        mbar_arrive_expect_tx(bar(K_FULL, s), C::KV_BYTES);
        for (int p = 0; p < kPieces; ++p)
          for (int c = 0; c < T::NCB; ++c)
            tma_load_4d(k_ring + s * C::KV_BYTES + p * C::KV_PIECE + c * TK * T::RB, &kmap,
                        bar(K_FULL, s), c * T::CB, hk, k0, p * B + b);
        if (use > 0) mbar_wait(bar(V_EMPTY, s), (use - 1) & 1);
        mbar_arrive_expect_tx(bar(V_FULL, s), C::KV_BYTES);
        for (int p = 0; p < kPieces; ++p)
          for (int c = 0; c < T::NCB; ++c)
            tma_load_4d(v_ring + s * C::KV_BYTES + p * C::KV_PIECE + c * TK * T::RB, &vmap,
                        bar(V_FULL, s), c * T::CB, hk, k0, p * B + b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: q rows q0 + 64 wg ... q0 + 64 wg + 63 ----
    if constexpr (C::CONSUMERS > 1) regs_alloc<232>();
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int r0 = (tid / 32) * 16 + lane / 4;
    const int row0 = q0 + wg * kWgRows;

    // q's rows: 8 floats a thread at a time, scaled in f32, split, and each
    // piece's 16 bytes stored at their swizzled place; rows past Sq and
    // columns past Dr as zeros
    {
      constexpr int CH = D / 8;
      const float* qb = q + (size_t)b * Sq * Hq * Dr + (size_t)h * Dr;
      for (int i = tid; i < kWgRows * CH; i += 128) {
        const int r = i / CH, j = i % CH, row = row0 + r;
        float x[8];
        if (row < Sq && 8 * j < Dr) {
          const float* src = qb + (size_t)row * Hq * Dr + 8 * j;
          if (q_vec) {
            const float4 lo = __ldg(reinterpret_cast<const float4*>(src));
            const float4 hi = __ldg(reinterpret_cast<const float4*>(src) + 1);
            x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
            x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) x[e] = __ldg(src + e);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) x[e] = 0.f;
        }
        uint32_t w[kPieces][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float lo[kPieces], hi[kPieces];
          split3(__fmul_rn(x[2 * e], scale), lo);
          split3(__fmul_rn(x[2 * e + 1], scale), hi);
#pragma unroll
          for (int p = 0; p < kPieces; ++p) w[p][e] = pack_bf16(lo[p], hi[p]);
        }
        // 16-byte chunk cc of row rr of column block 8 j / CB, swizzled as
        // TMA would store it (gemm_tf32x3.cuh's swz)
        const int rr = wg * kWgRows + r, cc = (8 * j) % T::CB / 8;
        const int sw = T::RB == 128 ? (rr & 7) : ((rr >> 1) & 3);
        const uint32_t off = (8 * j / T::CB) * C::TQ * T::RB + rr * T::RB + ((cc ^ sw) << 4);
#pragma unroll
        for (int p = 0; p < kPieces; ++p)
          *reinterpret_cast<uint4*>(smem + p * C::Q_PIECE + off) =
              make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
      }
      fence_proxy_async();
      warpgroup_sync(wg);
    }

    RowCtx rc;
    rc.c1 = softcap > 0.f ? 1.f / softcap : kLog2e;   // q carries the scale
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
    float o[T::OB][T::ON];
#pragma unroll
    for (int c = 0; c < T::OB; ++c)
#pragma unroll
      for (int j = 0; j < T::ON; ++j) o[c][j] = 0.f;
    float sc[NS];                        // the tile's S, then its P
    float sp[2][NS];                     // two promotion runs' partial sums
    float part[T::ON];                   // P V's partial sum for 64 columns of O
    uint32_t pa[kPieces][TK / 16][4];    // P's pieces: the A operands of its k16 steps
    const uint64_t dq = make_desc(q_s + wg * kWgRows * T::RB, 16, 8 * T::RB, T::SWIZZLE);

    // promotion run R of S: its k16 steps, six products each, into a fresh
    // sp[R % 2]; offsets in 16-byte units (a piece further, a column block
    // further, 32 bytes along the swizzled row a k16 step)
    auto issue_run = [&](auto run, uint64_t dk) {
      constexpr int R = decltype(run)::value;
      static_for<0, C::STEPS>([&](auto st_) {
        constexpr int st = decltype(st_)::value, kk = R * C::STEPS + st;
        constexpr int blk = kk * 16 / T::CB, off = (kk * 16 % T::CB) * 2;
        static_for<0, 6>([&](auto j_) {
          constexpr int j = decltype(j_)::value;
          constexpr int oa = (piece_a(j) * C::Q_PIECE + blk * C::TQ * T::RB + off) / 16;
          constexpr int ob = (piece_b(j) * C::KV_PIECE + blk * TK * T::RB + off) / 16;
          wgmma_ss_kmajor<TK, false, oa, ob>(sp[R & 1], dq, dk, st > 0 || j > 0);
        });
      });
      wgmma_commit();
    };
    // run R's partial sum, once its group is done, into the f32 S
    auto fold = [&](auto run) {
      constexpr int R = decltype(run)::value;
      fence_regs(sp[R & 1]);
#pragma unroll
      for (int j = 0; j < NS; ++j) sc[j] = R == 0 ? sp[0][j] : sc[j] + sp[R & 1][j];
    };
    // S = q k^T from stage s, run R + 1 in flight while run R is folded
    auto qk = [&](int s) {
      const uint64_t dk = make_desc(k_ring + s * C::KV_BYTES, 16, 8 * T::RB, T::SWIZZLE);
      wgmma_fence();
      issue_run(std::integral_constant<int, 0>{}, dk);
      static_for<1, C::RUNS>([&](auto run) {
        wgmma_fence();
        issue_run(run, dk);
        wgmma_wait<1>();
        fold(std::integral_constant<int, decltype(run)::value - 1>{});
      });
      wgmma_wait<0>();
      fold(std::integral_constant<int, C::RUNS - 1>{});
    };
    // P (the accumulator's layout, regrouped as bf16 A operands) in pieces
    auto split_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float lo[kPieces], hi[kPieces];
          split3(sc[8 * kk + 2 * e], lo);
          split3(sc[8 * kk + 2 * e + 1], hi);
#pragma unroll
          for (int p = 0; p < kPieces; ++p) pa[p][kk][e] = pack_bf16(lo[p], hi[p]);
        }
    };
    // O = alpha O + P V from stage s, 64 columns (32 at D = 32) at a time:
    // the six products of each k16 step into a fresh partial sum, added
    // once its group is done; V is MN-major (its rows are the depth)
    auto pv = [&](int s) {
      const uint64_t dv = make_desc(v_ring + s * C::KV_BYTES, TK * T::RB, 8 * T::RB, T::SWIZZLE);
      static_for<0, T::OB>([&](auto c_) {
        constexpr int c = decltype(c_)::value;
        wgmma_fence();
        static_for<0, TK / 16>([&](auto kk_) {
          constexpr int kk = decltype(kk_)::value;
          static_for<0, 6>([&](auto j_) {
            constexpr int j = decltype(j_)::value;
            constexpr int a = piece_a(j);
            constexpr int ob = (piece_b(j) * C::KV_PIECE + c * TK * T::RB + kk * 16 * T::RB) / 16;
            wgmma_rs_mn<2 * T::ON, ob>(part, pa[a][kk], dv, kk > 0 || j > 0);
          });
        });
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int j = 0; j < T::ON; ++j) o[c][j] = fmaf(o[c][j], alpha[(j >> 1) & 1], part[j]);
      });
    };

    for (int i = 0; i < n; ++i) {
      const int s = i % C::STAGES;
      const uint32_t parity = (i / C::STAGES) & 1;
      mbar_wait(bar(K_FULL, s), parity);
      qk(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(K_EMPTY, s));
      softmax_tile<TK>(sc, m, l, alpha, (t_begin + i) * TK, rc);
      split_p();
      mbar_wait(bar(V_FULL, s), parity);
      pv(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(V_EMPTY, s));
    }

    // out = acc / max(l, 1e-30), the four shares of each row's l summed first
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float lr = fmaxf(l[r], 1e-30f);
      const int row = row0 + r0 + 8 * r;
      if (row >= Sq) continue;
      float* dst = out + ((size_t)b * Sq + row) * Hq * Dr + (size_t)h * Dr;
#pragma unroll
      for (int c = 0; c < T::OB; ++c)
#pragma unroll
        for (int g = 0; g < T::ON / 4; ++g)
          if (c * 64 + 8 * g + rc.cq < Dr)   // the columns past Dr are zeros
            *reinterpret_cast<float2*>(dst + c * 64 + 8 * g + rc.cq) =
                make_float2(o[c][4 * g + 2 * r] / lr, o[c][4 * g + 2 * r + 1] / lr);
    }
  }
}

// the split pass, then the attention on its planes (two launches)
template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* planes, void* out, int B,
               int Sq, int Skv, int Hq, int Hkv, int Dr, int causal, int window, float softcap,
               float scale, cudaStream_t stream) {
  using C = Tf<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const long long n = (long long)B * Skv * Hkv * Dr;
  auto* kp = static_cast<__nv_bfloat16*>(planes);
  CUtensorMap km, vm;
  int err = tensor_map<D>(encode, &km, kp, kPieces * B, Skv, Hkv, Dr, C::TK);
  if (!err) err = tensor_map<D>(encode, &vm, kp + kPieces * n, kPieces * B, Skv, Hkv, Dr, C::TK);
  if (err) return err;
  const long long chunks = (n / 4 + kSplitThreads - 1) / kSplitThreads;
  const dim3 split_grid((unsigned)(chunks < 2048 ? chunks : 2048), 2);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  if (aligned(k) && aligned(v))
    split_kv_kernel<true><<<split_grid, kSplitThreads, 0, stream>>>(kf, vf, kp, n);
  else
    split_kv_kernel<false><<<split_grid, kSplitThreads, 0, stream>>>(kf, vf, kp, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto kernel = flash_f32_kernel<D>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hq, B, (Sq + C::TQ - 1) / C::TQ);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(static_cast<const float*>(q), km, vm,
                                               static_cast<float*>(out), B, Sq, Skv, Hq, Hkv, Dr,
                                               causal, window, softcap, scale, (int)aligned(q));
  return (int)cudaGetLastError();
}

int dispatch_f32(const void* q, const void* k, const void* v, void* planes, void* out, int B,
                 int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window, float softcap,
                 float scale, cudaStream_t s) {
  switch (instance_dim(D)) {
    case 32: return launch_f32<32>(q, k, v, planes, out, B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, scale, s);
    case 64: return launch_f32<64>(q, k, v, planes, out, B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, scale, s);
    case 128: return launch_f32<128>(q, k, v, planes, out, B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, scale, s);
    case 256: return launch_f32<256>(q, k, v, planes, out, B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; q, k, v and out share it.  q and out
// are (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), all contiguous.  bf16
// tensors start 16-byte aligned (TMA); f32 ones need 4 bytes, and the f32
// path takes `planes`, scratch of 6 B Skv Hkv D bf16 elements starting
// 16-byte aligned (the split K and V), which the bf16 path ignores.  The
// caller has checked shapes, Hq % Hkv == 0, D % 8 == 0 and 8 <= D <= 256, B
// and Hq <= 65535, and Sq <= Skv when causal.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* planes,
                               void* out, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                               int causal, int window, float softcap, float scale, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_tc(q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, scale, s);
  return dispatch_f32(q, k, v, planes, out, B, Sq, Skv, Hq, Hkv, D, causal, window, softcap,
                      scale, s);
}
