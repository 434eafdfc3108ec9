// Direct NHWC x HWIO convolution for NVIDIA Hopper (sm_90a), f32.
//
// Replaces the TPU kernel src/repro/kernels/conv2d.py::conv2d_nhwc (Pallas body
// _conv_kernel) and computes what it computes:
//   out[n, oh, ow, f] = sum_{kh, kw, c} xpad[n, oh*s + kh, ow*s + kw, c] * w[kh, kw, c, f]
// in f32, for any square kernel K, stride s and symmetric zero pad p; xpad is x
// with p zeros on each side of H and W.
//
// Design, and what changed from the TPU kernel:
//   * The conv is an implicit GEMM.  Rows are the M = N*OH*OW output pixels,
//     columns the F output channels, and the reduction runs over
//     K_gemm = K*K*C taps ordered (kh, kw, c).  HWIO weights already are the
//     row-major (K_gemm, F) B matrix.  A's rows are gathered from NHWC x on the
//     fly; with channels innermost, consecutive k of one row are consecutive
//     addresses whenever they share a tap (kh, kw).
//   * The products run on the tensor cores as 3xTF32 (each operand split into
//     a tf32 hi and lo, three wgmma products a k8 step, f32 accumulation, the
//     partial sum promoted into an f32 sum every 32 of the depth:
//     gemm_tf32x3.cuh states the arithmetic and its error).
//   * Zero padding is a predicate on each gathered chunk: nothing padded is
//     written to device memory (the TPU wrapper pads x with jnp.pad first).
//   * The TPU grid carries a resident output block across its sequential ifm
//     axis.  Here each block owns 128 x BN tiles of the output and loops over
//     the whole reduction itself.
//   * Offsets into x and out are 64-bit: at batch 64 VGG-A conv1's output
//     alone holds 205 M elements.
//
// Two instances, chosen by the input's shape (conv2d_nhwc_ws_f32 refuses what
// the first does not take; kernels/conv2d.py's path() is the rule):
//
// conv2d_nhwc_kernel_ws, where the gather is 16-byte vectorised (C % 4 == 0,
// x 16-byte aligned) and K_gemm is at least one 16-deep stage: every layer but
// the first of VGG-A and OverFeat-FAST, and their model-way shards.  A
// warp-specialised pipeline:
//   * conv2d_nhwc_kernel_split_w, a pre-pass, splits w once a call into hi =
//     rna_tf32(w) and lo = rna_tf32(w - hi) (put's arithmetic), K-major, as
//     (2, F, K_gemm) in scratch the caller allocates on every call: the
//     optimizer updates w in place between calls, so no split outlives its
//     call.
//   * A block is three warpgroups.  The producer (setmaxnreg down to 96)
//     gathers A's rows with 16-byte loads, two stages in registers ahead,
//     each thread walking its chunks' tap a stage at a time (TapRows: no
//     division a stage, which took ~45% more time), splits them and stores
//     hi and lo swizzled; one of its threads brings the stage's B hi and lo
//     tiles in by TMA (64-byte swizzle, the layout wgmma reads; zeros past F
//     and past K_gemm).  Two consumers (setmaxnreg up to 200; ptxas keeps
//     the whole kernel within the 168 registers a thread that its launch
//     bounds give, so that is headroom), rows 0-63 and 64-127 of the
//     128 x BN tile, only issue wgmmas, promote and store.
//   * Six 16-deep stages rotate, each with a full mbarrier (lane 0 of each
//     producer warp once the warp's stores are fenced, and the TMA's bytes)
//     and an empty one (lane 0 of each consumer warp, once its wgmmas have
//     read the stage); no __syncthreads in the mainloop.  The depth is
//     padded with zero stages to whole runs of 32, so a run is two stages
//     in straight-line code.
//   * The promotion's drain is hidden by taking turns (ping-pong on one
//     tile's two halves): through two named barriers the consumers issue
//     their runs alternately, so one consumer waits for its wgmmas and adds
//     its partial sum while the tensor cores run the other's run.  Bound:
//     the tensor cores idle only where one consumer's wait, BN / 2 FADDs a
//     thread a run and next issue outlast the other's run (12 wgmmas, 768
//     clocks at the dense TF32 peak at BN = 128).  At that peak the block
//     reads (4 / BN + 8 / 128) x 1024 / 3 = 32 bytes a clock from L2 at
//     BN = 128 (x gathered once a column tile, B's two parts once a row
//     tile), where the tiled instance read 21.  On an H100 the products
//     alone and the producer alone each take ~1.26x the 3xTF32 bound, the
//     two together ~1.7x (PERF.md).
//   * Two producer warpgroups (spilled), a cp.async ring of x ahead of the
//     split and 2-block clusters sharing B by TMA multicast were each timed
//     and lost to this pipeline (PERF.md has the readings).
//   * Persistent: one block an SM walks the tiles, the column tiles of a row
//     tile in turn, so the producer fills the next tile's stages while the
//     consumers store this tile's outputs.
//   * BN = 128 where F > 64, else 64: F = 96 runs one tile with a quarter of
//     its columns zero, F = 130 two, a 64-wide shard one full 64-wide tile.
//     Columns past F are computed on TMA's zeros and not stored.
//
// conv2d_nhwc_kernel<BN> (conv1 of both nets, C = 3, and anything else):
// the mainloop the kernel shares with the blocked GEMM (gemm_tf32x3.cuh,
// which states the layout, the loads and the pipeline), one 128 x BN tile a
// block (BN = 128 where F >= 128, else 64), with the conv's own row loader
// (Im2colRows): one 16-byte load a chunk where C % 4 == 0 and x is aligned,
// else one 4-byte load a tap (VGG-A conv1: K_gemm = 27; OverFeat conv1:
// 11x11, stride 4, K_gemm = 363), zeros past K_gemm.  VGG-A conv1 is bound
// by bytes, about 2.5 ms of a batch-256 forward.
//
// Bound on this card, per call: the larger of
//   3 x 2 * N*OH*OW * F * K*K*C tf32 operations / 494.7 TFLOP/s (the data
//   sheet's dense TF32 rate) and
//   4 B * (|x| + |w| + |out|) / 3.35 TB/s.
// At batch 256 VGG-A's convs 2-8 are bound by operations, 22.97 ms for the
// seven a forward pass.  Their times are in PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (repro_torch/kernels/build.py; no -lcuda: the tensor-map encoder comes from
// cudaGetDriverEntryPoint).  The C entries launch on the given stream, never
// synchronise, allocate nothing and return the CUDA error of the launch.

#include <cuda_runtime.h>

#include "gemm_tf32x3.cuh"

namespace {

constexpr int kBM = 128;            // output pixels per block
constexpr int kNoRow = -(1 << 30);  // input row of a pixel past M: never inside the image

// A's rows gathered from NHWC x: row m is output pixel (n, oh, ow), depth k
// the tap (kh, kw, c) with k = (kh K + kw) C + c.  This thread loads the
// chunk of 4 taps from depth k of pixels m_first + step i.
template <int LOADS>
struct Im2colRows {
  const float* x;
  int H, W, C, K, Kg;
  bool vec;   // C % 4 == 0 and x 16-byte aligned: a chunk is one 16-byte load
  long long img[LOADS];   // offset of the pixel's image
  int ih0[LOADS], iw0[LOADS];   // its top-left input corner, kNoRow past M

  __device__ __forceinline__ Im2colRows(const float* x_, int H_, int W_, int C_, int K_,
                                        int stride, int pad, int OH, int OW, long long M,
                                        bool vec_, long long m_first, int step)
      : x(x_), H(H_), W(W_), C(C_), K(K_), Kg(K_ * K_ * C_), vec(vec_) {
    const long long ohw = static_cast<long long>(OH) * OW;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const long long m = m_first + static_cast<long long>(step) * i;
      if (m < M) {
        const long long n = m / ohw;
        const int rem = static_cast<int>(m - n * ohw);
        const int oh = rem / OW, ow = rem - (rem / OW) * OW;
        img[i] = n * H * W * C;
        ih0[i] = oh * stride - pad;
        iw0[i] = ow * stride - pad;
      } else {
        img[i] = 0;
        ih0[i] = kNoRow;
        iw0[i] = 0;
      }
    }
  }

  // x at tap (kh, kw, c) of the thread's pixel i, or null in the padding
  __device__ __forceinline__ const float* at(int i, int kh, int kw, int c) const {
    const int ih = ih0[i] + kh, iw = iw0[i] + kw;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) return nullptr;
    return x + img[i] + (static_cast<long long>(ih) * W + iw) * C + c;
  }

  __device__ __forceinline__ void load(int k, uint4 (&out)[LOADS]) const {
    if (vec) {   // the 4 taps share (kh, kw): k % 4 == 0 and C % 4 == 0
      const int r = k / C, c = k - (k / C) * C, kh = r / K, kw = r - (r / K) * K;
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const float* p = k < Kg ? at(i, kh, kw, c) : nullptr;
        out[i] = p ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
      }
    } else {
      uint32_t v[LOADS][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k + j;
        const int r = kj / C, c = kj - (kj / C) * C, kh = r / K, kw = r - (r / K) * K;
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
          const float* p = kj < Kg ? at(i, kh, kw, c) : nullptr;
          v[i][j] = p ? __float_as_uint(__ldg(p)) : 0u;
        }
      }
#pragma unroll
      for (int i = 0; i < LOADS; ++i) out[i] = make_uint4(v[i][0], v[i][1], v[i][2], v[i][3]);
    }
  }
};

template <int BN>
__global__ void __launch_bounds__(tc_gemm::kThreads, (tc_gemm::Cfg<float, kBM, BN>::MIN_CTAS))
conv2d_nhwc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int H, int W, int C, int K, int F, int stride,
                   int pad, int OH, int OW, long long M, int vec) {
  extern __shared__ __align__(1024) uint8_t smem[];
  using Cf = tc_gemm::Cfg<float, kBM, BN>;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * BN;
  const Im2colRows<Cf::A_LOADS> rows(x, H, W, C, K, stride, pad, OH, OW, M, vec != 0,
                                     m0 + threadIdx.x / Cf::CHUNKS, Cf::A_ROW_STEP);
  tc_gemm::tile<float, kBM, BN>(smem, rows, w, out, M, F, K * K * C, m0, n0);
}


// ---- the warp-specialised instance ------------------------------------------

namespace ws {

constexpr int kConsumers = 2;                    // warpgroups that multiply, after the producer
constexpr int kProducerThreads = 128;            // the first warpgroup loads
constexpr int kThreads = kProducerThreads + 128 * kConsumers;
constexpr int kBM = 64 * kConsumers;             // rows a tile
constexpr int kBK = 16;                          // depth a stage: 64 bytes a row
constexpr int kRow = 4 * kBK;                    // bytes a tile row
constexpr uint32_t kSwizzle = 2;                 // the 64-byte swizzle's descriptor code
constexpr int kStages = 6;
constexpr int kChunks = kRow / 16;               // 16-byte chunks a row
constexpr int kLoads = kBM * kChunks / kProducerThreads;   // chunks a producer thread a stage
constexpr int kRowStep = kProducerThreads / kChunks;       // rows apart of a thread's chunks
constexpr int kProducerRegs = 96, kConsumerRegs = 200;
constexpr int kTurn = 1;   // named barriers kTurn + c: consumer c may issue its run
static_assert(tc_gemm::kPromoteDepth == 2 * kBK, "a promotion run is two stages");
static_assert(kProducerThreads * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                  65536 / kThreads / 8 * 8 * kThreads,
              "registers: more than the launch gives the block");

template <int BN>
struct Cfg {
  static constexpr uint32_t A_PART = kBM * kRow;     // one part (hi or lo) of A
  static constexpr uint32_t B_PART = BN * kRow;
  static constexpr uint32_t STAGE = 2 * (A_PART + B_PART);   // A hi, A lo, B hi, B lo
  static constexpr int ACC = BN / 2;                 // accumulator registers a thread
  // slack to align the swizzle atoms, the ring, a full and an empty
  // barrier a stage
  static constexpr size_t SMEM = 1024 + kStages * STAGE + 2 * kStages * 8;
  static_assert(BN == 64 || BN == 128, "BN in {64, 128}");
  static_assert(SMEM <= 232448, "over the 227 KB a block may have");
};

__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

}  // namespace ws

// A's rows for the warp-specialised producer: Im2colRows' 16-byte chunks
// (C % 4 == 0, x aligned), each thread's chunk column walking the depth a
// stage at a time.  The tap (kh, kw, c) of depth k = (kh K + kw) C + c
// advances without a division, and off = (kh W + kw) C + c is its offset
// from a pixel's top-left input corner.
template <int LOADS>
struct TapRows {
  const float* x;
  const float* corner[LOADS];   // x at the pixel's top-left input corner
  int ih0[LOADS], iw0[LOADS];   // that corner, kNoRow past M
  int H, W, C, K, Kg;
  int k, kh, kw, c, off;        // the next chunk's depth, tap and offset

  __device__ __forceinline__ TapRows(const float* x_, int H_, int W_, int C_, int K_, int stride,
                                     int pad, int OH, int OW, long long M, long long m_first,
                                     int step, int k0)
      : x(x_), H(H_), W(W_), C(C_), K(K_), Kg(K_ * K_ * C_), k(k0) {
    const long long ohw = static_cast<long long>(OH) * OW;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const long long m = m_first + static_cast<long long>(step) * i;
      corner[i] = x;
      ih0[i] = kNoRow;
      iw0[i] = 0;
      if (m < M) {
        const long long n = m / ohw;
        const int rem = static_cast<int>(m - n * ohw);
        const int oh = rem / OW, ow = rem - (rem / OW) * OW;
        ih0[i] = oh * stride - pad;
        iw0[i] = ow * stride - pad;
        corner[i] = x + n * H * W * C + (static_cast<long long>(ih0[i]) * W + iw0[i]) * C;
      }
    }
    const int r = k0 / C;
    c = k0 - r * C;
    kh = r / K;
    kw = r - kh * K;
    off = (kh * W + kw) * C + c;
  }

  // the chunk at the cursor of pixel i, null in the padding and past K_gemm
  __device__ __forceinline__ const float* at(int i) const {
    const int ih = ih0[i] + kh, iw = iw0[i] + kw;
    const bool live = k < Kg && static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(W);
    return live ? corner[i] + off : nullptr;
  }

  // the cursor a stage on
  __device__ __forceinline__ void advance(int stage_depth) {
    k += stage_depth;
    c += stage_depth;
    off += stage_depth;
    if (c >= C) {
      do {
        c -= C;
        if (++kw == K) {
          kw = 0;
          ++kh;
        }
      } while (c >= C);
      off = (kh * W + kw) * C + c;
    }
  }

  // the chunk at the cursor of each of the thread's pixels (zeros in the
  // padding and past K_gemm) into registers, then the cursor a stage on
  __device__ __forceinline__ void load(uint4 (&out)[LOADS], int stage_depth) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const float* p = at(i);
      out[i] = p ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
    }
    advance(stage_depth);
  }
};

// w (K_gemm x F, row-major) -> ws (2, F, K_gemm): hi = rna_tf32(w) and lo =
// rna_tf32(w - hi), transposed through shared memory 32 x 32 at a time
__global__ void __launch_bounds__(256)
conv2d_nhwc_kernel_split_w(const float* __restrict__ w, float* __restrict__ wsplit, int Kg,
                           int F) {
  __shared__ float t[32][33];
  const int f0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
#pragma unroll
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int k = k0 + i, f = f0 + threadIdx.x;
    t[i][threadIdx.x] = k < Kg && f < F ? w[static_cast<long long>(k) * F + f] : 0.f;
  }
  __syncthreads();
  const long long plane = static_cast<long long>(F) * Kg;
#pragma unroll
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int f = f0 + i, k = k0 + threadIdx.x;
    if (f < F && k < Kg) {
      const float v = t[threadIdx.x][i];
      const float hi = hopper::tf32_rna(v);
      const long long at = static_cast<long long>(f) * Kg + k;
      wsplit[at] = hi;
      wsplit[plane + at] = hopper::tf32_rna(v - hi);
    }
  }
}

// Unit u of n_units is row tile u / n_tiles_n at columns BN (u % n_tiles_n);
// block b of B takes units b, b + B, ...  wmap is the split weights (2, F,
// K_gemm) as a 4-D map (K_gemm, F, 2, 1), boxes (16, BN, 1, 1).
template <int BN>
__global__ void __launch_bounds__(ws::kThreads, 1)
conv2d_nhwc_kernel_ws(const __grid_constant__ CUtensorMap wmap, const float* __restrict__ x,
                      float* __restrict__ out, int H, int W, int C, int K, int F, int stride,
                      int pad, int OH, int OW, long long M, int n_tiles_n, long long n_units) {
  using namespace hopper;
  using Cf = ws::Cfg<BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the atoms' swizzle is a function of the address: align the ring to 1024
  uint8_t* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t s0 = smem_addr(smem);
  const uint32_t bars = s0 + ws::kStages * Cf::STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (ws::kStages + s); };
  // stages a tile: whole promotion runs, the depth past K_gemm zeros
  const int n_stages = 2 * ((K * K * C + 2 * ws::kBK - 1) / (2 * ws::kBK));

  if (threadIdx.x == 0) {
    for (int s = 0; s < ws::kStages; ++s) {
      mbar_init(full(s), ws::kProducerThreads / 32 + 1);   // lane 0 of every producer warp,
                                                            // and the TMA's bytes
      mbar_init(empty(s), ws::kConsumers * 4);   // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  const long long first = blockIdx.x, every = gridDim.x;
  // the unit's row tile's first row and its first column
  auto tile_m0 = [&](long long u) { return u / n_tiles_n * ws::kBM; };
  auto tile_n0 = [&](long long u) { return static_cast<int>(u % n_tiles_n) * BN; };

  // the ring's position, the same sequence in every warpgroup: stage slot
  // of its use with parity phase
  int slot = 0;
  uint32_t phase = 0;
  auto advance = [&]() {
    if (++slot == ws::kStages) {
      slot = 0;
      phase ^= 1;
    }
  };

  if (threadIdx.x < ws::kProducerThreads) {
    // ---- producer: A's rows m0 + row + 32 i, chunk column col of each
    // stage; thread 0 also copies B's tiles ----
    regs_dealloc<ws::kProducerRegs>();
    const int row = threadIdx.x / ws::kChunks, col = threadIdx.x % ws::kChunks;
    if (threadIdx.x == 0) tma_prefetch_map(&wmap);
    // stage j of the tile at columns n0, from the registers r
    auto put_stage = [&](const uint4 (&r)[ws::kLoads], int j, int n0) {
      mbar_wait(empty(slot), phase ^ 1);   // a fresh barrier passes parity 1
      const uint32_t st = s0 + slot * Cf::STAGE;
      if (threadIdx.x == 0) {
        mbar_arrive_expect_tx(full(slot), 2 * Cf::B_PART);
        tma_load_4d(st + 2 * Cf::A_PART, &wmap, full(slot), j * ws::kBK, n0, 0, 0);
        tma_load_4d(st + 2 * Cf::A_PART + Cf::B_PART, &wmap, full(slot), j * ws::kBK, n0, 1, 0);
      }
      uint8_t* a = smem + slot * Cf::STAGE;
#pragma unroll
      for (int i = 0; i < ws::kLoads; ++i)
        tc_gemm::put<true>(a, Cf::A_PART, tc_gemm::swz<ws::kRow>(row + ws::kRowStep * i, col),
                           r[i]);
      fence_proxy_async();   // the warp's stores, before the wgmmas read them
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(full(slot));
      advance();
    };
    uint4 r0[ws::kLoads], r1[ws::kLoads];
    for (long long u = first; u < n_units; u += every) {
      const int n0 = tile_n0(u);
      TapRows<ws::kLoads> rows(x, H, W, C, K, stride, pad, OH, OW, M, tile_m0(u) + row,
                               ws::kRowStep, col * 4);
      rows.load(r0, ws::kBK);
      for (int j = 0; j < n_stages; j += 2) {   // two stages in the registers
        rows.load(r1, ws::kBK);
        put_stage(r0, j, n0);
        if (j + 2 < n_stages) rows.load(r0, ws::kBK);
        put_stage(r1, j + 1, n0);
      }
    }
  } else {
    // ---- consumer c: rows 64 c .. 64 c + 63 of each tile, all BN columns.
    // The wgmmas are issued unconditionally in straight-line code, each
    // run's first stage peeled so that their scale is constant, and the
    // partial sum read only after the wait for every group. ----
    regs_alloc<ws::kConsumerRegs>();
    const int c = (threadIdx.x - ws::kProducerThreads) / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const uint32_t a_off = c * 64 * ws::kRow;
    float acc[Cf::ACC];    // the f32 sum
    float part[Cf::ACC];   // the wgmmas' partial sum since the last promotion
    // one stage's products, as the tiled instance's: offsets in 16-byte
    // units, lo parts one part further, each k step 32 bytes along the row;
    // the first product of a run (FRESH) overwrites the partial sum
    auto stage = [&](auto fresh) {
      constexpr bool FRESH = decltype(fresh)::value;
      mbar_wait(full(slot), phase);
      const uint32_t st = s0 + slot * Cf::STAGE;
      const uint64_t da = make_desc(st + a_off, 16, 8 * ws::kRow, ws::kSwizzle);
      const uint64_t db = make_desc(st + 2 * Cf::A_PART, 16, 8 * ws::kRow, ws::kSwizzle);
      fence_regs(part);
      wgmma_fence();
      static_for<0, ws::kBK / 8>([&](auto kk_) {
        constexpr int kk = decltype(kk_)::value * 2;
        constexpr int add = kk > 0 || !FRESH;
        constexpr int lo_a = Cf::A_PART / 16, lo_b = Cf::B_PART / 16;
        wgmma_ss_kmajor<BN, true, lo_a + kk, kk>(part, da, db, add);
        wgmma_ss_kmajor<BN, true, kk, lo_b + kk>(part, da, db, 1);
        wgmma_ss_kmajor<BN, true, kk, kk>(part, da, db, 1);
      });
      wgmma_commit();
      fence_regs(part);
      const int used = slot;
      advance();
      return used;
    };
    auto release = [&](int s) {
      if (lane == 0) mbar_arrive(empty(s));
    };
    if (c == 1) ws::turn_pass(ws::kTurn);   // consumer 0 issues first
    for (long long u = first; u < n_units; u += every) {
      const long long m0 = tile_m0(u);
      const int n0 = tile_n0(u);
#pragma unroll
      for (int i = 0; i < Cf::ACC; ++i) acc[i] = 0.f;
      for (int j = 0; j < n_stages; j += 2) {   // a run: two stages, then its promotion
        ws::turn_wait(ws::kTurn + c);
        const int sa = stage(std::true_type{});
        const int sb = stage(std::false_type{});
        ws::turn_pass(ws::kTurn + 1 - c);   // the other consumer's run goes in behind this one
        wgmma_wait<1>();
        fence_regs(part);
        release(sa);
        wgmma_wait<0>();
        fence_regs(part);
        release(sb);
#pragma unroll
        for (int i = 0; i < Cf::ACC; ++i) acc[i] += part[i];
      }

      // accumulator element j: row r0 + 8 ((j / 2) % 2), column 8 (j / 4) +
      // 2 (lane % 4) + j % 2 of the consumer's 64 x BN block
      const long long r0 = m0 + 64 * c + warp * 16 + lane / 4;
      const int c0 = n0 + 2 * (lane % 4);
      const bool pairs = (F % 2) == 0;   // rows of out start 8-byte aligned
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = r0 + 8 * h;
        if (r >= M) continue;
        float* o = out + r * F;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = c0 + 8 * j;
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (pairs && col + 1 < F) {
            *reinterpret_cast<float2*>(o + col) = make_float2(v0, v1);
          } else {
            if (col < F) o[col] = v0;
            if (col + 1 < F) o[col + 1] = v1;
          }
        }
      }
    }
    if (c == 0) ws::turn_wait(ws::kTurn);   // consumer 1's last pass
  }
}

// the split weights (2, F, Kg) as a 4-D map (Kg, F, 2, 1) in boxes of
// (16, BN, 1, 1) with the 64-byte swizzle; coordinates past Kg or F read as
// zeros
int weight_map(CUtensorMap* map, const float* wsplit, int Kg, int F, int BN) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t row = static_cast<cuuint64_t>(Kg) * 4, plane = row * F;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Kg), static_cast<cuuint64_t>(F), 2, 1};
  const cuuint64_t strides[3] = {row, plane, 2 * plane};
  const cuuint32_t box[4] = {ws::kBK, static_cast<cuuint32_t>(BN), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(wsplit), dims, strides,
             box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int BN>
int launch_ws(const float* x, const float* w, float* wsplit, float* out, int N, int H, int W,
              int C, int K, int F, int stride, int pad, int OH, int OW, cudaStream_t s) {
  using Cf = ws::Cfg<BN>;
  const int Kg = K * K * C;
  conv2d_nhwc_kernel_split_w<<<dim3((F + 31) / 32, (Kg + 31) / 32), dim3(32, 8), 0, s>>>(
      w, wsplit, Kg, F);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap map;
  if (const int err = weight_map(&map, wsplit, Kg, F, BN)) return err;
  auto kernel = conv2d_nhwc_kernel_ws<BN>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(Cf::SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long M = static_cast<long long>(N) * OH * OW;
  const int n_tiles_n = (F + BN - 1) / BN;
  const long long n_units = (M + ws::kBM - 1) / ws::kBM * n_tiles_n;
  // persistent: one block an SM, none idle
  const unsigned grid = static_cast<unsigned>(n_units < sms ? n_units : sms);
  kernel<<<grid, ws::kThreads, Cf::SMEM, s>>>(map, x, out, H, W, C, K, F, stride, pad, OH, OW, M,
                                              n_tiles_n, n_units);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, H, W, C), w (K, K, C, F) and out (N, OH, OW, F): contiguous float32 on
// the device.  The caller has checked the shapes, that OH = (H + 2 pad - K) /
// stride + 1 and OW likewise are >= 1, and that ceil(N*OH*OW / 128) fits the
// grid's x dimension.
extern "C" int conv2d_nhwc_f32(const void* x, const void* w, void* out, int N, int H,
                               int W, int C, int K, int F, int stride, int pad, int OH,
                               int OW, void* stream) {
  const long long M = static_cast<long long>(N) * OH * OW;
  const auto* px = static_cast<const float*>(x);
  const auto* pw = static_cast<const float*>(w);
  auto* po = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const unsigned m_tiles = static_cast<unsigned>((M + kBM - 1) / kBM);
  if (F >= 128) {
    return tc_gemm::launch<float, kBM, 128>(conv2d_nhwc_kernel<128>,
                                            dim3(m_tiles, (F + 127) / 128), s, px, pw, po, H,
                                            W, C, K, F, stride, pad, OH, OW, M, vec);
  }
  return tc_gemm::launch<float, kBM, 64>(conv2d_nhwc_kernel<64>, dim3(m_tiles, (F + 63) / 64), s,
                                         px, pw, po, H, W, C, K, F, stride, pad, OH, OW, M, vec);
}

// The warp-specialised instance: as conv2d_nhwc_f32, with wsplit scratch of
// 2 F K*K*C floats on the device for the split weights.  Refuses
// (cudaErrorInvalidValue) a call whose gather is not 16-byte vectorised (C %
// 4, x unaligned) or whose K*K*C is under one stage.
extern "C" int conv2d_nhwc_ws_f32(const void* x, const void* w, void* wsplit, void* out, int N,
                                  int H, int W, int C, int K, int F, int stride, int pad, int OH,
                                  int OW, void* stream) {
  if (C % 4 != 0 || K * K * C < ws::kBK || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* px = static_cast<const float*>(x);
  const auto* pw = static_cast<const float*>(w);
  auto* pws = static_cast<float*>(wsplit);
  auto* po = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (F > 64)
    return launch_ws<128>(px, pw, pws, po, N, H, W, C, K, F, stride, pad, OH, OW, s);
  return launch_ws<64>(px, pw, pws, po, N, H, W, C, K, F, stride, pad, OH, OW, s);
}
