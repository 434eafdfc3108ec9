// 3xTF32 on the f32 flash kernel's pipeline, for comparison only: the
// ``tf32x3`` variant of experiments/flash_f32_variants.py inserts this into a
// copy of src/repro_torch/kernels/csrc/flash_attention.cu (inside its
// anonymous namespace, whose RowCtx, softmax_tile, encode_tiled and
// warpgroup_sync it uses) and sends the f32 entry here.  D <= 128 only.
//
// Each f32 operand x is split into hi = rna_tf32(x) and lo = rna_tf32(x -
// hi), and every k8 step adds a_lo b_hi, a_hi b_lo, a_hi b_hi (three tf32
// products: the tensor time of six bf16 ones).  A tf32 wgmma has no
// transpose bit and its A fragment in registers orders k unlike the
// accumulator, so both of P V's operands come from shared memory, K-major:
// V transposed by the split pass into (B, Hkv, D, Skv) planes (Skv a
// multiple of 4, for TMA's 16-byte strides), and P's hi and lo written to
// shared memory by the consumer after each tile's softmax.  One consumer
// warpgroup (64 q rows), 32-key tiles, rows of 32 f32 (128 bytes, the
// 128-byte swizzle); S promoted every 32 of the depth, P V into a fresh
// partial sum per tile, as the shipped kernel.

template <int D>
struct T3 {
  static constexpr int TQ = kWgRows, TK = 32, THREADS = 256;
  static constexpr int CB = 32;                          // f32 of a 128-byte row
  static constexpr int NCB = D / CB;
  static constexpr uint32_t Q_PART = TQ * D * 4;         // q's hi or lo
  static constexpr uint32_t K_PART = TK * D * 4;         // a K tile's hi or lo
  static constexpr uint32_t V_PART = D * TK * 4;         // a V^T tile's: D rows of TK keys
  static constexpr uint32_t P_PART = TQ * TK * 4;
  static constexpr uint32_t KV_BYTES = 2 * K_PART;
  static constexpr size_t FIXED = 1024 + 2 * Q_PART + 2 * P_PART;
  static constexpr int FIT = (232448 - FIXED - 4 * 4 * 8) / (2 * KV_BYTES);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr size_t SMEM = FIXED + (size_t)STAGES * 2 * KV_BYTES + 4 * STAGES * 8;
  static constexpr int STEPS = 4;                         // k8 steps a promotion run: 32
  static constexpr int RUNS = D / 8 / STEPS;
  static_assert(D >= 32 && D <= 128 && STAGES >= 1 && SMEM <= 232448, "D <= 128");
};

// byte offset of 16-byte chunk c of row r in a tile of 128-byte rows
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// K into hi / lo planes (K's layout), V into hi / lo planes of V^T
// (B, Hkv, D, Skv): a 32 x 32 (keys x dims) tile a block, through shared
// memory so that reads and writes are coalesced
__global__ void __launch_bounds__(256)
split_tf32_kernel(const float* __restrict__ k, const float* __restrict__ v,
                  float* __restrict__ planes, int Skv, int Hkv, int D, long long n) {
  __shared__ float t[2][32][33];
  const int s0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int b = blockIdx.z / Hkv, h = blockIdx.z % Hkv;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int s = s0 + i, d = d0 + threadIdx.x;
    if (s < Skv) {
      const long long e = (((long long)b * Skv + s) * Hkv + h) * D + d;
      const float x = k[e], xh = hopper::tf32_rna(x);
      planes[e] = xh;
      planes[n + e] = hopper::tf32_rna(x - xh);
      const float y = v[e], yh = hopper::tf32_rna(y);
      t[0][i][threadIdx.x] = yh;
      t[1][i][threadIdx.x] = hopper::tf32_rna(y - yh);
    }
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int d = d0 + i, s = s0 + threadIdx.x;
    if (s < Skv) {
      const long long e = (((long long)b * Hkv + h) * D + d) * Skv + s;
      planes[2 * n + e] = t[0][threadIdx.x][i];
      planes[3 * n + e] = t[1][threadIdx.x][i];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(T3<D>::THREADS, 1)
flash_tf32x3_kernel(const float* __restrict__ q, const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, float* __restrict__ out, int B,
                    int Sq, int Skv, int Hq, int Hkv, int causal, int window, float softcap,
                    float scale) {
  using namespace hopper;
  using C = T3<D>;
  constexpr int TK = C::TK, NS = TK / 2, ON = D / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t q_s = smem_addr(smem);                  // q's hi, then lo
  const uint32_t p_s = q_s + 2 * C::Q_PART;              // P's hi, then lo
  const uint32_t k_ring = p_s + 2 * C::P_PART;
  const uint32_t v_ring = k_ring + C::STAGES * C::KV_BYTES;
  const uint32_t bars = v_ring + C::STAGES * C::KV_BYTES;
  auto bar = [&](int kind, int s) { return bars + 8 * (4 * s + kind); };
  constexpr int K_FULL = 0, K_EMPTY = 1, V_FULL = 2, V_EMPTY = 3;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::TQ;
  const int hk = h / (Hq / Hkv);
  const int shift = Skv - Sq;
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
      mbar_init(bar(K_EMPTY, s), 4);
      mbar_init(bar(V_EMPTY, s), 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 1) {
    if (threadIdx.x == 128) {
      for (int i = 0; i < n; ++i) {
        const int s = i % C::STAGES, use = i / C::STAGES, k0 = (t_begin + i) * TK;
        if (use > 0) mbar_wait(bar(K_EMPTY, s), (use - 1) & 1);
        mbar_arrive_expect_tx(bar(K_FULL, s), C::KV_BYTES);
        for (int p = 0; p < 2; ++p)
          for (int c = 0; c < C::NCB; ++c)
            tma_load_4d(k_ring + s * C::KV_BYTES + p * C::K_PART + c * TK * 128, &kmap,
                        bar(K_FULL, s), c * C::CB, hk, k0, p * B + b);
        if (use > 0) mbar_wait(bar(V_EMPTY, s), (use - 1) & 1);
        mbar_arrive_expect_tx(bar(V_FULL, s), C::KV_BYTES);
        for (int p = 0; p < 2; ++p)
          tma_load_4d(v_ring + s * C::KV_BYTES + p * C::V_PART, &vmap, bar(V_FULL, s), k0, 0, hk,
                      p * B + b);
      }
    }
    return;
  }

  const int tid = threadIdx.x, lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;
  {   // q: 4 floats a thread at a time, scaled, split, stored swizzled
    constexpr int CH = D / 4;
    const float* qb = q + (size_t)b * Sq * Hq * D + (size_t)h * D;
    for (int i = tid; i < C::TQ * CH; i += 128) {
      const int r = i / CH, j = i % CH, row = q0 + r;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (row < Sq)
        for (int e = 0; e < 4; ++e) x[e] = __ldg(qb + (size_t)row * Hq * D + 4 * j + e);
      float hi[4], lo[4];
      for (int e = 0; e < 4; ++e) {
        const float y = __fmul_rn(x[e], scale);
        hi[e] = tf32_rna(y);
        lo[e] = tf32_rna(y - hi[e]);
      }
      const uint32_t off = (4 * j / C::CB) * C::TQ * 128 + swz128(r, (4 * j) % C::CB / 4);
      *reinterpret_cast<float4*>(smem + off) = make_float4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<float4*>(smem + C::Q_PART + off) = make_float4(lo[0], lo[1], lo[2], lo[3]);
    }
    fence_proxy_async();
    warpgroup_sync(0);
  }

  RowCtx rc;
  rc.c1 = softcap > 0.f ? 1.f / softcap : kLog2e;
  rc.c2 = softcap * kLog2e;
  rc.softcap = softcap;
  rc.Skv = Skv;
  rc.causal = causal;
  rc.window = window;
  rc.cq = 2 * (lane % 4);
  rc.qp0 = q0 + r0 + shift;
  rc.qp_min = q0 + shift;
  rc.qp_max = q0 + kWgRows - 1 + shift;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float o[ON], part[ON], sc[NS], sp[2][NS];
#pragma unroll
  for (int j = 0; j < ON; ++j) o[j] = 0.f;
  const uint64_t dq = make_desc(q_s, 16, 8 * 128, 1);
  const uint64_t dp = make_desc(p_s, 16, 8 * 128, 1);

  // the three products (lo hi, hi lo, hi hi) of k8 steps, offsets in
  // 16-byte units: a part further, a column block further, 32 bytes a step
  auto issue_run = [&](auto run, uint64_t dk) {
    constexpr int R = decltype(run)::value;
    static_for<0, C::STEPS>([&](auto st_) {
      constexpr int st = decltype(st_)::value, kk = R * C::STEPS + st;
      constexpr int blk = kk * 8 / C::CB, off = (kk * 8 % C::CB) * 4;
      constexpr int qa = (blk * C::TQ * 128 + off) / 16, kb = (blk * TK * 128 + off) / 16;
      wgmma_ss_kmajor<TK, true, C::Q_PART / 16 + qa, kb>(sp[R & 1], dq, dk, st > 0);
      wgmma_ss_kmajor<TK, true, qa, C::K_PART / 16 + kb>(sp[R & 1], dq, dk, 1);
      wgmma_ss_kmajor<TK, true, qa, kb>(sp[R & 1], dq, dk, 1);
    });
    wgmma_commit();
  };
  auto fold = [&](auto run) {
    constexpr int R = decltype(run)::value;
    fence_regs(sp[R & 1]);
#pragma unroll
    for (int j = 0; j < NS; ++j) sc[j] = R == 0 ? sp[0][j] : sc[j] + sp[R & 1][j];
  };
  auto qk = [&](int s) {
    const uint64_t dk = make_desc(k_ring + s * C::KV_BYTES, 16, 8 * 128, 1);
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
  // P's hi and lo into shared memory, K-major (rows r0, r0 + 8; columns
  // 8 g + cq, + 1), for P V's A operand
  auto store_p = [&]() {
#pragma unroll
    for (int j = 0; j < NS; j += 2) {
      const int row = r0 + 8 * ((j >> 1) & 1), col = 8 * (j >> 2) + rc.cq;
      const uint32_t off = swz128(row, col / 4) + (col % 4) * 4;
      const float h0 = tf32_rna(sc[j]), h1 = tf32_rna(sc[j + 1]);
      *reinterpret_cast<float2*>(smem + 2 * C::Q_PART + off) = make_float2(h0, h1);
      *reinterpret_cast<float2*>(smem + 2 * C::Q_PART + C::P_PART + off) =
          make_float2(tf32_rna(sc[j] - h0), tf32_rna(sc[j + 1] - h1));
    }
    fence_proxy_async();
    warpgroup_sync(0);
  };
  auto pv = [&](int s) {
    const uint64_t dv = make_desc(v_ring + s * C::KV_BYTES, 16, 8 * 128, 1);
    wgmma_fence();
    static_for<0, TK / 8>([&](auto kk_) {
      constexpr int kk = decltype(kk_)::value, off = kk * 32 / 16;
      wgmma_ss_kmajor<D, true, C::P_PART / 16 + off, off>(part, dp, dv, kk > 0);
      wgmma_ss_kmajor<D, true, off, C::V_PART / 16 + off>(part, dp, dv, 1);
      wgmma_ss_kmajor<D, true, off, off>(part, dp, dv, 1);
    });
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int j = 0; j < ON; ++j) o[j] = fmaf(o[j], alpha[(j >> 1) & 1], part[j]);
  };

  for (int i = 0; i < n; ++i) {
    const int s = i % C::STAGES;
    const uint32_t parity = (i / C::STAGES) & 1;
    mbar_wait(bar(K_FULL, s), parity);
    qk(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(K_EMPTY, s));
    softmax_tile<TK>(sc, m, l, alpha, (t_begin + i) * TK, rc);
    store_p();
    mbar_wait(bar(V_FULL, s), parity);
    pv(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(V_EMPTY, s));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float lr = fmaxf(l[r], 1e-30f);
    const int row = q0 + r0 + 8 * r;
    if (row >= Sq) continue;
    float* dst = out + ((size_t)b * Sq + row) * Hq * D + (size_t)h * D;
#pragma unroll
    for (int g = 0; g < ON / 4; ++g)
      *reinterpret_cast<float2*>(dst + 8 * g + rc.cq) =
          make_float2(o[4 * g + 2 * r] / lr, o[4 * g + 2 * r + 1] / lr);
  }
}

// a 4-D f32 map with 128-byte swizzled boxes
int tensor_map_f32(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                   const cuuint64_t (&dims)[4], const cuuint32_t (&box)[4]) {
  const cuuint64_t strides[3] = {dims[0] * 4, dims[0] * dims[1] * 4,
                                 dims[0] * dims[1] * dims[2] * 4};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_tf32x3(const void* q, const void* k, const void* v, void* planes, void* out, int B,
                  int Sq, int Skv, int Hq, int Hkv, int causal, int window, float softcap,
                  float scale, cudaStream_t stream) {
  using C = T3<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || Skv % 4) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * Skv * Hkv * D;
  float* pl = static_cast<float*>(planes);
  CUtensorMap km, vm;
  int err = tensor_map_f32(encode, &km, pl,
                           {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)Skv, 2ull * B},
                           {(cuuint32_t)C::CB, 1, (cuuint32_t)C::TK, 1});
  if (!err)
    err = tensor_map_f32(encode, &vm, pl + 2 * n,
                         {(cuuint64_t)Skv, (cuuint64_t)D, (cuuint64_t)Hkv, 2ull * B},
                         {(cuuint32_t)C::TK, (cuuint32_t)D, 1, 1});
  if (err) return err;
  split_tf32_kernel<<<dim3((Skv + 31) / 32, D / 32, B * Hkv), dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), pl, Skv, Hkv, D, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto kernel = flash_tf32x3_kernel<D>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(Hq, B, (Sq + C::TQ - 1) / C::TQ), C::THREADS, C::SMEM, stream>>>(
      static_cast<const float*>(q), km, vm, static_cast<float*>(out), B, Sq, Skv, Hq, Hkv,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

int dispatch_tf32x3(const void* q, const void* k, const void* v, void* planes, void* out, int B,
                    int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
                    float softcap, float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch_tf32x3<32>(q, k, v, planes, out, B, Sq, Skv, Hq, Hkv, causal, window, softcap, scale, s);
    case 64: return launch_tf32x3<64>(q, k, v, planes, out, B, Sq, Skv, Hq, Hkv, causal, window, softcap, scale, s);
    case 128: return launch_tf32x3<128>(q, k, v, planes, out, B, Sq, Skv, Hq, Hkv, causal, window, softcap, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

