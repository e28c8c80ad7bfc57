// Flash-attention backward for Hopper (sm_90a): two kernels, bf16 in, f32 sums.
//
// Replaces: kubetorch_tpu/ops/flash_attention.py::_dq_kernel (kt_flash_bwd_dq)
// and ::_dkv_kernel (kt_flash_bwd_dkv), the two Pallas TPU kernels reached
// through _flash_backward. Same function (FlashAttention-2 backward): with
// s = scale * q.k^T (keys above the diagonal masked when causal),
// p = exp(s - lse), dp = dO.v^T and ds = p * (dp - delta) * scale,
//   dq = ds.k,   dk = ds^T.q,   dv = p^T.dO,
// where lse is the forward's per-row logsumexp and delta = rowsum(dO * O)
// (computed outside, as the JAX package computes it in XLA; ring attention
// may pass its own). GQA: query head h reads kv head h / group, and dk/dv sum
// the group's query heads.
//
// What bounds it on the H100: the tensor-core operations. At the training
// slice's shape (B = 4, S = T = 2048, 16 query heads, 8 KV heads, D = 128,
// causal) dq does 3 products, 3*2*B*Hq*D*S*(S+1)/2 = 1.03e11 flops (0.104 ms
// at 989 TFLOP/s bf16), dk/dv 4 products, 1.37e11 flops (0.139 ms), against
// 50-67 MB of inputs and outputs (15-20 us at 3.35 TB/s).
//
// What the design does about it (both kernels: wgmma, TMA, warp
// specialisation; hopper.cuh has the building blocks):
//  - dq: one block per (128-row query tile, query head, batch row), two
//    consumer warpgroups of 64 rows (240 registers with setmaxnreg) and a
//    producer warp (24). TMA loads Q and dO once (two 64-column boxes of 128
//    rows each), bulk copies bring the block's lse and delta; the producer
//    then streams (K, V) tiles of 64 keys through a 4-stage ring with
//    full/empty mbarriers. Per tile: S = Q.K^T and dP = dO.V^T on wgmma
//    m64n64k16, both operands K-major from the swizzled tiles; p and
//    ds = p*(dP - delta)*scale in registers; dq += ds.K on wgmma m64n128k16
//    with A = ds as bf16 registers and B = the same K tile read MN-major.
//    Tile j's S and dP are issued with tile j-1's ds.K and ds_j is computed
//    while that product runs (the forward's S_j / P_{j-1}.V_{j-1} overlap);
//    a stage is released once its ds.K has landed. dq stays in f32 registers
//    (64 a thread) and leaves through the warpgroup's own Q rows with 16-byte
//    stores. Only a warpgroup's last tile (its diagonal) runs the causal
//    mask; tiles past it only keep the ring turning for the other one;
//  - dk/dv: one block per (128-key tile, KV head, batch row), two
//    consumer warpgroups of 64 keys each (240 registers with setmaxnreg) and
//    a producer warp (24). TMA loads K and V once; they stay in shared
//    memory. The producer then streams (Q tile, dO tile, lse, delta) of 64
//    queries through a 2-stage ring with full/empty mbarriers, for every
//    (query head of the group, live query tile): the TPU grid's innermost
//    nq*group axis turned into a loop, so the GQA group sums into its KV head
//    in one pass, in a fixed order, with no atomics. Per tile: s^T = K.Q^T
//    and dp^T = V.dO^T on wgmma m64n64k16 with both operands K-major from the
//    swizzled tiles; p^T = exp2(s^T*scale*log2e - lse*log2e) and
//    ds^T = p^T*(dp^T - delta)*scale in registers; then dV += p^T.dO and
//    dK += ds^T.Q on wgmma m64n128k16 with A = p^T or ds^T as bf16 registers
//    (the accumulator layout is the A-register layout) and B = dO or Q,
//    MN-major. dK and dV stay in f32 registers (128 a thread); the epilogue
//    stages them through the warpgroup's own K and V rows and writes 16-byte
//    stores;
//  - deterministic: every output element is written once by one thread, and
//    every sum runs in a fixed order, so two runs give identical bits;
//  - causal: tiles wholly above the diagonal are skipped, only tiles that
//    cross it are masked, and the heaviest tiles are launched first;
//  - all tensors are read through their strides in the model's [B, S, H, D]
//    layout (D contiguous) by 4-D tensor maps; outputs are written
//    contiguous. A 128-row tile that ends past S or T (64 mod 128) reads
//    zeros there and its second warpgroup idles.

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int HD = 128;       // head dim (the only one taken)
constexpr int TILE = 64;      // S and T must be multiples of it
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// dq: one block per (128 query rows, query head, batch row)
// ---------------------------------------------------------------------------
namespace dq {

constexpr int BQ = 128;                       // query rows per block
constexpr int BK = 64;                        // keys per streamed tile
constexpr int STAGES = 4;
constexpr int NCONSUMER = 2;                  // warpgroups of 64 query rows
constexpr int NTHREAD = (NCONSUMER + 1) * 128;
constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;
constexpr uint32_t Q_SUB = BQ * kt::ROW_BYTES;    // one 64-column box of Q or dO
constexpr uint32_t KV_SUB = BK * kt::ROW_BYTES;   // one 64-column box of K or V
constexpr uint32_t Q_BYTES = 2 * Q_SUB;
constexpr uint32_t KV_BYTES = 2 * KV_SUB;
constexpr uint32_t OFF_G = Q_BYTES;               // dO after Q
constexpr uint32_t OFF_STAGE = 2 * Q_BYTES;       // stage s: K | V
constexpr uint32_t STAGE_BYTES = 2 * KV_BYTES;
constexpr uint32_t OFF_STATS = OFF_STAGE + STAGES * STAGE_BYTES;  // lse | delta
constexpr uint32_t OFF_BAR = OFF_STATS + 2 * BQ * 4;
constexpr int SMEM_BYTES = OFF_BAR + 128 + 1024;  // + barriers, + alignment slack

struct Params {
  CUtensorMap tm_q, tm_g;                     // boxes of 128 rows
  CUtensorMap tm_k, tm_v;                     // boxes of 64 rows
  const float* lse;                           // contiguous [B, Hq, S]
  const float* delta;                         // contiguous [B, Hq, S]
  __nv_bfloat16* dq;                          // contiguous [B, S, Hq, HD]
  int S, T, Hq, group, causal;
  float scale, scale_log2;
};

struct Bars {  // mbarriers, in shared memory
  uint64_t q, full[STAGES], empty[STAGES];
};

__device__ __forceinline__ void producer(const Params& p, uint8_t* smem, Bars& bars,
                                         int qt, int h, int b, int n_tiles) {
  kt::prefetch_tensormap(&p.tm_q);
  kt::prefetch_tensormap(&p.tm_g);
  kt::prefetch_tensormap(&p.tm_k);
  kt::prefetch_tensormap(&p.tm_v);
  const int kvh = h / p.group;
  const int q0 = qt * BQ;
  const int rows = min(BQ, p.S - q0);             // lse/delta rows inside S
  const long long stat = ((long long)b * p.Hq + h) * p.S + q0;
  const uint32_t base = kt::smem_u32(smem);
  const uint32_t bq = kt::smem_u32(&bars.q);
  kt::mbar_expect_tx(bq, 2 * Q_BYTES + 2 * rows * 4);
  kt::tma_load_4d(base, &p.tm_q, bq, 0, h, q0, b);
  kt::tma_load_4d(base + Q_SUB, &p.tm_q, bq, kt::SUB_COLS, h, q0, b);
  kt::tma_load_4d(base + OFF_G, &p.tm_g, bq, 0, h, q0, b);
  kt::tma_load_4d(base + OFF_G + Q_SUB, &p.tm_g, bq, kt::SUB_COLS, h, q0, b);
  kt::bulk_load(base + OFF_STATS, p.lse + stat, rows * 4, bq);
  kt::bulk_load(base + OFF_STATS + BQ * 4, p.delta + stat, rows * 4, bq);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    const uint32_t ph = (j / STAGES) & 1;
    const uint32_t full = kt::smem_u32(&bars.full[st]);
    const uint32_t k_s = base + OFF_STAGE + st * STAGE_BYTES, v_s = k_s + KV_BYTES;
    kt::mbar_wait(kt::smem_u32(&bars.empty[st]), ph ^ 1);
    kt::mbar_expect_tx(full, STAGE_BYTES);
    kt::tma_load_4d(k_s, &p.tm_k, full, 0, kvh, j * BK, b);
    kt::tma_load_4d(k_s + KV_SUB, &p.tm_k, full, kt::SUB_COLS, kvh, j * BK, b);
    kt::tma_load_4d(v_s, &p.tm_v, full, 0, kvh, j * BK, b);
    kt::tma_load_4d(v_s + KV_SUB, &p.tm_v, full, kt::SUB_COLS, kvh, j * BK, b);
  }
}

// ds = p * (dp - delta) * scale over one 64-row x 64-key tile, in place of
// s, with p = exp2(s * scale * log2e - lse * log2e). With MASK, keys above
// the diagonal get p = 0: only a warpgroup's last tile (the one holding its
// diagonal) runs it.
template <bool MASK>
__device__ __forceinline__ void ds_tile(const Params& p, float (&s)[32], const float (&dp)[32],
                                        int key0, int r0, int t, float lse0, float lse1,
                                        float dl0, float dl1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool hi = e >= 2;
      float pr = exp2f(fmaf(s[4 * j + e], p.scale_log2, -(hi ? lse1 : lse0)));
      if (MASK && p.causal && key0 + 8 * j + 2 * t + (e & 1) > r0 + (hi ? 8 : 0)) pr = 0.f;
      s[4 * j + e] = pr * (dp[4 * j + e] - (hi ? dl1 : dl0)) * p.scale;
    }
  }
}

// Per tile j: S_j = Q K_j^T and dP_j = dO V_j^T are issued together with
// dq += ds_{j-1} K_{j-1}, and ds_j is computed while that product is on the
// tensor cores; the stage of tile j - 1 is released once it has landed.
// Between a product's issue and its wait the code has no branch.
__device__ __forceinline__ void consumer(const Params& p, uint8_t* smem, Bars& bars,
                                         int wg, int qt, int h, int b, int n_tiles) {
  using namespace kt;
  const int tw = threadIdx.x & 127;               // thread in the warpgroup
  const int warp = tw >> 5, lane = tw & 31;
  const int g = lane >> 2, t = lane & 3;          // accumulator fragment coords
  const int row0 = qt * BQ + wg * 64;             // this warpgroup's first row
  const int r0 = row0 + warp * 16 + g;            // this thread's rows r0, r0 + 8
  const uint32_t base = smem_u32(smem);
  const uint32_t q_row = wg * 64 * ROW_BYTES;
  // the tiles this warpgroup reads: causal stops at the one holding its
  // diagonal; rows past S (S = 64 mod 128) read none
  const int n_live = row0 >= p.S ? 0
                     : p.causal ? min(n_tiles, row0 / BK + 1) : n_tiles;

  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;
  if (n_live > 0) {
    mbar_wait(smem_u32(&bars.q), 0);
    const float* stats = reinterpret_cast<const float*>(smem + OFF_STATS);
    const int lr = wg * 64 + warp * 16 + g;       // row in the block
    const float lse0 = stats[lr] * kLog2e, lse1 = stats[lr + 8] * kLog2e;
    const float dl0 = stats[BQ + lr], dl1 = stats[BQ + lr + 8];
    const uint64_t dqa = desc_kmajor(base + q_row);           // Q: A of S
    const uint64_t dga = desc_kmajor(base + OFF_G + q_row);   // dO: A of dP
    float s[32], dp[32];
    uint32_t da[4][4];                            // ds of the previous tile

    // tile 0: S_0, dP_0 and ds_0 (dq is still zero)
    mbar_wait(smem_u32(&bars.full[0]), 0);
    {
      const uint64_t dk = desc_kmajor(base + OFF_STAGE);
      const uint64_t dv = desc_kmajor(base + OFF_STAGE + KV_BYTES);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        wgmma_ss_n64(s, kstep_kmajor(dqa, Q_SUB, ks), kstep_kmajor(dk, KV_SUB, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        wgmma_ss_n64(dp, kstep_kmajor(dga, Q_SUB, ks), kstep_kmajor(dv, KV_SUB, ks), ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
    }
    ds_tile<true>(p, s, dp, 0, r0, t, lse0, lse1, dl0, dl1);
    pack_a<32>(da, s);

    auto step = [&](int j, auto masked) {
      const int st = j % STAGES, pst = (j - 1) % STAGES;
      mbar_wait(smem_u32(&bars.full[st]), (j / STAGES) & 1);
      const uint32_t k_s = base + OFF_STAGE + st * STAGE_BYTES;
      const uint64_t dk = desc_kmajor(k_s), dv = desc_kmajor(k_s + KV_BYTES);
      const uint64_t dkt = desc_mnmajor(base + OFF_STAGE + pst * STAGE_BYTES, KV_SUB);
      fence_regs(dq);
      fence_frags(da);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)     // S_j = Q K_j^T: 64 rows x 64 keys
        wgmma_ss_n64(s, kstep_kmajor(dqa, Q_SUB, ks), kstep_kmajor(dk, KV_SUB, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)     // dP_j = dO V_j^T
        wgmma_ss_n64(dp, kstep_kmajor(dga, Q_SUB, ks), kstep_kmajor(dv, KV_SUB, ks), ks > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)     // dq += ds_{j-1} K_{j-1}
        wgmma_rs_n128_t(dq, da[kk], kstep_mnmajor(dkt, kk));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      fence_regs(dp);
      ds_tile<decltype(masked)::value>(p, s, dp, j * BK, r0, t, lse0, lse1, dl0, dl1);
      wgmma_wait<0>();
      fence_regs(dq);
      fence_frags(da);
      if (lane == 0) mbar_arrive(smem_u32(&bars.empty[pst]));
      pack_a<32>(da, s);
    };
    for (int j = 1; j < n_live - 1; ++j) step(j, std::false_type());
    if (n_live > 1) step(n_live - 1, std::true_type());

    // the last tile's dq += ds K
    {
      const int pst = (n_live - 1) % STAGES;
      const uint64_t dkt = desc_mnmajor(base + OFF_STAGE + pst * STAGE_BYTES, KV_SUB);
      fence_regs(dq);
      fence_frags(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_n128_t(dq, da[kk], kstep_mnmajor(dkt, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_frags(da);
      if (lane == 0) mbar_arrive(smem_u32(&bars.empty[pst]));
    }
  }
  // tiles this warpgroup does not read: only keep the ring turning
  for (int j = n_live; j < n_tiles; ++j) {
    mbar_wait(smem_u32(&bars.full[j % STAGES]), (j / STAGES) & 1);
    if (lane == 0) mbar_arrive(smem_u32(&bars.empty[j % STAGES]));
  }
  if (n_live == 0) return;

  // dq through this warpgroup's rows of the Q tile (no longer read); the
  // scale is already inside ds
  __nv_bfloat16* out = p.dq + (((long long)b * p.S + row0) * p.Hq + h) * HD;
  store_tile(dq, 1.f, 1.f, smem + q_row, Q_SUB, out, (long long)p.Hq * HD, p.S - row0, tw,
             1 + wg);
}

__global__ void __launch_bounds__(NTHREAD, 1) kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Bars& bars = *reinterpret_cast<Bars*>(smem + OFF_BAR);

  const int nqt = (p.S + BQ - 1) / BQ;
  const int qt = nqt - 1 - (int)blockIdx.z;       // heaviest causal tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_all = p.T / BK;
  const int last_row = min(p.S, qt * BQ + BQ) - 1;
  const int n_tiles = p.causal ? min(n_all, last_row / BK + 1) : n_all;

  if (threadIdx.x == 0) {
    kt::mbar_init(kt::smem_u32(&bars.q), 1);
    for (int s = 0; s < STAGES; ++s) {
      kt::mbar_init(kt::smem_u32(&bars.full[s]), 1);
      kt::mbar_init(kt::smem_u32(&bars.empty[s]), NCONSUMER * 4);  // one per consumer warp
    }
    kt::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NCONSUMER) {
    kt::reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == NCONSUMER * 128) producer(p, smem, bars, qt, h, b, n_tiles);
  } else {
    kt::reg_alloc<CONSUMER_REGS>();
    consumer(p, smem, bars, wg, qt, h, b, n_tiles);
  }
}

}  // namespace dq

// ---------------------------------------------------------------------------
// dk/dv: one block per (128-key tile, KV head, batch row)
// ---------------------------------------------------------------------------
namespace dkv {

constexpr int BKV = 128;                      // keys per block
constexpr int BQ = 64;                        // queries per streamed tile
constexpr int STAGES = 2;
constexpr int NCONSUMER = 2;                  // warpgroups of 64 keys
constexpr int NTHREAD = (NCONSUMER + 1) * 128;
constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;
constexpr uint32_t KV_SUB = BKV * kt::ROW_BYTES;  // one 64-column box of K or V
constexpr uint32_t Q_SUB = BQ * kt::ROW_BYTES;    // one 64-column box of Q or dO
constexpr uint32_t KV_BYTES = 2 * KV_SUB;
constexpr uint32_t Q_BYTES = 2 * Q_SUB;
constexpr uint32_t STATS_BYTES = 2 * BQ * 4;      // lse and delta of a tile
constexpr uint32_t OFF_V = KV_BYTES;
constexpr uint32_t OFF_STAGE = 2 * KV_BYTES;      // stage s: Q | dO
constexpr uint32_t STAGE_BYTES = 2 * Q_BYTES;
constexpr uint32_t OFF_STATS = OFF_STAGE + STAGES * STAGE_BYTES;
constexpr uint32_t OFF_BAR = OFF_STATS + STAGES * STATS_BYTES;
constexpr int SMEM_BYTES = OFF_BAR + 128 + 1024;  // + barriers, + alignment slack

struct Params {
  CUtensorMap tm_q, tm_g;                     // boxes of 64 rows
  CUtensorMap tm_k, tm_v;                     // boxes of 128 rows
  const float* lse;                           // contiguous [B, Hq, S]
  const float* delta;                         // contiguous [B, Hq, S]
  __nv_bfloat16* dk;                          // contiguous [B, T, Hkv, HD]
  __nv_bfloat16* dv;                          // contiguous [B, T, Hkv, HD]
  int S, T, Hq, Hkv, group, causal;
  float scale, scale_log2;
};

struct Bars {  // mbarriers, in shared memory
  uint64_t kv, full[STAGES], empty[STAGES];
};

struct Work {  // the (query head, query tile) loop of one block
  int kt, kvh, b, q_first, n_live, n_iter;
};

__device__ __forceinline__ void producer(const Params& p, uint8_t* smem, Bars& bars,
                                         const Work& w) {
  kt::prefetch_tensormap(&p.tm_q);
  kt::prefetch_tensormap(&p.tm_g);
  kt::prefetch_tensormap(&p.tm_k);
  kt::prefetch_tensormap(&p.tm_v);
  const uint32_t base = kt::smem_u32(smem);
  const uint32_t bkv = kt::smem_u32(&bars.kv);
  const int key0 = w.kt * BKV;
  kt::mbar_expect_tx(bkv, 2 * KV_BYTES);
  kt::tma_load_4d(base, &p.tm_k, bkv, 0, w.kvh, key0, w.b);
  kt::tma_load_4d(base + KV_SUB, &p.tm_k, bkv, kt::SUB_COLS, w.kvh, key0, w.b);
  kt::tma_load_4d(base + OFF_V, &p.tm_v, bkv, 0, w.kvh, key0, w.b);
  kt::tma_load_4d(base + OFF_V + KV_SUB, &p.tm_v, bkv, kt::SUB_COLS, w.kvh, key0, w.b);
  for (int it = 0; it < w.n_iter; ++it) {
    const int st = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    const int hq = w.kvh * p.group + it / w.n_live;
    const int q0 = (w.q_first + it % w.n_live) * BQ;
    const uint32_t full = kt::smem_u32(&bars.full[st]);
    const uint32_t q_s = base + OFF_STAGE + st * STAGE_BYTES, g_s = q_s + Q_BYTES;
    const uint32_t stats = base + OFF_STATS + st * STATS_BYTES;
    const long long stat = ((long long)w.b * p.Hq + hq) * p.S + q0;
    kt::mbar_wait(kt::smem_u32(&bars.empty[st]), ph ^ 1);
    kt::mbar_expect_tx(full, STAGE_BYTES + STATS_BYTES);
    kt::tma_load_4d(q_s, &p.tm_q, full, 0, hq, q0, w.b);
    kt::tma_load_4d(q_s + Q_SUB, &p.tm_q, full, kt::SUB_COLS, hq, q0, w.b);
    kt::tma_load_4d(g_s, &p.tm_g, full, 0, hq, q0, w.b);
    kt::tma_load_4d(g_s + Q_SUB, &p.tm_g, full, kt::SUB_COLS, hq, q0, w.b);
    kt::bulk_load(stats, p.lse + stat, BQ * 4, full);
    kt::bulk_load(stats + BQ * 4, p.delta + stat, BQ * 4, full);
  }
}

__device__ __forceinline__ void consumer(const Params& p, uint8_t* smem, Bars& bars,
                                         const Work& w, int wg) {
  const int tw = threadIdx.x & 127;               // thread in the warpgroup
  const int warp = tw >> 5, lane = tw & 31;
  const int g = lane >> 2, t = lane & 3;          // accumulator fragment coords
  const int key0 = w.kt * BKV + wg * 64;          // this warpgroup's first key
  const int kr = key0 + warp * 16 + g;            // this thread's keys kr, kr + 8
  const bool dead = key0 >= p.T;                  // keys past T: idle
  const uint32_t base = kt::smem_u32(smem);
  const uint32_t k_row = wg * 64 * kt::ROW_BYTES;

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

  kt::mbar_wait(kt::smem_u32(&bars.kv), 0);
  for (int it = 0; it < w.n_iter; ++it) {
    const int st = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    const int q0 = (w.q_first + it % w.n_live) * BQ;
    const uint32_t q_s = base + OFF_STAGE + st * STAGE_BYTES, g_s = q_s + Q_BYTES;
    kt::mbar_wait(kt::smem_u32(&bars.full[st]), ph);
    // wholly above the diagonal for this warpgroup's keys: nothing to add
    if (!dead && (!p.causal || q0 + BQ - 1 >= key0)) {
      // s^T = K Q^T and dp^T = V dO^T: 64 keys x 64 queries each
      float sT[32], dpT[32];
      const uint64_t dk_a = kt::desc_kmajor(base + k_row);
      const uint64_t dv_a = kt::desc_kmajor(base + OFF_V + k_row);
      const uint64_t dq_b = kt::desc_kmajor(q_s), dg_b = kt::desc_kmajor(g_s);
      kt::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        kt::wgmma_ss_n64(sT, kt::kstep_kmajor(dk_a, KV_SUB, ks),
                         kt::kstep_kmajor(dq_b, Q_SUB, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        kt::wgmma_ss_n64(dpT, kt::kstep_kmajor(dv_a, KV_SUB, ks),
                         kt::kstep_kmajor(dg_b, Q_SUB, ks), ks > 0);
      kt::wgmma_commit();
      kt::wgmma_wait<0>();
      kt::fence_regs(sT);
      kt::fence_regs(dpT);

      // p^T over sT, ds^T over dpT; columns are queries
      const uint32_t lse_s = base + OFF_STATS + st * STATS_BYTES, del_s = lse_s + BQ * 4;
      const bool diag = p.causal && q0 < key0 + 63;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = q0 + 8 * j + 2 * t;        // this thread's two queries
        const float2 l2 = kt::lds_f2(lse_s + (8 * j + 2 * t) * 4);
        const float2 d2 = kt::lds_f2(del_s + (8 * j + 2 * t) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e & 1;
          float pr = exp2f(fmaf(sT[4 * j + e], p.scale_log2,
                                -(odd ? l2.y : l2.x) * kLog2e));
          if (diag && kr + (e >= 2 ? 8 : 0) > qc + (odd ? 1 : 0)) pr = 0.f;
          sT[4 * j + e] = pr;
          dpT[4 * j + e] = pr * (dpT[4 * j + e] - (odd ? d2.y : d2.x)) * p.scale;
        }
      }
      uint32_t pa[4][4], da[4][4];
      kt::pack_a<32>(pa, sT);
      kt::pack_a<32>(da, dpT);

      // dV += p^T dO and dK += ds^T Q over these 64 queries
      const uint64_t dg_t = kt::desc_mnmajor(g_s, Q_SUB), dq_t = kt::desc_mnmajor(q_s, Q_SUB);
      kt::fence_regs(dv);
      kt::fence_regs(dk);
      kt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        kt::wgmma_rs_n128_t(dv, pa[kk], kt::kstep_mnmajor(dg_t, kk));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        kt::wgmma_rs_n128_t(dk, da[kk], kt::kstep_mnmajor(dq_t, kk));
      kt::wgmma_commit();
      kt::wgmma_wait<0>();
      kt::fence_regs(dv);
      kt::fence_regs(dk);
    }
    if (lane == 0) kt::mbar_arrive(kt::smem_u32(&bars.empty[st]));
  }
  if (dead) return;

  // dK and dV through this warpgroup's rows of the K and V tiles (no longer read)
  const long long row = ((long long)w.b * p.T + key0) * p.Hkv + w.kvh;
  const long long stride = (long long)p.Hkv * HD;
  kt::store_tile(dk, 1.f, 1.f, smem + k_row, KV_SUB, p.dk + row * HD, stride,
                 p.T - key0, tw, 1 + wg);
  kt::store_tile(dv, 1.f, 1.f, smem + OFF_V + k_row, KV_SUB, p.dv + row * HD, stride,
                 p.T - key0, tw, 1 + wg);
}

__global__ void __launch_bounds__(NTHREAD, 1) kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Bars& bars = *reinterpret_cast<Bars*>(smem + OFF_BAR);

  Work w;
  w.kt = blockIdx.z;                              // causal: low key tiles are heaviest
  w.kvh = blockIdx.x;
  w.b = blockIdx.y;
  // live query tiles: causal skips those wholly before this key tile
  const int nq = p.S / BQ;
  w.q_first = p.causal ? min(nq, w.kt * BKV / BQ) : 0;
  w.n_live = nq - w.q_first;
  w.n_iter = p.group * w.n_live;                  // (query head of the group, tile)

  if (threadIdx.x == 0) {
    kt::mbar_init(kt::smem_u32(&bars.kv), 1);
    for (int s = 0; s < STAGES; ++s) {
      kt::mbar_init(kt::smem_u32(&bars.full[s]), 1);
      kt::mbar_init(kt::smem_u32(&bars.empty[s]), NCONSUMER * 4);  // one per consumer warp
    }
    kt::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NCONSUMER) {
    kt::reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == NCONSUMER * 128) producer(p, smem, bars, w);
  } else {
    kt::reg_alloc<CONSUMER_REGS>();
    consumer(p, smem, bars, w, wg);
  }
}

}  // namespace dkv

bool bad_shape(int B, int S, int T, int Hq, int Hkv, int D) {
  return D != HD || B <= 0 || S <= 0 || T <= 0 || S % TILE != 0 || T % TILE != 0 ||
         Hkv <= 0 || Hq % Hkv != 0;
}

}  // namespace

// Strides are in elements, three per tensor (batch, sequence, head); the head
// dim must be contiguous, every stride a multiple of 8 elements and the
// pointers 16-byte aligned (TMA's rules; the wrapper checks them). Each
// returns a cudaError_t, or a code kt_error_string explains.
extern "C" int kt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* g, const void* lse, const void* delta,
                               void* dq_out, int B, int S, int T, int Hq, int Hkv, int D,
                               long long q_sb, long long q_ss, long long q_sh,
                               long long k_sb, long long k_ss, long long k_sh,
                               long long v_sb, long long v_ss, long long v_sh,
                               long long g_sb, long long g_ss, long long g_sh,
                               float scale, int causal, void* stream) {
  if (bad_shape(B, S, T, Hq, Hkv, D)) return (int)cudaErrorInvalidValue;
  dq::Params p;
  int err = kt::encode_bshd(&p.tm_q, q, B, S, Hq, q_sb, q_ss, q_sh, dq::BQ);
  if (!err) err = kt::encode_bshd(&p.tm_g, g, B, S, Hq, g_sb, g_ss, g_sh, dq::BQ);
  if (!err) err = kt::encode_bshd(&p.tm_k, k, B, T, Hkv, k_sb, k_ss, k_sh, dq::BK);
  if (!err) err = kt::encode_bshd(&p.tm_v, v, B, T, Hkv, v_sb, v_ss, v_sh, dq::BK);
  if (err) return err;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq_out);
  p.S = S; p.T = T; p.Hq = Hq; p.group = Hq / Hkv; p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  static int budget = -1;  // the build's register count does not change
  if (budget < 0)
    budget = kt::check_register_budget((const void*)dq::kernel, dq::NTHREAD, dq::NCONSUMER,
                                       dq::CONSUMER_REGS, dq::PRODUCER_REGS);
  if (budget) return budget;
  // above 48 KB of shared memory needs an opt-in (per device, so every call)
  const cudaError_t e = cudaFuncSetAttribute(
      dq::kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Hq, B, (S + dq::BQ - 1) / dq::BQ);
  dq::kernel<<<grid, dq::NTHREAD, dq::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int kt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* g, const void* lse, const void* delta,
                                void* dk, void* dv, int B, int S, int T, int Hq,
                                int Hkv, int D, long long q_sb, long long q_ss,
                                long long q_sh, long long k_sb, long long k_ss,
                                long long k_sh, long long v_sb, long long v_ss,
                                long long v_sh, long long g_sb, long long g_ss,
                                long long g_sh, float scale, int causal,
                                void* stream) {
  if (bad_shape(B, S, T, Hq, Hkv, D)) return (int)cudaErrorInvalidValue;
  // TMA's rules besides: every stride a multiple of 8 elements, 16-byte
  // aligned pointers (the wrapper checks both)
  dkv::Params p;
  int err = kt::encode_bshd(&p.tm_q, q, B, S, Hq, q_sb, q_ss, q_sh, dkv::BQ);
  if (!err) err = kt::encode_bshd(&p.tm_g, g, B, S, Hq, g_sb, g_ss, g_sh, dkv::BQ);
  if (!err) err = kt::encode_bshd(&p.tm_k, k, B, T, Hkv, k_sb, k_ss, k_sh, dkv::BKV);
  if (!err) err = kt::encode_bshd(&p.tm_v, v, B, T, Hkv, v_sb, v_ss, v_sh, dkv::BKV);
  if (err) return err;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.S = S; p.T = T; p.Hq = Hq; p.Hkv = Hkv; p.group = Hq / Hkv; p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  static int budget = -1;  // the build's register count does not change
  if (budget < 0)
    budget = kt::check_register_budget((const void*)dkv::kernel, dkv::NTHREAD,
                                       dkv::NCONSUMER, dkv::CONSUMER_REGS,
                                       dkv::PRODUCER_REGS);
  if (budget) return budget;
  const cudaError_t e = cudaFuncSetAttribute(
      dkv::kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Hkv, B, (T + dkv::BKV - 1) / dkv::BKV);
  dkv::kernel<<<grid, dkv::NTHREAD, dkv::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* kt_error_string(int err) { return kt::error_string(err); }
