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
// What the design does about it:
//  - dq (Ampere's instruction set, still to be moved to wgmma): every
//    product on mma.sync m16n8k16, bf16 operands, f32 accumulators; one block
//    per (64-row query tile, query head, batch row), four warps of 16 rows; q
//    and dO stay in registers as A fragments, dq's f32 accumulator too; the
//    live K/V tiles (64 keys) are cp.async double-buffered in shared memory
//    (68 KB), K feeding q.k^T through ldmatrix and ds.K through
//    ldmatrix.trans; s, p and ds are recomputed per 16-key slice and
//    re-packed in registers as the A operand of ds.K;
//  - dk/dv (Hopper's: wgmma, TMA, warp specialisation; hopper.cuh has the
//    building blocks): one block per (128-key tile, KV head, batch row), two
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
//  - causal: tiles and slices wholly above the diagonal are skipped, only
//    tiles that cross it are masked, and the heaviest tiles are launched
//    first;
//  - all tensors are read through their strides in the model's [B, S, H, D]
//    layout (D contiguous; dk/dv through 4-D tensor maps); outputs are
//    written contiguous. A 128-key tile that ends past T (T = 64 mod 128)
//    reads zeros there and its second warpgroup idles.

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int HD = 128;       // head dim (the only one taken)
constexpr int LDS = HD + 8;   // padded shared-memory row, in elements
constexpr int NWARP = 4;
constexpr int NTHREAD = NWARP * 32;
constexpr int TILE_ELEMS = 64 * LDS;                // one 64-row tile
constexpr int DQ_SMEM_BYTES = 4 * TILE_ELEMS * 2;   // K and V, two stages each
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* g;     // dO
  const float* lse;           // contiguous [B, Hq, S]
  const float* delta;         // contiguous [B, Hq, S]
  __nv_bfloat16* dq;          // contiguous [B, S, Hq, HD]
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long g_sb, g_ss, g_sh;
  int S, T, Hq, Hkv, group, causal;
  float scale;
  float scale_log2;           // scale * log2(e): exponentials in the log2 domain
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Issue the copies of rows row0..row0+63 (row stride ss, D contiguous) into a
// padded shared-memory tile.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ss, int row0, int tid) {
  for (int c = tid; c < 64 * (HD / 8); c += NTHREAD) {
    const int r = c / (HD / 8), cc = (c % (HD / 8)) * 8;
    cp_async16(&dst[r * LDS + cc], src + (long long)(row0 + r) * ss + cc);
  }
}

// D[16x8] += A[16x16] * B[16x8]; A row-major, B column-major, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The accumulators of two 8-column tiles (16 columns) as the A fragment of a
// 16-deep product.
__device__ __forceinline__ void pack_a(uint32_t a[4], const float c[2][4]) {
  a[0] = pack_f32(c[0][0], c[0][1]);
  a[1] = pack_f32(c[0][2], c[0][3]);
  a[2] = pack_f32(c[1][0], c[1][1]);
  a[3] = pack_f32(c[1][2], c[1][3]);
}

// acc[16 x HD] += a[16 x 16] * rows[16 x HD], rows read transposed from a
// padded tile (row-major, k = row): one ldmatrix.x4.trans gives the B
// fragments of two 8-wide head-dim tiles.
__device__ __forceinline__ void mma_rows(float acc[HD / 8][4], const uint32_t a[4],
                                         const __nv_bfloat16* rows, int mrow, int mat) {
#pragma unroll
  for (int dn = 0; dn < HD / 8; dn += 2) {
    uint32_t b[4];
    ldsm_x4_trans(b, &rows[((mat & 1) * 8 + mrow) * LDS + (dn + (mat >> 1)) * 8]);
    mma_bf16(acc[dn], a, b[0], b[1]);
    mma_bf16(acc[dn + 1], a, b[2], b[3]);
  }
}

__device__ __forceinline__ void store_rows(__nv_bfloat16* o0, __nv_bfloat16* o1,
                                           const float acc[HD / 8][4], int tig) {
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    const int d = dn * 8 + 2 * tig;
    *reinterpret_cast<uint32_t*>(o0 + d) = pack_f32(acc[dn][0], acc[dn][1]);
    *reinterpret_cast<uint32_t*>(o1 + d) = pack_f32(acc[dn][2], acc[dn][3]);
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (query tile, query head, batch row)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NTHREAD) flash_bwd_dq_kernel(const Params p) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];  // [stage][K|V][TILE]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int mrow = lane & 7, mat = lane >> 3;  // ldmatrix row addresses
  const int nq = p.S / BQ;
  const int qt = nq - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.group;
  const int row0 = qt * BQ + warp * 16;     // this warp's first query row

  const __nv_bfloat16* qp = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* gp = p.g + b * p.g_sb + h * p.g_sh;
  const __nv_bfloat16* kp = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vp = p.v + b * p.v_sb + kvh * p.v_sh;

  const int n_tiles = p.causal ? min(p.T / BK, (qt * BQ + BQ - 1) / BK + 1)
                               : p.T / BK;
  load_rows(smem, kp, p.k_ss, 0, tid);
  load_rows(smem + TILE_ELEMS, vp, p.v_ss, 0, tid);
  cp_async_commit();

  // q and dO as A fragments, one per 16-wide slice of the head dim
  uint32_t qf[HD / 16][4], gf[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const __nv_bfloat16* q0 = qp + (long long)(row0 + g) * p.q_ss + ks * 16 + 2 * tig;
    const __nv_bfloat16* q1 = q0 + 8 * p.q_ss;
    qf[ks][0] = ld32(q0);
    qf[ks][1] = ld32(q1);
    qf[ks][2] = ld32(q0 + 8);
    qf[ks][3] = ld32(q1 + 8);
    const __nv_bfloat16* g0 = gp + (long long)(row0 + g) * p.g_ss + ks * 16 + 2 * tig;
    const __nv_bfloat16* g1 = g0 + 8 * p.g_ss;
    gf[ks][0] = ld32(g0);
    gf[ks][1] = ld32(g1);
    gf[ks][2] = ld32(g0 + 8);
    gf[ks][3] = ld32(g1 + 8);
  }

  // rows g and g + 8 of the warp's 16: lse (log2 domain) and delta
  const long long stat = ((long long)b * p.Hq + h) * p.S;
  const float lse0 = p.lse[stat + row0 + g] * kLog2e;
  const float lse1 = p.lse[stat + row0 + g + 8] * kLog2e;
  const float dl0 = p.delta[stat + row0 + g];
  const float dl1 = p.delta[stat + row0 + g + 8];

  float dq[HD / 8][4];
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn)
    dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      __nv_bfloat16* nxt = smem + ((j + 1) & 1) * 2 * TILE_ELEMS;
      load_rows(nxt, kp, p.k_ss, (j + 1) * BK, tid);
      load_rows(nxt + TILE_ELEMS, vp, p.v_ss, (j + 1) * BK, tid);
      cp_async_commit();
      cp_async_wait<1>();  // tile j has landed, tile j + 1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* k_s = smem + (j & 1) * 2 * TILE_ELEMS;
    const __nv_bfloat16* v_s = k_s + TILE_ELEMS;

#pragma unroll 1
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int key0 = j * BK + kk * 16;  // first key of this 16-key slice
      if (p.causal && key0 > row0 + 15) break;  // this and later slices masked
      // s = q.k^T and dp = dO.v^T for 16 rows x 16 keys (two 8-key tiles)
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
        for (int kp2 = 0; kp2 < HD / 32; ++kp2) {
          const int off = (kk * 16 + nt * 8 + mrow) * LDS + kp2 * 32 + mat * 8;
          uint32_t kb[4], vb[4];
          ldsm_x4(kb, &k_s[off]);
          mma_bf16(s[nt], qf[2 * kp2], kb[0], kb[1]);
          mma_bf16(s[nt], qf[2 * kp2 + 1], kb[2], kb[3]);
          ldsm_x4(vb, &v_s[off]);
          mma_bf16(dp[nt], gf[2 * kp2], vb[0], vb[1]);
          mma_bf16(dp[nt], gf[2 * kp2 + 1], vb[2], vb[3]);
        }
      }
      // ds = p * (dp - delta) * scale, written over s
      const bool diag = p.causal && (key0 + 15 > row0);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e >= 2;
          float pr = exp2f(fmaf(s[nt][e], p.scale_log2, -(hi ? lse1 : lse0)));
          if (diag) {
            const int key = key0 + nt * 8 + 2 * tig + (e & 1);
            const int row = row0 + g + (hi ? 8 : 0);
            if (key > row) pr = 0.f;
          }
          s[nt][e] = pr * (dp[nt][e] - (hi ? dl1 : dl0)) * p.scale;
        }
      }
      // dq += ds.K: ds re-packed as the A operand, K rows through .trans
      uint32_t a[4];
      pack_a(a, s);
      mma_rows(dq, a, k_s + kk * 16 * LDS, mrow, mat);
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  __nv_bfloat16* o0 = p.dq + (((long long)b * p.S + row0 + g) * p.Hq + h) * HD;
  store_rows(o0, o0 + 8LL * p.Hq * HD, dq, tig);
}

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
  return D != HD || B <= 0 || S <= 0 || T <= 0 || S % BQ != 0 || T % BK != 0 ||
         Hkv <= 0 || Hq % Hkv != 0;
}

int fill_params(Params& p, const void* q, const void* k, const void* v, const void* g,
                const void* lse, const void* delta, int B, int S, int T, int Hq,
                int Hkv, int D, const long long* qs, const long long* ks,
                const long long* vs, const long long* gs, float scale, int causal) {
  if (bad_shape(B, S, T, Hq, Hkv, D)) return (int)cudaErrorInvalidValue;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.q_sb = qs[0]; p.q_ss = qs[1]; p.q_sh = qs[2];
  p.k_sb = ks[0]; p.k_ss = ks[1]; p.k_sh = ks[2];
  p.v_sb = vs[0]; p.v_ss = vs[1]; p.v_sh = vs[2];
  p.g_sb = gs[0]; p.g_ss = gs[1]; p.g_sh = gs[2];
  p.S = S; p.T = T; p.Hq = Hq; p.Hkv = Hkv; p.group = Hq / Hkv; p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return 0;
}

}  // namespace

// Strides are in elements, three per tensor (batch, sequence, head); the head
// dim must be contiguous. Each returns a cudaError_t.
extern "C" int kt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* g, const void* lse, const void* delta,
                               void* dq, int B, int S, int T, int Hq, int Hkv, int D,
                               long long q_sb, long long q_ss, long long q_sh,
                               long long k_sb, long long k_ss, long long k_sh,
                               long long v_sb, long long v_ss, long long v_sh,
                               long long g_sb, long long g_ss, long long g_sh,
                               float scale, int causal, void* stream) {
  Params p;
  const long long qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh}, gs[3] = {g_sb, g_ss, g_sh};
  const int bad = fill_params(p, q, k, v, g, lse, delta, B, S, T, Hq, Hkv, D, qs, ks,
                              vs, gs, scale, causal);
  if (bad) return bad;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  // above 48 KB of shared memory needs an opt-in (per device, so every call)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / BQ, Hq, B);
  flash_bwd_dq_kernel<<<grid, NTHREAD, DQ_SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(p);
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
