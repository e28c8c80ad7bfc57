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
//  - every product runs on the tensor cores (mma.sync m16n8k16, bf16
//    operands, f32 accumulators); the score, probability and ds tiles never
//    leave registers: each is recomputed per 16-key (dq) or 16-query (dk/dv)
//    slice and re-packed in place as the bf16 A operand of the next product,
//    as the forward does for P.V;
//  - dq: one block per (64-row query tile, query head, batch row), four warps
//    of 16 rows; q and dO stay in registers as A fragments, dq's f32
//    accumulator too; the live K/V tiles (64 keys) are cp.async
//    double-buffered in shared memory (68 KB), K feeding q.k^T through
//    ldmatrix and ds.K through ldmatrix.trans;
//  - dk/dv: one block per (64-key tile, KV head, batch row), four warps of 16
//    keys; K and V stay in shared memory, and the block loops over the group's
//    query heads and the live query tiles (the TPU grid's innermost
//    nq*group axis turned into a loop), with the Q/dO tiles cp.async
//    double-buffered (102 KB in all). Working transposed (s^T = k.q^T,
//    dp^T = v.dO^T) keeps p^T and ds^T in registers as the A operands of
//    p^T.dO and ds^T.q, so grouped heads sum into their KV head in one pass
//    with no atomics;
//  - deterministic: every output element is written once by one thread, and
//    every sum runs in a fixed order, so two runs give identical bits;
//  - causal: tiles and 16-row slices wholly above the diagonal are skipped,
//    and the heaviest tiles are launched first;
//  - all tensors are read through their strides in the model's [B, S, H, D]
//    layout (D contiguous); outputs are written contiguous.
// Not yet done: wgmma and TMA (mma.sync runs below the card's peak rate).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int HD = 128;       // head dim (the only one taken)
constexpr int LDS = HD + 8;   // padded shared-memory row, in elements
constexpr int NWARP = 4;
constexpr int NTHREAD = NWARP * 32;
constexpr int TILE_ELEMS = 64 * LDS;                // one 64-row tile
constexpr int DQ_SMEM_BYTES = 4 * TILE_ELEMS * 2;   // K and V, two stages each
constexpr int DKV_SMEM_BYTES = 6 * TILE_ELEMS * 2;  // K, V + Q and dO, two stages
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* g;     // dO
  const float* lse;           // contiguous [B, Hq, S]
  const float* delta;         // contiguous [B, Hq, S]
  __nv_bfloat16* dq;          // contiguous [B, S, Hq, HD]
  __nv_bfloat16* dk;          // contiguous [B, T, Hkv, HD]
  __nv_bfloat16* dv;          // contiguous [B, T, Hkv, HD]
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
// dk/dv: one block per (key tile, KV head, batch row)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NTHREAD) flash_bwd_dkv_kernel(const Params p) {
  // [K][V][stage 0: Q|dO][stage 1: Q|dO], each a padded 64-row tile
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* k_s = smem;
  __nv_bfloat16* v_s = smem + TILE_ELEMS;
  __nv_bfloat16* stage_s = smem + 2 * TILE_ELEMS;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int mrow = lane & 7, mat = lane >> 3;
  const int kt = blockIdx.x;                 // causal: low key tiles are heaviest
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int key0 = kt * BK + warp * 16;      // this warp's first key

  const __nv_bfloat16* kp = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vp = p.v + b * p.v_sb + kvh * p.v_sh;

  // live query tiles: causal skips those wholly before this key tile
  const int nq = p.S / BQ;
  const int q_first = p.causal ? min(nq, kt * BK / BQ) : 0;
  const int n_live = nq - q_first;
  const int n_iter = p.group * n_live;       // (query head of the group, tile)

  auto load_qg = [&](int it, __nv_bfloat16* dst) {
    const int hq = kvh * p.group + it / n_live;
    const int qi = q_first + it % n_live;
    load_rows(dst, p.q + b * p.q_sb + hq * p.q_sh, p.q_ss, qi * BQ, tid);
    load_rows(dst + TILE_ELEMS, p.g + b * p.g_sb + hq * p.g_sh, p.g_ss, qi * BQ, tid);
  };

  load_rows(k_s, kp, p.k_ss, kt * BK, tid);
  load_rows(v_s, vp, p.v_ss, kt * BK, tid);
  if (n_iter > 0) load_qg(0, stage_s);
  cp_async_commit();

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    dk[dn][0] = dk[dn][1] = dk[dn][2] = dk[dn][3] = 0.f;
    dv[dn][0] = dv[dn][1] = dv[dn][2] = dv[dn][3] = 0.f;
  }

  // A fragments of the warp's 16 K or V rows come from shared memory:
  // lane l addresses row (l & 7) + 8 * (matrix & 1), column 8 * (matrix >> 1)
  const int a_off = (warp * 16 + (mat & 1) * 8 + mrow) * LDS + (mat >> 1) * 8;

  for (int it = 0; it < n_iter; ++it) {
    if (it + 1 < n_iter) {
      load_qg(it + 1, stage_s + ((it + 1) & 1) * 2 * TILE_ELEMS);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* q_s = stage_s + (it & 1) * 2 * TILE_ELEMS;
    const __nv_bfloat16* g_s = q_s + TILE_ELEMS;
    const int hq = kvh * p.group + it / n_live;
    const int qi = q_first + it % n_live;
    const long long stat = ((long long)b * p.Hq + hq) * p.S;

#pragma unroll 1
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const int qrow0 = qi * BQ + kk * 16;   // first query of this slice
      if (p.causal && qrow0 + 15 < key0) continue;  // wholly masked for this warp
      // s^T = k.q^T and dp^T = v.dO^T for 16 keys x 16 queries
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
        dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
      }
#pragma unroll
      for (int kp2 = 0; kp2 < HD / 32; ++kp2) {
        uint32_t ka0[4], ka1[4], va0[4], va1[4];
        ldsm_x4(ka0, &k_s[a_off + kp2 * 32]);
        ldsm_x4(ka1, &k_s[a_off + kp2 * 32 + 16]);
        ldsm_x4(va0, &v_s[a_off + kp2 * 32]);
        ldsm_x4(va1, &v_s[a_off + kp2 * 32 + 16]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int off = (kk * 16 + nt * 8 + mrow) * LDS + kp2 * 32 + mat * 8;
          uint32_t qb[4], gb[4];
          ldsm_x4(qb, &q_s[off]);
          mma_bf16(st[nt], ka0, qb[0], qb[1]);
          mma_bf16(st[nt], ka1, qb[2], qb[3]);
          ldsm_x4(gb, &g_s[off]);
          mma_bf16(dpt[nt], va0, gb[0], gb[1]);
          mma_bf16(dpt[nt], va1, gb[2], gb[3]);
        }
      }
      // p^T over st, ds^T over dpt; columns are queries
      const bool diag = p.causal && (qrow0 < key0 + 15);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int qc = qrow0 + nt * 8 + 2 * tig;  // this thread's two queries
        const float2 l2 = *reinterpret_cast<const float2*>(p.lse + stat + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(p.delta + stat + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e & 1;
          float pr = exp2f(fmaf(st[nt][e], p.scale_log2,
                                -(odd ? l2.y : l2.x) * kLog2e));
          if (diag) {
            const int key = key0 + g + (e >= 2 ? 8 : 0);
            if (key > qc + (odd ? 1 : 0)) pr = 0.f;
          }
          st[nt][e] = pr;
          dpt[nt][e] = pr * (dpt[nt][e] - (odd ? d2.y : d2.x)) * p.scale;
        }
      }
      // dv += p^T.dO and dk += ds^T.q over these 16 queries
      uint32_t pa[4], da[4];
      pack_a(pa, st);
      pack_a(da, dpt);
      mma_rows(dv, pa, g_s + kk * 16 * LDS, mrow, mat);
      mma_rows(dk, da, q_s + kk * 16 * LDS, mrow, mat);
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }
  cp_async_wait<0>();  // nothing left in flight when there was no live tile

  const long long r0 = ((long long)b * p.T + key0 + g) * p.Hkv + kvh;
  const long long r8 = 8LL * p.Hkv * HD;
  store_rows(p.dk + r0 * HD, p.dk + r0 * HD + r8, dk, tig);
  store_rows(p.dv + r0 * HD, p.dv + r0 * HD + r8, dv, tig);
}

int fill_params(Params& p, const void* q, const void* k, const void* v, const void* g,
                const void* lse, const void* delta, int B, int S, int T, int Hq,
                int Hkv, int D, const long long* qs, const long long* ks,
                const long long* vs, const long long* gs, float scale, int causal) {
  if (D != HD || B <= 0 || S <= 0 || T <= 0 || S % BQ != 0 || T % BK != 0 ||
      Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
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
  p.dk = p.dv = nullptr;
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
  Params p;
  const long long qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh}, gs[3] = {g_sb, g_ss, g_sh};
  const int bad = fill_params(p, q, k, v, g, lse, delta, B, S, T, Hq, Hkv, D, qs, ks,
                              vs, gs, scale, causal);
  if (bad) return bad;
  p.dq = nullptr;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(T / BK, Hkv, B);
  flash_bwd_dkv_kernel<<<grid, NTHREAD, DKV_SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* kt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
