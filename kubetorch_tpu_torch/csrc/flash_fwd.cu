// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax state.
//
// Replaces: kubetorch_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel reached through _flash_forward). Same function: online-softmax
// attention, optionally causal with the KV tiles above the diagonal skipped,
// GQA through kv_head = h / group, and on request the per-row logsumexp
// lse[B, Hq, S] in f32 (the TPU kernel's 8-lane [B, H, S, 8] layout exists only
// for a Mosaic tiling rule and is dropped here).
//
// What bounds it on the H100: the tensor-core operations. At the Embedder's
// shape (B = 2, S = T = 2048, 32 query heads, 8 KV heads, D = 128, causal) one
// call does 4*B*H*D*S*(S+1)/2 = 6.9e10 flops against 34 MB of q/k/v/out: about
// 70 us at 989 TFLOP/s bf16 and 10 us at 3.35 TB/s. Only wgmma reaches the
// tensor cores' full rate on this card.
//
// What the design does about it (hopper.cuh has the building blocks):
//  - one block per (128-row query tile, query head, batch row), three
//    warpgroups: a producer warp that only issues TMA loads (its warpgroup
//    gives registers away with setmaxnreg: 40 each) and two consumer
//    warpgroups of 64 query rows each (232 registers each);
//  - TMA moves every tile: Q once (two 64-column boxes of 128 rows), K and V
//    through a 2-stage ring of 128-key tiles (160 KB of shared memory), with
//    full/empty mbarriers per stage and per tensor, so S = Q.K^T starts as
//    soon as K has landed and V's copy overlaps it; q, k and v are read in
//    the model's [B, S, H, D] layout through 4-D tensor maps built from their
//    strides (no transpose copies, column slices of a fused projection work);
//  - S = Q.K^T: wgmma m64n128k16, A = Q and B = K straight from the swizzled
//    tiles (K-major), f32 accumulators in registers; the online softmax runs
//    on that fragment in the log2 domain; the row sums stay per thread until
//    the end; O += P.V: wgmma with A = P converted to bf16 in registers (the
//    accumulator layout is wgmma's A-register layout) and B = V, MN-major;
//  - the softmax overlaps the tensor cores: tile j's S = Q.K_j^T is issued
//    together with the previous tile's O += P.V, and S's softmax runs while
//    P.V is still in flight (O is rescaled after it lands); the two consumer
//    warpgroups also run unsynchronised, so one's softmax overlaps the
//    other's products (no explicit ping-pong schedule). No branch sits
//    between a product's issue and its wait, so ptxas keeps wgmma
//    asynchronous, and nothing in the kernel traps (a __trap() makes ptxas
//    ignore the setmaxnreg budget and spill);
//  - causal: only the tiles on or below the diagonal are loaded, only the
//    last tile of a block (the one that crosses it, or ends past T) runs
//    the masking code, and the heaviest query tiles are launched first (the
//    query tile is the slowest grid dimension);
//  - epilogue: O is normalised, staged through the warpgroup's own slice of
//    the Q tile and written with 16-byte stores, 256 contiguous bytes a row;
//    lse by one thread per row.
// Shapes: D = 128, S and T multiples of 64. A 128-row tile that ends past S
// (S = 64 mod 128) reads zeros there and its second warpgroup idles; a K/V
// tile past T reads zeros that are masked.

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace kt;

constexpr int BQ = 128;                        // query rows per block
constexpr int BK = 128;                        // keys per K/V tile
constexpr int STAGES = 2;
constexpr int NCONSUMER = 2;                   // warpgroups of 64 query rows
constexpr int NTHREAD = (NCONSUMER + 1) * 128;
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr uint32_t Q_SUB = BQ * ROW_BYTES;     // one 64-column box of Q
constexpr uint32_t KV_SUB = BK * ROW_BYTES;    // one 64-column box of K or V
constexpr uint32_t Q_BYTES = 2 * Q_SUB;
constexpr uint32_t KV_BYTES = 2 * KV_SUB;
constexpr uint32_t OFF_K = Q_BYTES;
constexpr uint32_t OFF_V = OFF_K + STAGES * KV_BYTES;
constexpr uint32_t OFF_BAR = OFF_V + STAGES * KV_BYTES;
constexpr int SMEM_BYTES = OFF_BAR + 128 + 1024;  // + barriers, + alignment slack
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  CUtensorMap tm_q, tm_k, tm_v;  // boxes of 128 rows
  __nv_bfloat16* o;              // contiguous [B, S, Hq, HD]
  float* lse;                    // contiguous [B, Hq, S], or null
  int S, T, Hq, group, causal;
  float scale_log2;              // softmax scale * log2(e)
};

struct Bars {  // mbarriers, in shared memory
  uint64_t q, full_k[STAGES], full_v[STAGES], empty_k[STAGES], empty_v[STAGES];
};

__device__ __forceinline__ void producer(const Params& p, uint8_t* smem, Bars& bars,
                                         int qt, int h, int b, int n_tiles) {
  const int kvh = h / p.group;
  prefetch_tensormap(&p.tm_q);
  prefetch_tensormap(&p.tm_k);
  prefetch_tensormap(&p.tm_v);
  const uint32_t base = smem_u32(smem);
  const uint32_t bq = smem_u32(&bars.q);
  mbar_expect_tx(bq, Q_BYTES);
  tma_load_4d(base, &p.tm_q, bq, 0, h, qt * BQ, b);
  tma_load_4d(base + Q_SUB, &p.tm_q, bq, SUB_COLS, h, qt * BQ, b);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    const uint32_t ph = (j / STAGES) & 1;
    const uint32_t fk = smem_u32(&bars.full_k[st]), fv = smem_u32(&bars.full_v[st]);
    const uint32_t k_s = base + OFF_K + st * KV_BYTES, v_s = base + OFF_V + st * KV_BYTES;
    mbar_wait(smem_u32(&bars.empty_k[st]), ph ^ 1);
    mbar_expect_tx(fk, KV_BYTES);
    tma_load_4d(k_s, &p.tm_k, fk, 0, kvh, j * BK, b);
    tma_load_4d(k_s + KV_SUB, &p.tm_k, fk, SUB_COLS, kvh, j * BK, b);
    mbar_wait(smem_u32(&bars.empty_v[st]), ph ^ 1);
    mbar_expect_tx(fv, KV_BYTES);
    tma_load_4d(v_s, &p.tm_v, fv, 0, kvh, j * BK, b);
    tma_load_4d(v_s + KV_SUB, &p.tm_v, fv, SUB_COLS, kvh, j * BK, b);
  }
}

// Online softmax of one 64 x 128 score tile in place (log2 domain): with
// MASK, drops keys above the diagonal or past T; updates the running max m
// and the per-thread partial row sums l, and returns the factors (c0, c1) by
// which the output rows so far must be rescaled. s becomes p = exp2(x - m).
// Only the last K/V tile of a block can need the mask (the diagonal tile when
// causal, the tile that ends past T otherwise): the tiles before it run
// without it.
template <bool MASK>
__device__ __forceinline__ float2 softmax_tile(const Params& p, float (&s)[64], int key0,
                                               int r0, int t, float& m0, float& m1,
                                               float& l0, float& l1) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 8 * jj + 2 * t + (e & 1);
      const int row = r0 + (e >= 2 ? 8 : 0);
      const bool drop = MASK && ((p.causal && key > row) || key >= p.T);
      s[4 * jj + e] = drop ? kNegInf : s[4 * jj + e] * p.scale_log2;
    }
    mx0 = fmaxf(mx0, fmaxf(s[4 * jj], s[4 * jj + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
  }
  // the four threads of a quad share a row
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float2 c = make_float2(exp2f(m0 - mx0), exp2f(m1 - mx1));
  m0 = mx0;
  m1 = mx1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    s[4 * jj + 0] = exp2f(s[4 * jj + 0] - mx0);
    s[4 * jj + 1] = exp2f(s[4 * jj + 1] - mx0);
    s[4 * jj + 2] = exp2f(s[4 * jj + 2] - mx1);
    s[4 * jj + 3] = exp2f(s[4 * jj + 3] - mx1);
    rs0 += s[4 * jj + 0] + s[4 * jj + 1];
    rs1 += s[4 * jj + 2] + s[4 * jj + 3];
  }
  l0 = l0 * c.x + rs0;
  l1 = l1 * c.y + rs1;
  return c;
}

// Per tile j: S_j = Q K_j^T is issued together with O += P_{j-1} V_{j-1},
// and the softmax of S_j runs while that second product is on the tensor
// cores; O is rescaled once it has landed. Between a product's issue and
// its wait the code has no branch, so ptxas keeps wgmma asynchronous.
__device__ __forceinline__ void consumer(const Params& p, uint8_t* smem, Bars& bars,
                                         int wg, int qt, int h, int b, int n_tiles) {
  const int tw = threadIdx.x & 127;               // thread in the warpgroup
  const int warp = tw >> 5, lane = tw & 31;
  const int g = lane >> 2, t = lane & 3;          // accumulator fragment coords
  const int row0 = qt * BQ + wg * 64;             // this warpgroup's first row
  const int r0 = row0 + warp * 16 + g;            // this thread's rows r0, r0 + 8
  const uint32_t base = smem_u32(smem);
  const uint32_t q_row = wg * 64 * ROW_BYTES;

  if (row0 >= p.S) {  // rows past S: only keep the ring turning
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      const uint32_t ph = (j / STAGES) & 1;
      mbar_wait(smem_u32(&bars.full_k[st]), ph);
      if (lane == 0) mbar_arrive(smem_u32(&bars.empty_k[st]));
      mbar_wait(smem_u32(&bars.full_v[st]), ph);
      if (lane == 0) mbar_arrive(smem_u32(&bars.empty_v[st]));
    }
    return;
  }

  float o[64], s[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // per-thread partial sums
  uint32_t pa[8][4];                                      // P of the previous tile
  const uint64_t dq = desc_kmajor(base + q_row);

  // tile 0: S_0 and its softmax (O is still zero)
  mbar_wait(smem_u32(&bars.q), 0);
  mbar_wait(smem_u32(&bars.full_k[0]), 0);
  {
    const uint64_t dk = desc_kmajor(base + OFF_K);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss_n128(s, kstep_kmajor(dq, Q_SUB, ks), kstep_kmajor(dk, KV_SUB, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
  }
  if (lane == 0) mbar_arrive(smem_u32(&bars.empty_k[0]));
  softmax_tile<true>(p, s, 0, r0, t, m0, m1, l0, l1);
  pack_a<64>(pa, s);

  // tile j >= 1: S_j together with O += P_{j-1} V_{j-1}
  auto step = [&](int j, auto masked) {
    const int st = j % STAGES, pst = (j - 1) % STAGES;
    const uint32_t ph = (j / STAGES) & 1, pph = ((j - 1) / STAGES) & 1;
    mbar_wait(smem_u32(&bars.full_k[st]), ph);
    mbar_wait(smem_u32(&bars.full_v[pst]), pph);
    const uint64_t dk = desc_kmajor(base + OFF_K + st * KV_BYTES);
    const uint64_t dv = desc_mnmajor(base + OFF_V + pst * KV_BYTES, KV_SUB);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)   // S = Q K_j^T: 64 rows x 128 keys
      wgmma_ss_n128(s, kstep_kmajor(dq, Q_SUB, ks), kstep_kmajor(dk, KV_SUB, ks), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)   // O += P_{j-1} V_{j-1}
      wgmma_rs_n128_t(o, pa[kk], kstep_mnmajor(dv, kk));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    const float2 c =
        softmax_tile<decltype(masked)::value>(p, s, j * BK, r0, t, m0, m1, l0, l1);
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) {
      mbar_arrive(smem_u32(&bars.empty_k[st]));
      mbar_arrive(smem_u32(&bars.empty_v[pst]));
    }
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      o[4 * jj + 0] *= c.x;
      o[4 * jj + 1] *= c.x;
      o[4 * jj + 2] *= c.y;
      o[4 * jj + 3] *= c.y;
    }
    pack_a<64>(pa, s);
  };
  for (int j = 1; j < n_tiles - 1; ++j) step(j, std::false_type());
  if (n_tiles > 1) step(n_tiles - 1, std::true_type());

  // the last tile's O += P V
  {
    const int pst = (n_tiles - 1) % STAGES;
    mbar_wait(smem_u32(&bars.full_v[pst]), ((n_tiles - 1) / STAGES) & 1);
    const uint64_t dv = desc_mnmajor(base + OFF_V + pst * KV_BYTES, KV_SUB);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs_n128_t(o, pa[kk], kstep_mnmajor(dv, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(smem_u32(&bars.empty_v[pst]));
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  // O through this warpgroup's rows of the Q tile (no longer read)
  __nv_bfloat16* out = p.o + (((long long)b * p.S + row0) * p.Hq + h) * HD;
  store_tile(o, 1.f / l0, 1.f / l1, smem + q_row, Q_SUB, out, (long long)p.Hq * HD,
             p.S - row0, tw, 1 + wg);
  if (p.lse != nullptr && t == 0) {
    float* lp = p.lse + ((long long)b * p.Hq + h) * p.S;
    lp[r0] = (m0 + log2f(l0)) * kLn2;
    lp[r0 + 8] = (m1 + log2f(l1)) * kLn2;
  }
}

__global__ void __launch_bounds__(NTHREAD, 1) flash_fwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Bars& bars = *reinterpret_cast<Bars*>(smem + OFF_BAR);

  const int nqt = (p.S + BQ - 1) / BQ;
  const int qt = nqt - 1 - (int)blockIdx.z;       // heaviest causal tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_all = (p.T + BK - 1) / BK;
  const int last_row = min(p.S, qt * BQ + BQ) - 1;
  const int n_tiles = p.causal ? min(n_all, last_row / BK + 1) : n_all;

  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&bars.q), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&bars.full_k[s]), 1);
      mbar_init(smem_u32(&bars.full_v[s]), 1);
      mbar_init(smem_u32(&bars.empty_k[s]), NCONSUMER * 4);  // one per consumer warp
      mbar_init(smem_u32(&bars.empty_v[s]), NCONSUMER * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NCONSUMER) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == NCONSUMER * 128) producer(p, smem, bars, qt, h, b, n_tiles);
  } else {
    reg_alloc<CONSUMER_REGS>();
    consumer(p, smem, bars, wg, qt, h, b, n_tiles);
  }
}

}  // namespace

// Strides are in elements; the head dim must be contiguous, every stride a
// multiple of 8 and the pointers 16-byte aligned (TMA's rules). Returns a
// cudaError_t, or a code kt_error_string explains.
extern "C" int kt_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int S, int T, int Hq,
                            int Hkv, int D, long long q_sb, long long q_ss,
                            long long q_sh, long long k_sb, long long k_ss,
                            long long k_sh, long long v_sb, long long v_ss,
                            long long v_sh, float scale, int causal,
                            void* stream) {
  if (D != HD || B <= 0 || S <= 0 || T <= 0 || S % 64 != 0 || T % 64 != 0 ||
      Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  int err = encode_bshd(&p.tm_q, q, B, S, Hq, q_sb, q_ss, q_sh, BQ);
  if (!err) err = encode_bshd(&p.tm_k, k, B, T, Hkv, k_sb, k_ss, k_sh, BK);
  if (!err) err = encode_bshd(&p.tm_v, v, B, T, Hkv, v_sb, v_ss, v_sh, BK);
  if (err) return err;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.S = S; p.T = T; p.Hq = Hq; p.group = Hq / Hkv; p.causal = causal;
  p.scale_log2 = scale * 1.4426950408889634f;
  static int budget = -1;  // the build's register count does not change
  if (budget < 0)
    budget = check_register_budget((const void*)flash_fwd_kernel, NTHREAD, NCONSUMER,
                                   CONSUMER_REGS, PRODUCER_REGS);
  if (budget) return budget;
  // above 48 KB of shared memory needs an opt-in (per device, so every call)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Hq, B, (S + BQ - 1) / BQ);
  flash_fwd_kernel<<<grid, NTHREAD, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* kt_error_string(int err) { return kt::error_string(err); }
