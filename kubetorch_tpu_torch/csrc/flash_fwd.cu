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
// 70 us at 989 TFLOP/s bf16 and 10 us at 3.35 TB/s.
//
// What the design does about it:
//  - the products run on the tensor cores (mma.sync m16n8k16, bf16 operands,
//    f32 accumulators); the S x T scores never leave registers: each warp owns
//    16 query rows, turns its score accumulators into the bf16 A operand of
//    P.V in place, and keeps the running max, sum and output in registers;
//  - one block per (64-row query tile, query head, batch row), four warps; a
//    loop over 64-row K/V tiles double-buffered in shared memory with cp.async
//    (68 KB: the next tile loads while this one is used; rows padded to 136
//    elements so every ldmatrix phase hits 32 distinct banks);
//  - K and V fragments come from shared memory through ldmatrix (.trans for
//    V), four 8x8 matrices per instruction;
//  - causal: only the tiles on or below the diagonal are loaded at all, and
//    the heaviest query tiles are launched first;
//  - q, k and v are read in the model's [B, S, H, D] layout through their
//    strides, with no transpose copies; D is contiguous.
// Not yet done: wgmma and TMA (mma.sync runs below the card's peak rate).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block (16 per warp)
constexpr int BK = 64;        // keys per K/V tile
constexpr int HD = 128;       // head dim (the only one taken)
constexpr int LDS = HD + 8;   // padded shared-memory row, in elements
constexpr int NWARP = 4;
constexpr int NTHREAD = NWARP * 32;
constexpr int TILE_ELEMS = BK * LDS;  // one K or V tile in shared memory
constexpr int SMEM_BYTES = 4 * TILE_ELEMS * 2;  // K and V, two stages each
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;   // contiguous [B, S, Hq, HD]
  float* lse;         // contiguous [B, Hq, S], or null
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int S, T, Hq, group, causal;
  float scale_log2;   // softmax scale * log2(e): scores live in the log2 domain
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

// Issue the copies of K/V tile j into one stage of shared memory.
__device__ __forceinline__ void load_tile(__nv_bfloat16* k_s, __nv_bfloat16* v_s,
                                          const __nv_bfloat16* kp,
                                          const __nv_bfloat16* vp, long long k_ss,
                                          long long v_ss, int j, int tid) {
  for (int c = tid; c < BK * (HD / 8); c += NTHREAD) {
    const int r = c / (HD / 8), cc = (c % (HD / 8)) * 8;
    const long long t = (long long)j * BK + r;
    cp_async16(&k_s[r * LDS + cc], kp + t * k_ss + cc);
    cp_async16(&v_s[r * LDS + cc], vp + t * v_ss + cc);
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

__global__ void __launch_bounds__(NTHREAD) flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];  // [stage][K|V][BK*LDS]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int nq = p.S / BQ;
  const int qt = nq - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.group;
  const int row0 = qt * BQ + warp * 16;     // this warp's first query row

  const __nv_bfloat16* qp = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kp = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vp = p.v + b * p.v_sb + kvh * p.v_sh;

  const int n_tiles = p.causal ? min(p.T / BK, (qt * BQ + BQ - 1) / BK + 1)
                               : p.T / BK;
  load_tile(smem, smem + TILE_ELEMS, kp, vp, p.k_ss, p.v_ss, 0, tid);
  cp_async_commit();

  // Q as A fragments, one per 16-wide slice of the head dim.
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const __nv_bfloat16* r0 = qp + (long long)(row0 + g) * p.q_ss + ks * 16 + 2 * tig;
    const __nv_bfloat16* r1 = r0 + 8 * p.q_ss;
    qf[ks][0] = ld32(r0);
    qf[ks][1] = ld32(r1);
    qf[ks][2] = ld32(r0 + 8);
    qf[ks][3] = ld32(r1 + 8);
  }

  // Rows g and g + 8 of the warp's 16: running max (log2 domain), sum, output.
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float oacc[HD / 8][4];
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn)
    oacc[dn][0] = oacc[dn][1] = oacc[dn][2] = oacc[dn][3] = 0.f;

  // ldmatrix row addresses: lane l feeds row (l & 7) of matrix (l >> 3)
  const int mrow = lane & 7, mat = lane >> 3;
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      __nv_bfloat16* nxt = smem + ((j + 1) & 1) * 2 * TILE_ELEMS;
      load_tile(nxt, nxt + TILE_ELEMS, kp, vp, p.k_ss, p.v_ss, j + 1, tid);
      cp_async_commit();
      cp_async_wait<1>();  // tile j has landed, tile j + 1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* k_s = smem + (j & 1) * 2 * TILE_ELEMS;
    const __nv_bfloat16* v_s = k_s + TILE_ELEMS;

    // S = Q K^T for the warp's 16 rows x 64 keys: 8 column tiles of 8 keys.
    // One ldmatrix.x4 gives the B fragments of two 16-wide head-dim slices.
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kp2 = 0; kp2 < HD / 32; ++kp2) {
        uint32_t kb[4];
        ldsm_x4(kb, &k_s[(nt * 8 + mrow) * LDS + kp2 * 32 + mat * 8]);
        mma_bf16(s[nt], qf[2 * kp2], kb[0], kb[1]);
        mma_bf16(s[nt], qf[2 * kp2 + 1], kb[2], kb[3]);
      }
    }

    const bool diag = p.causal && (j * BK + BK - 1 > row0);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale_log2;
        if (diag) {
          const int key = j * BK + nt * 8 + 2 * tig + (e & 1);
          const int row = row0 + g + (e >= 2 ? 8 : 0);
          if (key > row) x = kNegInf;
        }
        s[nt][e] = x;
      }
    }

    // Online softmax: the four threads of a quad share a row.
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    l0 = l0 * c0 + rs0;
    l1 = l1 * c1 + rs1;
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      oacc[dn][0] *= c0;
      oacc[dn][1] *= c0;
      oacc[dn][2] *= c1;
      oacc[dn][3] *= c1;
    }

    // O += P V: the score accumulators of key tiles 2kk, 2kk+1 are exactly
    // the A fragment of the 16-key slice kk; one ldmatrix.x4.trans gives the
    // B fragments of two 8-wide head-dim tiles.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < HD / 8; dn += 2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, &v_s[(kk * 16 + (mat & 1) * 8 + mrow) * LDS +
                               (dn + (mat >> 1)) * 8]);
        mma_bf16(oacc[dn], pa, vb[0], vb[1]);
        mma_bf16(oacc[dn + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = row0 + g, r1 = row0 + g + 8;
  __nv_bfloat16* o0 = p.o + (((long long)b * p.S + r0) * p.Hq + h) * HD;
  __nv_bfloat16* o1 = p.o + (((long long)b * p.S + r1) * p.Hq + h) * HD;
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    const int d = dn * 8 + 2 * tig;
    *reinterpret_cast<uint32_t*>(o0 + d) = pack_f32(oacc[dn][0] * inv0, oacc[dn][1] * inv0);
    *reinterpret_cast<uint32_t*>(o1 + d) = pack_f32(oacc[dn][2] * inv1, oacc[dn][3] * inv1);
  }
  if (p.lse != nullptr && tig == 0) {
    float* lp = p.lse + ((long long)b * p.Hq + h) * p.S;
    lp[r0] = (m0 + log2f(fmaxf(l0, 1e-30f))) * kLn2;
    lp[r1] = (m1 + log2f(fmaxf(l1, 1e-30f))) * kLn2;
  }
}

}  // namespace

// Strides are in elements; the head dim must be contiguous. Returns a
// cudaError_t.
extern "C" int kt_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int S, int T, int Hq,
                            int Hkv, int D, long long q_sb, long long q_ss,
                            long long q_sh, long long k_sb, long long k_ss,
                            long long k_sh, long long v_sb, long long v_ss,
                            long long v_sh, float scale, int causal,
                            void* stream) {
  if (D != HD || B <= 0 || S <= 0 || T <= 0 || S % BQ != 0 || T % BK != 0 ||
      Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.S = S; p.T = T; p.Hq = Hq; p.group = Hq / Hkv; p.causal = causal;
  p.scale_log2 = scale * 1.4426950408889634f;
  // above 48 KB of shared memory needs an opt-in (per device, so every call)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / BQ, Hq, B);
  flash_fwd_kernel<<<grid, NTHREAD, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* kt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
