// W8A16 decode matmul for Hopper (sm_90a): out[B,N] = (x[B,K] @ w[K,N]) * scale[N]
//
// Replaces: kubetorch_tpu/ops/quant_matmul.py::_kernel (the Pallas TPU kernel
// reached through int8_matmul). Same function: int8 weights dequantized in
// registers, float32 accumulation, per-output-channel scale applied after the
// contraction, output in x's dtype (bf16 or f32).
//
// What bounds it on the H100: the weight bytes. Decode has B <= 256 tokens,
// so each int8 weight byte feeds at most 2*B flops, far below the card's
// ridge: the K*N int8 stream at 3.35 TB/s is the least time the call can take
// (Llama-3-8B: 218 MB per layer, 65 us).
//
// What the design does about it:
//  - the weight stream is kept deep and off the consumers' critical path:
//    one block per (batch chunk of 8/16/32 rows, 128-column tile, K split);
//    its producer warp streams [64 rows x 128 columns] int8 weight tiles and
//    the matching [chunk x 64] x tiles by TMA (2-D tensor maps, 128-byte
//    swizzle, one box each a stage) into a ring of shared-memory stages with
//    full/empty mbarriers: 8 stages (72 KB) and three blocks an SM at 8 rows,
//    8 stages and two blocks at 16, 16 stages and one block at 32. x comes
//    by TMA too: staging it row by row with bulk copies (one request per
//    batch row and stage) starved the large batches;
//  - four consumer warps take whole stages in turn (stage s always to warp
//    s % 4, so each waits on its barriers' phases in order). Each runs the
//    products on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
//    accumulators) with the weights as the A operand and x^T as B, so a
//    batch of 8 fills the mma's N = 8 exactly. Per 16-row k-step a thread
//    reads 4 rows x 16 contiguous bytes (8 threads cover a 128-byte row: four
//    wavefronts for 512 bytes, the least). The K order inside a k-step is
//    permuted (fragment k-index {2t, 2t+1, 2t+8, 2t+9} reads rows
//    {4t .. 4t+3}) and x is read with the same permutation, so every
//    thread's bytes are exactly its own A fragments: no transpose;
//  - int8 -> bf16 without I2F: a byte permute builds the float 2^23 + (v+128),
//    one subtraction leaves v exactly, and cvt packs two into bf16x2;
//  - f32 x is split into bf16 hi + lo parts (two mmas), keeping ~16 bits of
//    its mantissa instead of rounding it to bf16;
//  - the partition (ops/quant_matmul.py::pick_splits) splits K up to 8 ways
//    (a portable cluster) for about two blocks an SM, below what fits, so
//    that clusters of 8 find room on every GPC in one wave; the warps'
//    partials meet in padded shared memory, and the splits of one output
//    tile form a thread-block cluster that sums its f32 partials through
//    distributed shared memory in a fixed order: no workspace, no second
//    kernel, no atomics, deterministic results.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NCWARP = 4;                  // consumer warps (stage s -> warp s % 4)
constexpr int NTHREAD = (NCWARP + 1) * 32;  // + the producer warp
constexpr int BN = 128;                    // output columns per block
constexpr int BK = 64;                     // weight rows per stage
constexpr int KSTEP = 16;                  // rows per mma k-step
constexpr int MT = BN / 16;                // mma m-tiles per warp
constexpr uint32_t W_BYTES = BK * BN;      // one stage's weight tile
constexpr int RLD = BN + 4;                // padded row of the reduction buffers
constexpr int MAX_SPLITS = 8;              // portable cluster size

// Shared memory of the <XT, NT> kernel: STAGES x (weight tile | x boxes),
// every box 1024-byte aligned and 128-byte swizzled, then the mbarriers.
// After the main loop the ring holds the warps' partial tiles and their sum.
template <typename XT, int NT>
struct Layout {
  static constexpr int ROWS = 8 * NT;                              // batch rows
  static constexpr int XCOLS = 128 / sizeof(XT);                   // x columns a box
  static constexpr int XBOXES = BK / XCOLS;
  static constexpr uint32_t XBOX = ROWS * 128;
  static constexpr uint32_t STAGE = W_BYTES + XBOXES * XBOX;
  // blocks an SM: three for 8 batch rows, two for 16, one for 32 (the
  // ring's budget and the registers of __launch_bounds__ follow)
  static constexpr int BLOCKS = NT == 1 ? 3 : NT == 2 ? 2 : 1;
  static constexpr int BUDGET = NT == 1 ? 74 * 1024 : NT == 2 ? 84 * 1024 : 200 * 1024;
  static constexpr int FIT = BUDGET / STAGE / NCWARP * NCWARP;
  static constexpr int STAGES = FIT < 16 ? FIT : 16;
  static constexpr uint32_t OFF_BAR = STAGES * STAGE;
  static constexpr int SMEM = OFF_BAR + 2 * STAGES * 8 + 1024;     // + alignment slack
  static constexpr uint32_t OFF_PART = NCWARP * ROWS * RLD * 4;     // after the warps'
  static_assert(STAGE % 1024 == 0, "boxes stay 1024-byte aligned");
  static_assert(STAGES >= NCWARP && STAGES % NCWARP == 0, "a stage belongs to one warp");
  static_assert(OFF_PART + ROWS * BN * 4 <= OFF_BAR, "the reduction fits the ring");
};

template <typename XT, typename ST>
struct Params {
  CUtensorMap tm_w;                        // w [K, N] int8, boxes of BK x BN
  CUtensorMap tm_x;                        // x [B, K], boxes of ROWS x XCOLS
  const ST* scale;                         // [N]
  XT* out;                                 // [B, N]
  int B, K, N, k_per_split;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Byte `b` of `biased` (the int8 value plus 128) as an exact float.
__device__ __forceinline__ float byte_to_f32(uint32_t biased, int b) {
  const uint32_t bits = __byte_perm(biased, 0x4B000000u, 0x7440 + b);  // 0x4B0000uu
  return __uint_as_float(bits) - 8388736.0f;                           // 2^23 + 128
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of (row, byte) in a 128-byte-swizzled box of 128-byte rows.
__device__ __forceinline__ int swz(int row, int byte) {
  return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

// x[b][k .. k+3] (shared memory) as two bf16x2 B-fragment registers (hi
// parts), and for f32 x the bf16 remainders (lo parts).
__device__ __forceinline__ void load_x(const __nv_bfloat16* p, uint32_t hi[2], uint32_t lo[2]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  hi[0] = v.x;
  hi[1] = v.y;
  lo[0] = lo[1] = 0u;
}
__device__ __forceinline__ void load_x(const float* p, uint32_t hi[2], uint32_t lo[2]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  const float f[4] = {v.x, v.y, v.z, v.w};
  float r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = f[i] - __bfloat162float(__float2bfloat16(f[i]));
  hi[0] = kt::pack_bf16(f[0], f[1]);
  hi[1] = kt::pack_bf16(f[2], f[3]);
  lo[0] = kt::pack_bf16(r[0], r[1]);
  lo[1] = kt::pack_bf16(r[2], r[3]);
}

// One 16-row k-step of a stage: `w` points at the stage's weight tile, `xs`
// at its x boxes.
template <typename XT, int NT>
__device__ __forceinline__ void kstep(float (&acc)[MT][NT][4], const uint8_t* w,
                                      const uint8_t* xs, int ks, int g, int tig) {
  constexpr bool kSplitX = sizeof(XT) == 4;  // f32 x: hi + lo mmas
  using L = Layout<XT, NT>;
  uint32_t wx[4][4];  // [row][word], each byte biased by +128
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint4 v = *reinterpret_cast<const uint4*>(w + swz(ks * KSTEP + 4 * tig + r, 16 * g));
    wx[r][0] = v.x ^ 0x80808080u;
    wx[r][1] = v.y ^ 0x80808080u;
    wx[r][2] = v.z ^ 0x80808080u;
    wx[r][3] = v.w ^ 0x80808080u;
  }
  uint32_t xh[NT][2], xl[NT][2];
  const int xbyte = (ks * KSTEP + 4 * tig) * (int)sizeof(XT);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    load_x(reinterpret_cast<const XT*>(xs + (xbyte / 128) * L::XBOX +
                                       swz(8 * j + g, xbyte % 128)),
           xh[j], xl[j]);
  // m-tile m: fragment row g <-> column 16g + 2m, row g + 8 <-> 16g + 2m + 1
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int q = m >> 1, c0 = 2 * (m & 1), c1 = c0 + 1;
    uint32_t a[4];
    a[0] = kt::pack_bf16(byte_to_f32(wx[0][q], c0), byte_to_f32(wx[1][q], c0));
    a[1] = kt::pack_bf16(byte_to_f32(wx[0][q], c1), byte_to_f32(wx[1][q], c1));
    a[2] = kt::pack_bf16(byte_to_f32(wx[2][q], c0), byte_to_f32(wx[3][q], c0));
    a[3] = kt::pack_bf16(byte_to_f32(wx[2][q], c1), byte_to_f32(wx[3][q], c1));
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mma_bf16(acc[m][j], a, xh[j][0], xh[j][1]);
      if (kSplitX) mma_bf16(acc[m][j], a, xl[j][0], xl[j][1]);
    }
  }
}

// NT batch tiles of 8 rows per block. The grid's z blocks (the K splits) of
// one output tile form one cluster.
template <typename XT, typename ST, int NT>
__global__ void __launch_bounds__(NTHREAD, Layout<XT, NT>::BLOCKS)
w8a16_kernel(const __grid_constant__ Params<XT, ST> p) {
  using L = Layout<XT, NT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);
  uint64_t* empty = full + L::STAGES;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;   // mma fragment coordinates
  const int b0 = blockIdx.x * L::ROWS;
  const int n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * p.k_per_split;
  const int kend = min(p.K, kbeg + p.k_per_split);
  const int n_stages = (kend - kbeg + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      kt::mbar_init(kt::smem_u32(&full[s]), 1);
      kt::mbar_init(kt::smem_u32(&empty[s]), 1);  // the warp that read it
    }
    kt::fence_barrier_init();
  }
  __syncthreads();

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;

  if (warp == NCWARP) {
    if (lane == 0) {  // producer: one weight box and the x boxes a stage
      kt::prefetch_tensormap(&p.tm_w);
      kt::prefetch_tensormap(&p.tm_x);
      const uint32_t base = kt::smem_u32(smem);
      for (int it = 0; it < n_stages; ++it) {
        const int st = it % L::STAGES;
        const uint32_t ph = (it / L::STAGES) & 1;
        const int k0 = kbeg + it * BK;
        const uint32_t bar = kt::smem_u32(&full[st]);
        const uint32_t s_w = base + st * L::STAGE;
        kt::mbar_wait(kt::smem_u32(&empty[st]), ph ^ 1);
        kt::mbar_expect_tx(bar, L::STAGE);
        kt::tma_load_2d(s_w, &p.tm_w, bar, n0, k0);
#pragma unroll
        for (int i = 0; i < L::XBOXES; ++i)
          kt::tma_load_2d(s_w + W_BYTES + i * L::XBOX, &p.tm_x, bar, k0 + i * L::XCOLS, b0);
      }
    }
  } else {
    for (int it = warp; it < n_stages; it += NCWARP) {
      const int st = it % L::STAGES;
      kt::mbar_wait(kt::smem_u32(&full[st]), (it / L::STAGES) & 1);
      const uint8_t* w = smem + st * L::STAGE;
      const int nk = min(BK, kend - (kbeg + it * BK)) / KSTEP;
      if (nk == BK / KSTEP) {
#pragma unroll
        for (int ks = 0; ks < BK / KSTEP; ++ks)
          kstep<XT, NT>(acc, w, w + W_BYTES, ks, g, tig);
      } else {  // the last stage of a K that is not a multiple of BK
        for (int ks = 0; ks < nk; ++ks) kstep<XT, NT>(acc, w, w + W_BYTES, ks, g, tig);
      }
      __syncwarp();
      if (lane == 0) kt::mbar_arrive(kt::smem_u32(&empty[st]));
    }
  }
  __syncthreads();  // every stage consumed: the ring becomes the reduction buffers

  // Sum the warps' partials in a fixed order; thread i < BN owns column n0 + i.
  float(*red)[L::ROWS][RLD] = reinterpret_cast<float(*)[L::ROWS][RLD]>(smem);
  float(*part)[BN] = reinterpret_cast<float(*)[BN]>(smem + L::OFF_PART);
  if (warp < NCWARP) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int col = 16 * g + 2 * m;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = 8 * j + 2 * tig;
        red[warp][r][col] = acc[m][j][0];
        red[warp][r + 1][col] = acc[m][j][1];
        red[warp][r][col + 1] = acc[m][j][2];
        red[warp][r + 1][col + 1] = acc[m][j][3];
      }
    }
  }
  __syncthreads();
  if (tid < BN) {
    for (int r = 0; r < L::ROWS; ++r) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < NCWARP; ++q) s += red[q][r][tid];
      part[r][tid] = s;
    }
  }

  // Sum the splits' partials across the cluster, split 0 first; block rank
  // r finishes the rows r, r + nsplit, ... of the tile.
  cg::cluster_group cluster = cg::this_cluster();
  const int nsplit = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  cluster.sync();
  if (tid < BN) {
    const int n = n0 + tid;
    const float sc = to_f32(p.scale[n]);
    for (int row = rank; row < L::ROWS; row += nsplit) {
      const int b = b0 + row;
      if (b >= p.B) break;
      float s = 0.f;
      for (int r = 0; r < nsplit; ++r) s += cluster.map_shared_rank(&part[row][0], r)[tid];
      p.out[(size_t)b * p.N + n] = from_f32<XT>(s * sc);
    }
  }
  cluster.sync();  // no block exits while its partials may still be read
}

template <typename XT, typename ST, int NT>
int launch_nt(const void* x, const void* w, const void* scale, void* out, int B, int K,
              int N, int splits, int k_per_split, cudaStream_t stream) {
  using L = Layout<XT, NT>;
  Params<XT, ST> p;
  int err = kt::encode_rows(&p.tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, K, N, BN, BK);
  if (!err)
    err = kt::encode_rows(&p.tm_x,
                          sizeof(XT) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          sizeof(XT), x, B, K, L::XCOLS, L::ROWS);
  if (err) return err;
  p.scale = static_cast<const ST*>(scale);
  p.out = static_cast<XT*>(out);
  p.B = B; p.K = K; p.N = N; p.k_per_split = k_per_split;
  // above 48 KB of shared memory needs an opt-in (per device, so every call)
  cudaError_t e = cudaFuncSetAttribute(w8a16_kernel<XT, ST, NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + L::ROWS - 1) / L::ROWS, N / BN, splits);
  cfg.blockDim = dim3(NTHREAD);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, w8a16_kernel<XT, ST, NT>, p);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename XT, typename ST>
int launch(const void* x, const void* w, const void* scale, void* out, int B, int K, int N,
           int splits, int k_per_split, cudaStream_t stream) {
  if (B <= 8)
    return launch_nt<XT, ST, 1>(x, w, scale, out, B, K, N, splits, k_per_split, stream);
  if (B <= 16)
    return launch_nt<XT, ST, 2>(x, w, scale, out, B, K, N, splits, k_per_split, stream);
  return launch_nt<XT, ST, 4>(x, w, scale, out, B, K, N, splits, k_per_split, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. N % 128 == 0, K % 16 == 0, x and w
// 16-byte aligned, 1 <= splits <= 8, k_per_split % BK == 0 and every split
// non-empty (the wrapper checks and picks). Returns a cudaError_t, or a code
// kt_error_string explains.
extern "C" int kt_int8_matmul(const void* x, const void* w, const void* scale,
                              void* out, int B, int K, int N, int splits,
                              int k_per_split, int x_dtype, int s_dtype,
                              void* stream) {
  if (B <= 0 || K <= 0 || N <= 0 || splits <= 0 || splits > MAX_SPLITS ||
      N % BN != 0 || K % KSTEP != 0 || k_per_split <= 0 || k_per_split % BK != 0 ||
      (long long)splits * k_per_split < K || (long long)(splits - 1) * k_per_split >= K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && s_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, scale, out, B, K, N, splits, k_per_split, s);
  if (x_dtype == 1 && s_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, scale, out, B, K, N, splits, k_per_split, s);
  if (x_dtype == 0 && s_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w, scale, out, B, K, N, splits, k_per_split, s);
  if (x_dtype == 0 && s_dtype == 0)
    return launch<float, float>(x, w, scale, out, B, K, N, splits, k_per_split, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kt_error_string(int err) { return kt::error_string(err); }
