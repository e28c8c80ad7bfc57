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
//  - the products run on the tensor cores (mma.sync m16n8k16, bf16 operands,
//    f32 accumulators) with the weights as the A operand and x^T as B, so a
//    batch of 8 fills the mma's N = 8 exactly and the instruction budget goes
//    to moving and converting weight bytes, not to FMAs;
//  - each warp owns 128 output columns; per 16-row k-step every thread loads
//    4 rows x 16 contiguous bytes (16-byte loads; 8 threads cover 128
//    contiguous bytes of a row). The K order inside a k-step is permuted —
//    fragment k-index {2t, 2t+1, 2t+8, 2t+9} reads rows {4t .. 4t+3} — and x
//    is read with the same permutation, so every thread's loaded bytes are
//    exactly its own A fragments: no shared-memory transpose;
//  - int8 -> bf16 without I2F: a byte permute builds the float 2^23 + (v+128),
//    one subtraction leaves v exactly, and cvt packs two into bf16x2;
//  - f32 x is split into bf16 hi + lo parts (two mmas), keeping ~16 bits of
//    its mantissa instead of rounding it to bf16;
//  - four warps split a block's K range and meet in shared memory; across
//    blocks K is split (up to 16 ways) so about four blocks run per SM, and
//    the splits of one output tile form a thread-block cluster that sums its
//    f32 partials through distributed shared memory in a fixed order: no
//    workspace, no second kernel, no atomics, deterministic results;
//  - each warp loads the next k-step's weights before converting this one's.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NWARP = 4;            // warps per block, splitting K
constexpr int NTHREAD = NWARP * 32;
constexpr int BN = 128;             // output columns per block (all warps)
constexpr int KSTEP = 16;           // rows per mma k-step
constexpr int RED_LD = BN + 4;      // padded row of the reduction buffer
constexpr int MAX_SPLITS = 16;      // cluster size (16 is H100's non-portable max)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
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

// x[b][k .. k+3] as two bf16x2 B-fragment registers (hi parts), and for f32 x
// the bf16 remainders (lo parts).
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
  hi[0] = pack_f32(f[0], f[1]);
  hi[1] = pack_f32(f[2], f[3]);
  lo[0] = pack_f32(r[0], r[1]);
  lo[1] = pack_f32(r[2], r[3]);
}

// NT batch tiles of 8 rows per block: the batch chunk is 8 * NT rows. The
// grid's z blocks (the K splits) of one output tile form one cluster.
template <typename XT, typename ST, int NT>
__global__ void __launch_bounds__(NTHREAD)
w8a16_mma_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                 const ST* __restrict__ scale, XT* __restrict__ out,
                 int B, int K, int N, int k_per_split) {
  constexpr bool kSplitX = sizeof(XT) == 4;  // f32 x: hi + lo mmas
  __shared__ float red[NWARP][8][RED_LD];
  __shared__ float part[8 * NT][BN];         // this block's partial tile

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;   // mma fragment coordinates
  const int b0 = blockIdx.x * 8 * NT;
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int kbeg = split * k_per_split;
  const int kend = min(K, kbeg + k_per_split);

  float acc[8][NT][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[t][j][0] = acc[t][j][1] = acc[t][j][2] = acc[t][j][3] = 0.f;

  // this thread's 16 columns; its rows in a k-step are k0 + 4*tig + {0..3}.
  // The next k-step's weights are loaded before this one's are used.
  const int8_t* wp = w + n0 + 16 * g + (size_t)(4 * tig) * N;
  uint4 nxt[4];
  int k0 = kbeg + warp * KSTEP;
  if (k0 < kend) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      nxt[r] = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)(k0 + r) * N));
  }
  for (; k0 < kend; k0 += NWARP * KSTEP) {
    const int kr = k0 + 4 * tig;
    uint32_t wx[4][4];  // [row][word], each byte biased by +128
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      wx[r][0] = nxt[r].x ^ 0x80808080u;
      wx[r][1] = nxt[r].y ^ 0x80808080u;
      wx[r][2] = nxt[r].z ^ 0x80808080u;
      wx[r][3] = nxt[r].w ^ 0x80808080u;
    }
    const int kn = k0 + NWARP * KSTEP;
    if (kn < kend) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        nxt[r] = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)(kn + r) * N));
    }
    uint32_t xh[NT][2], xl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int b = b0 + 8 * j + g;
      if (b < B) {
        load_x(x + (size_t)b * K + kr, xh[j], xl[j]);
      } else {
        xh[j][0] = xh[j][1] = xl[j][0] = xl[j][1] = 0u;
      }
    }
    // m-tile t: fragment row g <-> column 16g + 2t, row g + 8 <-> 16g + 2t + 1
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int q = t >> 1, c0 = 2 * (t & 1), c1 = c0 + 1;
      uint32_t a[4];
      a[0] = pack_f32(byte_to_f32(wx[0][q], c0), byte_to_f32(wx[1][q], c0));
      a[1] = pack_f32(byte_to_f32(wx[0][q], c1), byte_to_f32(wx[1][q], c1));
      a[2] = pack_f32(byte_to_f32(wx[2][q], c0), byte_to_f32(wx[3][q], c0));
      a[3] = pack_f32(byte_to_f32(wx[2][q], c1), byte_to_f32(wx[3][q], c1));
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mma_bf16(acc[t][j], a, xh[j][0], xh[j][1]);
        if (kSplitX) mma_bf16(acc[t][j], a, xl[j][0], xl[j][1]);
      }
    }
  }

  // Sum the warps' partials per batch tile; thread i owns column n0 + i.
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int col = 16 * g + 2 * t;
      red[warp][2 * tig][col] = acc[t][j][0];
      red[warp][2 * tig + 1][col] = acc[t][j][1];
      red[warp][2 * tig][col + 1] = acc[t][j][2];
      red[warp][2 * tig + 1][col + 1] = acc[t][j][3];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < NWARP; ++q) s += red[q][r][threadIdx.x];
      part[8 * j + r][threadIdx.x] = s;
    }
  }

  // Sum the splits' partials across the cluster, split 0 first; block rank
  // r finishes the rows r, r + nsplit, ... of the tile.
  cg::cluster_group cluster = cg::this_cluster();
  const int nsplit = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  cluster.sync();
  const int n = n0 + threadIdx.x;
  const float sc = to_f32(scale[n]);
  for (int row = rank; row < 8 * NT; row += nsplit) {
    const int b = b0 + row;
    if (b >= B) break;
    float s = 0.f;
    for (int r = 0; r < nsplit; ++r) s += cluster.map_shared_rank(&part[row][0], r)[threadIdx.x];
    out[(size_t)b * N + n] = from_f32<XT>(s * sc);
  }
  cluster.sync();  // no block exits while its partials may still be read
}

template <typename XT, typename ST, int NT>
cudaError_t launch_nt(const void* x, const void* w, const void* scale, void* out,
                      int B, int K, int N, int splits, int k_per_split,
                      cudaStream_t stream) {
  if (splits > 8) {  // clusters above 8 blocks need an opt-in (per device)
    const cudaError_t err = cudaFuncSetAttribute(
        w8a16_mma_kernel<XT, ST, NT>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + 8 * NT - 1) / (8 * NT), N / BN, splits);
  cfg.blockDim = dim3(NTHREAD);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, w8a16_mma_kernel<XT, ST, NT>, static_cast<const XT*>(x),
      static_cast<const int8_t*>(w), static_cast<const ST*>(scale),
      static_cast<XT*>(out), B, K, N, k_per_split);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename XT, typename ST>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out,
                   int B, int K, int N, int splits, int k_per_split,
                   cudaStream_t stream) {
  if (B <= 8)
    return launch_nt<XT, ST, 1>(x, w, scale, out, B, K, N, splits, k_per_split, stream);
  if (B <= 16)
    return launch_nt<XT, ST, 2>(x, w, scale, out, B, K, N, splits, k_per_split, stream);
  return launch_nt<XT, ST, 4>(x, w, scale, out, B, K, N, splits, k_per_split, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. N % 128 == 0, K % 16 == 0,
// 1 <= splits <= 16 and k_per_split % 64 == 0 (the wrapper checks and picks).
// Returns a cudaError_t.
extern "C" int kt_int8_matmul(const void* x, const void* w, const void* scale,
                              void* out, int B, int K, int N, int splits,
                              int k_per_split, int x_dtype, int s_dtype,
                              void* stream) {
  if (B <= 0 || K <= 0 || N <= 0 || splits <= 0 || splits > MAX_SPLITS ||
      N % BN != 0 || K % KSTEP != 0 || k_per_split % (NWARP * KSTEP) != 0 ||
      (long long)splits * k_per_split < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && s_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, w, scale, out, B, K, N, splits, k_per_split, s);
  if (x_dtype == 1 && s_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(x, w, scale, out, B, K, N, splits, k_per_split, s);
  if (x_dtype == 0 && s_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(x, w, scale, out, B, K, N, splits, k_per_split, s);
  if (x_dtype == 0 && s_dtype == 0)
    return (int)launch<float, float>(x, w, scale, out, B, K, N, splits, k_per_split, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
