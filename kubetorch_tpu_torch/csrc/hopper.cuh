// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA loads and bulk copies, wgmma on 128-byte-swizzled shared memory,
// register rebalancing between warpgroups, and the host-side tensor-map
// encoding (the flash-attention kernels' 4-D bf16 maps, the int8 matmul's
// 2-D weight and activation maps).
//
// Shared-memory tile layout used throughout: a [rows x 128] bf16 tile (one
// head of D = 128) is stored as two "sub-tiles" of [rows x 64], d 0-63 then
// d 64-127, each row 128 bytes, swizzled by TMA's 128-byte pattern (16-byte
// chunk c of row r sits at chunk c ^ (r % 8)). Every sub-tile starts on a
// 1024-byte boundary, so wgmma descriptors with layout type B128 read it
// directly:
//  - K-major operand (the reduction dim is d, contiguous): start address at
//    the sub-tile of the k-step plus 32 bytes per 16-wide step inside it,
//    SBO = 1024 bytes (8 rows), LBO unused;
//  - MN-major operand (the reduction dim is the row, d is the output dim):
//    start address 16 rows (2048 bytes) further per k-step, SBO = 1024 bytes
//    (8 rows), LBO = the sub-tile's size (the second 64 output columns), and
//    the instruction's transpose bit set.

#pragma once

#include <cstdint>
#include <cstdio>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace kt {

constexpr int HD = 128;                 // head dim (the only one taken)
constexpr int SUB_COLS = 64;            // bf16 columns per 128-byte swizzled row
constexpr int ROW_BYTES = 128;
// Launcher return codes at and above this carry a CUresult of
// cuTensorMapEncodeTiled (kt_error_string decodes them).
constexpr int kEncodeErrorBase = 100000;

// ----------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two consecutive f32 of shared memory (8-byte aligned).
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to complete the phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. (No __trap()
// watchdog here: a trap anywhere in the kernel makes ptxas allocate the
// consumer warpgroups as if setmaxnreg had not raised their budget.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 2-D tensor map (coordinates innermost first) into shared
// memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A contiguous run of bytes (16-byte aligned, a multiple of 16) into shared
// memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Barrier over `n` threads (a multiple of 32) on hardware barrier `id` > 0.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// wgmma shared-memory descriptor of the tile at `addr`, 128-byte swizzle
// (layout type 1).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major: a [rows x 128] tile at `tile`, rows from `tile` on.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile) {
  return make_desc(tile, 16, 1024);
}
// ... its 16-wide k-step `ks`: the sub-tile of `ks` (`sub_bytes` apart), 32
// bytes further per step inside it.
__device__ __forceinline__ uint64_t kstep_kmajor(uint64_t d, uint32_t sub_bytes, int ks) {
  return d + (((ks / 4) * sub_bytes + (ks % 4) * 32) >> 4);
}
// MN-major: a [rows x 128] tile whose rows are the reduction dim and whose
// 128 columns are N (the second 64 at LBO = sub_bytes).
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, uint32_t sub_bytes) {
  return make_desc(tile, sub_bytes, 1024);
}
// ... its k-step `kk`: rows 16kk..16kk+15.
__device__ __forceinline__ uint64_t kstep_mnmajor(uint64_t d, int kk) {
  return d + ((kk * 16 * ROW_BYTES) >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across a
// wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// The same for register A fragments that an issued wgmma still reads: they
// stay live, untouched, until the fence after its wait.
template <int M, int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

#define KT_F4(i) "+f"(d[i]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define KT_F16(i) KT_F4(i), KT_F4((i) + 4), KT_F4((i) + 8), KT_F4((i) + 12)
#define KT_F32(i) KT_F16(i), KT_F16((i) + 16)

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : KT_F32(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : KT_F32(0), KT_F32(32)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers (the accumulator
// fragment layout of a previous wgmma, packed to bf16), B MN-major in
// shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128_t(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : KT_F32(0), KT_F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef KT_F32
#undef KT_F16
#undef KT_F4

// The bf16 A fragments of a wgmma whose reduction runs over the columns of
// a [64 x NACC/4] f32 accumulator (columns 16kk..16kk+15 are k-step kk).
template <int NACC>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NACC / 8][4], const float (&c)[NACC]) {
#pragma unroll
  for (int kk = 0; kk < NACC / 8; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// Write a warpgroup's [64 x 128] f32 accumulator (rows scaled by sc0 for row
// g and sc1 for row g + 8 of each warp's 16) as bf16 rows of global memory.
// The tile goes through `region` (two 128-byte-swizzled [64 x 64] sub-tiles,
// `sub_bytes` apart, which only this warpgroup uses) so that the global
// stores are 16 bytes a thread, 256 contiguous bytes a row. Rows at or past
// `n_valid` are not written. `bar_id` is a named barrier for this warpgroup.
__device__ __forceinline__ void store_tile(const float (&d)[64], float sc0, float sc1,
                                           uint8_t* region, uint32_t sub_bytes,
                                           __nv_bfloat16* out, long long row_stride,
                                           int n_valid, int tw, int bar_id) {
  const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      const float sc = h ? sc1 : sc0;
      uint8_t* p = region + (j / 8) * sub_bytes + r * ROW_BYTES +
                   (((j % 8) ^ (r % 8)) * 16) + 4 * t;
      *reinterpret_cast<uint32_t*>(p) = pack_bf16(d[4 * j + 2 * h] * sc,
                                                  d[4 * j + 2 * h + 1] * sc);
    }
  }
  named_sync(bar_id, 128);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int id = tw + 128 * k;
    const int r = id >> 4, c16 = id & 15;
    const uint8_t* p = region + (c16 / 8) * sub_bytes + r * ROW_BYTES +
                       (((c16 % 8) ^ (r % 8)) * 16);
    if (r < n_valid)
      *reinterpret_cast<uint4*>(out + r * row_stride + c16 * 8) =
          *reinterpret_cast<const uint4*>(p);
  }
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no link
// against libcuda). Returns a cudaError_t.
static int encode_fn(EncodeTiledFn* out) {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return (int)cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  *out = fn;
  return 0;
}

// A tensor map over a bf16 tensor in the model's [B, S, H, 128] layout with
// element strides (sb, ss, sh) and a contiguous head dim: dims (d, h, s, b),
// boxes of 64 d x 1 head x `box_rows` rows x 1 batch row, 128-byte swizzle.
// Rows past S read as zeros. Returns 0, a cudaError_t, or
// kEncodeErrorBase + the CUresult.
static int encode_bshd(CUtensorMap* map, const void* ptr, int B, int S, int H,
                       long long sb, long long ss, long long sh, int box_rows) {
  EncodeTiledFn fn;
  const int err = encode_fn(&fn);
  if (err) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)SUB_COLS, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                        dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeErrorBase + (int)r;
}

// A tensor map over a row-major [rows x cols] matrix of `elem_bytes`-byte
// elements of type `dtype` (row stride cols * elem_bytes, a multiple of
// 16): boxes of `box_cols` x `box_rows` with box_cols * elem_bytes = 128,
// 128-byte swizzle (16-byte chunk c of box row r lands at chunk c ^ (r % 8)
// when the box is 1024-byte aligned). Rows and columns past the matrix read
// as zeros. Returns as encode_bshd.
static int encode_rows(CUtensorMap* map, CUtensorMapDataType dtype, int elem_bytes,
                       const void* ptr, long long rows, long long cols, int box_cols,
                       int box_rows) {
  EncodeTiledFn fn;
  const int err = encode_fn(&fn);
  if (err) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, dtype, 2, const_cast<void*>(ptr), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeErrorBase + (int)r;
}

// The message of a launcher's return code.
static const char* error_string(int err) {
  static char buf[96];
  if (err >= kEncodeErrorBase) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             err - kEncodeErrorBase);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// A kernel that rebalances registers with setmaxnreg needs the whole block's
// share at launch: `consumers` warpgroups at `hi` registers and the rest at
// `lo`. Refuse a build that allocated less (the increase would never be
// granted). Returns a cudaError_t.
static int check_register_budget(const void* kernel, int threads, int consumers, int hi,
                                 int lo) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  const int need = consumers * 128 * hi + (threads - consumers * 128) * lo;
  return attr.numRegs * threads >= need ? 0 : (int)cudaErrorInvalidConfiguration;
}

}  // namespace kt
