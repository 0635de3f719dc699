// Swizzled shared-memory tiles and warpgroup (wgmma) products, shared by
// the attention kernels (flash_attn_fwd.cu, flash_attn_bwd.cu) and the
// fused conv (fused_conv_ln_gelu.cu, whose tiles arrive by TMA).
//
// A tile holds rows of 64 bf16 head columns (128 bytes each), stored with
// the 128-byte swizzle: 16-byte chunk c of row r at chunk c ^ (r % 8). It
// starts on a 1024-byte boundary, the swizzle's period. wgmma reads such a
// tile by descriptor either K-major (the head dim contracted, as in q . k^T)
// or transposed (its rows contracted, as in p . v), and ldmatrix reads it
// without bank conflicts. Tiles reach shared memory by cp.async, 16 bytes a
// copy; results are staged in a tile and written out 16 bytes a store.
//
// wgmma m64nN accumulators over a warpgroup (4 warps, 128 threads): warp w
// holds rows 16w .. 16w + 15, and register 4j + i of a thread holds (row
// 16w + lane/4 + 8 (i / 2), column 8j + 2 (lane % 4) + i % 2), the mma.sync
// C layout of N/8 n-tiles. Its A operand from registers takes the mma.sync
// A layout, so an accumulator packed to bf16 feeds the next product as is.

#pragma once

#include "flash_attn_common.cuh"

namespace {

constexpr int kTileRows = 64;            // rows of a warpgroup's tile
constexpr int kWarpgroupThreads = 128;   // 4 warps

// byte offset of 16-byte chunk c (8 head columns) of row r in a swizzled
// bf16 tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// the block's shared memory from its first 1024-byte boundary
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(raw));
  return raw + ((1024u - (a & 1023u)) & 1023u);
}

// rows [r0, r0 + kRows) of a (T, 64) bf16 slice into a swizzled tile by
// kNumThreads threads, 16 bytes a copy, neighbouring threads on
// neighbouring chunks; rows at or past T are zero-filled and not read
template <int kRows = kTileRows, int kNumThreads = kWarpgroupThreads>
__device__ __forceinline__ void copy_tile_async(unsigned char* tile,
                                                const __nv_bfloat16* src,
                                                long long stride, int r0,
                                                int t) {
  static_assert(kRows * 8 % kNumThreads == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < kRows * 8 / kNumThreads; ++i) {
    const int idx = threadIdx.x + i * kNumThreads;
    const int r = idx / 8;
    const int c = idx % 8;
    const bool valid = r0 + r < t;
    cp_async16(tile + swz(r, c),
               valid ? src + (r0 + r) * stride + c * 8 : src, valid);
  }
}

// a tile of bf16 results (this warp's 16 rows in the accumulator layout,
// at rows 16 (threadIdx.x / 32) of the tile) into a swizzled tile
__device__ __forceinline__ void stage_rows(unsigned char* tile,
                                          float (&acc)[kHeadDim / 8][4],
                                          float mult) {
  const int lane = threadIdx.x % 32;
  const int r = (threadIdx.x / 32) * 16 + lane / 4;
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n) {
    const int byte = 4 * (lane % 4);
    *reinterpret_cast<uint32_t*>(tile + swz(r, n) + byte) =
        pack_bf16(acc[n][0] * mult, acc[n][1] * mult);
    *reinterpret_cast<uint32_t*>(tile + swz(r + 8, n) + byte) =
        pack_bf16(acc[n][2] * mult, acc[n][3] * mult);
  }
}

// the rows of a staged tile below T out to rows [r0, r0 + kRows) of a
// (T, 64) slice, 16 bytes a store
template <int kRows = kTileRows, int kNumThreads = kWarpgroupThreads>
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst,
                                           long long stride,
                                           const unsigned char* tile, int r0,
                                           int t) {
  static_assert(kRows * 8 % kNumThreads == 0, "whole stores per thread");
#pragma unroll
  for (int i = 0; i < kRows * 8 / kNumThreads; ++i) {
    const int idx = threadIdx.x + i * kNumThreads;
    const int r = idx / 8;
    const int c = idx % 8;
    if (r0 + r < t) {
      *reinterpret_cast<uint4*>(dst + (r0 + r) * stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz(r, c));
    }
  }
}

// wgmma shared-memory descriptor of a swizzled tile (from a row that is a
// multiple of 8): K-major, 128-byte swizzle, 1024 bytes between 8-row
// groups. Adding 2 moves it 32 bytes, one k-step of 16 bf16, along the row.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// make cp.async's writes to shared memory (generic proxy) visible to wgmma
// (async proxy); each writing thread, before the barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from moving accesses to wgmma's accumulators across
// the instructions that issue and retire it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 32 over the warpgroup) (+)= A (64 x 16) . B^T (32 x 16), both
// from shared memory through descriptors
__device__ __forceinline__ void wgmma_m64n32k16(float d[16], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 over the warpgroup) (+)= A (64 x 16) . B^T (64 x 16), both
// from shared memory through descriptors
__device__ __forceinline__ void wgmma_m64n64k16(float d[32], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128 over the warpgroup) (+)= A (64 x 16) . B^T (128 x 16), both
// from shared memory through descriptors
__device__ __forceinline__ void wgmma_m64n128k16(float d[64], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 256 over the warpgroup) (+)= A (64 x 16) . B^T (256 x 16), both
// from shared memory through descriptors
__device__ __forceinline__ void wgmma_m64n256k16(float d[128], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N) (+)= A (64 x 16) . B^T (N x 16) for N = 64, 128 or 256,
// both operands from shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  static_assert(N == 64 || N == 128 || N == 256, "no wgmma wrapper for N");
  if constexpr (N == 64) {
    wgmma_m64n64k16(d, a, b, accumulate);
  } else if constexpr (N == 128) {
    wgmma_m64n128k16(d, a, b, accumulate);
  } else {
    wgmma_m64n256k16(d, a, b, accumulate);
  }
}

// d (64 x 64 over the warpgroup) += A (64 x 16) . B (16 x 64): A in
// registers, each warp its 16 rows in the mma.sync A layout; B from shared
// memory with its N (head) dimension contiguous, read transposed. d in the
// accumulator layout, d[n][i] as register 4n + i above.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[kHeadDim / 8][4],
                                                   const uint32_t a[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) fence_regs(acc[n]);
}

// acc (this warp's 16 rows x 64 head columns) += a . tile[r0 : r0 + 16 K],
// contracting over 16 K rows of a swizzled tile: a[kk] is the A fragment
// of rows r0 + 16 kk .. + 15; issued, not waited for
template <int K>
__device__ __forceinline__ void wg_rows(float (&acc)[kHeadDim / 8][4],
                                        uint32_t (&a)[K][4],
                                        const unsigned char* tile, int r0) {
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    wgmma_m64n64k16_rs(acc, a[kk], smem_desc(tile + (r0 + kk * 16) * 128));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait for every wgmma this warpgroup issued
template <int N>
__device__ __forceinline__ void wg_wait(float (&acc)[N][4]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
}

__device__ __forceinline__ void zero_acc(float (&acc)[kHeadDim / 8][4]) {
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
}

}  // namespace
