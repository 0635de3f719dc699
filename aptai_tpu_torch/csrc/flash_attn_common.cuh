// Device helpers shared by the package's kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu, fused_conv_ln_gelu.cu): tile loads into shared memory,
// asynchronous 16- and 4-byte copies, ldmatrix fragment loads and the
// m16n8k16 bf16 tensor-core product with its fragment packing.
//
// mma.sync m16n8k16 fragment layout (PTX ISA), with g = lane / 4 and
// t4 = lane % 4:
//   A (16 x 16, row-major): a[0] = (row g, cols 2t4, 2t4+1), a[1] = (row g+8,
//     same cols), a[2] = (row g, cols 2t4+8, +9), a[3] = (row g+8, same)
//   B (16 x 8, "col"): b[0] = (rows 2t4, 2t4+1; col g), b[1] = (rows 2t4+8,
//     +9; col g)
//   C (16 x 8): c[0], c[1] = (row g, cols 2t4, 2t4+1), c[2], c[3] = (row
//     g+8, same cols)
// so the C fragments of n-tiles 2j and 2j+1 are exactly the A fragment of
// k-step j of a following product: a probability tile computed in registers
// feeds the next tensor-core product without a trip through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
// shared-memory row pitch of a bf16 tile in elements: 144 bytes keeps every
// fragment read free of bank conflicts and every row 16-byte aligned
constexpr int kPitch = kHeadDim + 8;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats -> bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes global -> shared without passing through registers; with
// valid == false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

// the same for one 4-byte value (a float of a per-row statistic)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kPending of this thread's committed groups are still
// in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and register j receives matrix j's fragment
// (row lane / 4, columns 2 (lane % 4) and + 1): the mma.sync layout
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// rows [r0, r0 + 64) of a (T, 64) bf16 slice with row stride `stride` into
// shared memory at pitch kPitch, by a block of kNumThreads threads; rows at
// or past T are zero-filled. The thread count is a compile-time constant so
// that the loop unrolls and its loads are all in flight together.
template <int kNumThreads>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int r0, int t) {
#pragma unroll
  for (int c = threadIdx.x; c < 64 * (kHeadDim / 8); c += kNumThreads) {
    const int r = c / (kHeadDim / 8);
    const int col = (c % (kHeadDim / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t) {
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + col);
    }
    *reinterpret_cast<uint4*>(dst + r * kPitch + col) = val;
  }
}

// the same for float32, at pitch kHeadDim
template <int kNumThreads>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long stride, int r0,
                                              int t) {
#pragma unroll
  for (int c = threadIdx.x; c < 64 * (kHeadDim / 4); c += kNumThreads) {
    const int r = c / (kHeadDim / 4);
    const int col = (c % (kHeadDim / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < t) {
      val = *reinterpret_cast<const float4*>(src + (r0 + r) * stride + col);
    }
    *reinterpret_cast<float4*>(dst + r * kHeadDim + col) = val;
  }
}

// a 16 x 64 row block of a bf16 tile (rows r0 .. r0+15 at pitch kPitch) as
// the A fragments of 4 k-steps of 16 over the head dim
__device__ __forceinline__ void load_a_frags(uint32_t a[kHeadDim / 16][4],
                                             const __nv_bfloat16* tile,
                                             int r0) {
  const int lane = threadIdx.x % 32;
  const int r = r0 + lane / 4;
#pragma unroll
  for (int ks = 0; ks < kHeadDim / 16; ++ks) {
    const int c = ks * 16 + 2 * (lane % 4);
    a[ks][0] = ld_u32(&tile[r * kPitch + c]);
    a[ks][1] = ld_u32(&tile[(r + 8) * kPitch + c]);
    a[ks][2] = ld_u32(&tile[r * kPitch + c + 8]);
    a[ks][3] = ld_u32(&tile[(r + 8) * kPitch + c + 8]);
  }
}

// B fragment for a product contracting over the tile's ROWS: rows
// k0 + 2t4 (+1, +8, +9) of column n0 + g, gathered from a row-major tile
__device__ __forceinline__ void load_b_rows(uint32_t b[2],
                                            const __nv_bfloat16* tile,
                                            int k0, int n0) {
  const int lane = threadIdx.x % 32;
  const int key = k0 + 2 * (lane % 4);
  const int n = n0 + lane / 4;
  b[0] = pack_bf16(tile[key * kPitch + n], tile[(key + 1) * kPitch + n]);
  b[1] = pack_bf16(tile[(key + 8) * kPitch + n],
                   tile[(key + 9) * kPitch + n]);
}

// B fragment for a product contracting over the tile's COLUMNS (the head
// dim): row n0 + g, columns k0 + 2t4 (+1) and k0 + 2t4 + 8 (+9)
__device__ __forceinline__ void load_b_cols(uint32_t b[2],
                                            const __nv_bfloat16* tile,
                                            int n0, int k0) {
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* r = &tile[(n0 + lane / 4) * kPitch + k0 +
                                 2 * (lane % 4)];
  b[0] = ld_u32(r);
  b[1] = ld_u32(r + 8);
}

}  // namespace
