// Device helpers shared by the package's kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu, fused_conv_ln_gelu.cu): asynchronous 16- and 4-byte
// copies into shared memory, ldmatrix fragment loads, bf16 packing, and
// float32 tile loads. The swizzled tiles and warpgroup products are in
// wgmma_tiles.cuh.
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
// A warpgroup's wgmma takes its A operand from registers in the same layout,
// each warp its own 16 rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;

// two floats -> bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// rows [r0, r0 + 64) of a (T, 64) float32 slice with row stride `stride`
// into shared memory at pitch kHeadDim, by a block of kNumThreads threads;
// rows at or past T are zero-filled. The thread count is a compile-time
// constant so that the loop unrolls and its loads are all in flight
// together.
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

}  // namespace
