// Flash-attention forward with per-item key lengths, for Hopper (sm_90a).
//
// Replaces the TPU kernel aptai_tpu/ops/attention.py:_flash_kernel (launched
// by _fwd_call). Same function, not the same blocks:
//   s   = (q . k^T) * scale          bf16 products, f32 accumulation; the
//                                    scale is applied in f32 after the dot
//   s   = -inf where key >= length[b]
//   online softmax over key tiles with f32 running max m, sum l, acc
//   p   = exp(s - m), rounded to bf16 before p . v (l sums the f32 p)
//   out = acc / (l == 0 ? 1 : l)     a row with no valid key gives 0
//   lse = m + log(l)                 optional, f32 (B, H, T), for the
//                                    backward; +inf for a row with no
//                                    valid key, so exp(s - lse) is 0 there
// Query rows at or after length[b] are computed like any other row (the
// TV low-pass downstream reads pad frames). Any T is accepted: ragged tiles
// are zero-filled in shared memory and their keys masked.
//
// Layout: q, k, v, o are (B, H, T, 64) with any batch / head / time strides
// (multiples of 8 elements) and a contiguous head dimension, so the model
// passes its projection outputs (B, T, H, D) without a relayout.
//
// What bounds it on this card: at the serving shape (B=32, H=16, T=499,
// D=64) the work is 4*B*H*T^2*D = 3.3e10 FLOP (33 us at 989 TFLOP/s) and the
// traffic q, k, v, o = 131 MB (39 us at 3.35 TB/s), so bytes bound it, just;
// each block's chain (copies in, q . k^T, softmax, p . v) is short, so what
// decides the time is how well the blocks on an SM hide each other's
// chains, and how often K and V come from device memory rather than L2.
// The bf16 kernel's design (the backward's, flash_attn_bwd.cu):
//   - one warpgroup (128 threads) owns 64 query rows of one (b*h), and two
//     warpgroups, 128 rows, make a block that shares each K/V tile; the
//     blocks of one (b*h) are consecutive in the grid, so they run together
//     and its K and V come from device memory once and from L2 after;
//   - every tile reaches shared memory by cp.async into 128-byte-swizzled,
//     1024-byte-aligned tiles: the Q tile and the first K/V tile as one
//     group, then a two-stage ring of 128-key tiles in which tile i + 1 is
//     in flight while tile i is multiplied;
//   - s = q . k^T is one wgmma m64n64k16 group per 64 keys with both
//     operands in shared memory (K K-major), f32 accumulators;
//   - the online softmax runs in registers on the accumulator layout (the
//     rows a thread owns are the mma.sync C layout's, so a row's max and
//     sum are shuffles over the 4 lanes that share it);
//   - acc += p . v is wgmma m64n64k16 with p, rounded to bf16, as the A
//     operand straight from registers and V read transposed from its
//     swizzled tile: no gathers of V;
//   - the output is divided by l in registers, staged in the Q tile and
//     written in 16-byte pieces at the caller's strides;
//   - 81 KB of shared memory a block and at most 128 registers a thread,
//     so 2 blocks (4 warpgroups) fit on an SM.
// Each of these choices was timed against its alternatives on the card
// (PERF.md): one warpgroup a block, 64-key tiles, three stages, s in
// 32-key halves, and a grid ordered by query tile were all slower.
// Key tiles wholly past length[b] are skipped, since every key in them is
// masked.

#include <math.h>

#include "wgmma_tiles.cuh"

namespace {

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;          // (B, H, T) contiguous, or null
  const int* lengths;  // (B,)
  int heads, t;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  float scale;
  int q_tiles;  // query tiles per (b*h)
};

// ---------------------------------------------------------------- bf16 ----

constexpr int kGroups = 2;                       // warpgroups a block
constexpr int kRowsQ = kGroups * kTileRows;      // query rows a block
constexpr int kThreadsBf16 = kGroups * kWarpgroupThreads;
constexpr int kKeys = 128;     // keys a ring stage holds
constexpr int kSubKeys = 64;   // keys per s product and softmax step
constexpr int kStages = 2;     // ring stages of a K and a V tile each
constexpr int kKeyTileBytes = kKeys * 128;
// the Q tile, the ring, and slack to align the first tile to 1024 bytes
constexpr int kSmemBf16 = kRowsQ * 128 + kStages * 2 * kKeyTileBytes + 1024;
static_assert(kKeys % kSubKeys == 0, "whole s products a ring stage");

// keys [k0, k0 + kKeys) of this (b*h)'s K and V into a ring stage (K, then V)
__device__ __forceinline__ void copy_kv(unsigned char* stage,
                                        const __nv_bfloat16* kg,
                                        const __nv_bfloat16* vg,
                                        const Params& p, int k0) {
  copy_tile_async<kKeys, kThreadsBf16>(stage, kg, p.k_st, k0, p.t);
  copy_tile_async<kKeys, kThreadsBf16>(stage + kKeyTileBytes, vg, p.v_st, k0,
                                       p.t);
}

// s (this warp's 16 rows x 64 keys, accumulator layout) = q_tile .
// k_rows[0 : 64]^T over the 64 head columns, both from swizzled tiles.
// Issued and waited for: the wait also retires a p . v still in flight.
__device__ __forceinline__ void wg_scores(float (&s)[kSubKeys / 2],
                                          const unsigned char* q_tile,
                                          const unsigned char* k_rows) {
  const uint64_t dq = smem_desc(q_tile);
  const uint64_t dk = smem_desc(k_rows);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kHeadDim / 16; ++ks) {
    wgmma_m64n64k16(s, dq + 2 * ks, dk + 2 * ks, ks > 0);
  }
  wgmma_commit_and_wait();
  fence_regs(s);
}

__global__ void __launch_bounds__(kThreadsBf16, 2)
flash_fwd_bf16_kernel(const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = aligned_smem(smem_raw);
  unsigned char* const sQ = smem;  // kRowsQ rows; the output's, at the end
  // ring stage st: its K tile at sKV + 2 st key tiles, its V tile after it
  unsigned char* const sKV = smem + kRowsQ * 128;

  // consecutive blocks share (b, h)
  const int bh = blockIdx.x / p.q_tiles;
  const int q0 = (blockIdx.x % p.q_tiles) * kRowsQ;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int qr = (threadIdx.x / 32) * 16 + lane / 4;  // rows qr, qr + 8
  // this warpgroup's 64 rows of the Q tile
  const unsigned char* const sQw =
      sQ + (threadIdx.x / kWarpgroupThreads) * kTileRows * 128;

  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const int len = min(max(p.lengths[b], 0), p.t);
  const int num_k_tiles = (len + kKeys - 1) / kKeys;

  // one group: the Q tile and the first K/V tile; then one group a tile
  copy_tile_async<kRowsQ, kThreadsBf16>(sQ, qg, p.q_st, q0, p.t);
  if (num_k_tiles > 0) copy_kv(sKV, kg, vg, p, 0);
  cp_async_commit();

  // per thread: rows qr (index 0) and qr + 8 (index 1)
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[kHeadDim / 8][4];
  zero_acc(acc);

  for (int kt = 0; kt < num_k_tiles; ++kt) {
    cp_async_wait<0>();  // tile kt has landed ...
    fence_proxy_async();
    // ... for every thread; and every warp has retired the products that
    // read the stage the next copy overwrites
    __syncthreads();
    if (kt + 1 < num_k_tiles) {
      copy_kv(sKV + ((kt + 1) % kStages) * 2 * kKeyTileBytes, kg, vg, p,
              (kt + 1) * kKeys);
    }
    cp_async_commit();
    const unsigned char* sK = sKV + (kt % kStages) * 2 * kKeyTileBytes;
    const unsigned char* sV = sK + kKeyTileBytes;

#pragma unroll
    for (int sub = 0; sub < kKeys / kSubKeys; ++sub) {
      const int c0 = kt * kKeys + sub * kSubKeys;
      if (c0 >= len) break;
      float s[kSubKeys / 2];
#pragma unroll
      for (int i = 0; i < kSubKeys / 2; ++i) s[i] = 0.f;
      wg_scores(s, sQw, sK + sub * kSubKeys * 128);
      fence_acc(acc);  // acc is settled: no p . v is in flight

      // scale, mask, row max (the 4 threads of a quad share a row)
      const bool whole = c0 + kSubKeys <= len;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kSubKeys / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = c0 + n * 8 + 2 * t4 + (i & 1);
          const float x =
              whole || col < len ? s[4 * n + i] * p.scale : -INFINITY;
          s[4 * n + i] = x;
          mx[i / 2] = fmaxf(mx[i / 2], x);
        }
      }
      float m_use[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        // a row with no valid key so far keeps p = 0 and alpha = 0
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = __expf(m[r] - m_use[r]);
        m[r] = m_new;
      }

      // p = exp(s - m), in bf16 as the A fragments of p . v (n-tiles 2j
      // and 2j + 1 make k-step j); l sums the f32 p
      float rs[2] = {0.f, 0.f};
      uint32_t pa[kSubKeys / 16][4];
#pragma unroll
      for (int n = 0; n < kSubKeys / 8; ++n) {
        const float p0 = __expf(s[4 * n + 0] - m_use[0]);
        const float p1 = __expf(s[4 * n + 1] - m_use[0]);
        const float p2 = __expf(s[4 * n + 2] - m_use[1]);
        const float p3 = __expf(s[4 * n + 3] - m_use[1]);
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(p0, p1);
        pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = l[r] * alpha[r] + rs[r];
      }
#pragma unroll
      for (int n = 0; n < kHeadDim / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      wg_rows(acc, pa, sV, sub * kSubKeys);  // acc += p . v, issued
    }
    // retired before the barrier that lets the next copy overwrite V
    wg_wait(acc);
  }
  cp_async_wait<0>();  // the Q tile's group, when no key tile ran
  __syncthreads();     // every product has read the Q tile

  __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    denom[r] = l[r] == 0.f ? 1.f : l[r];
    const int row = q0 + qr + r * 8;
    // the 4 threads of a quad hold the same m and l; one writes the lse
    if (p.lse != nullptr && t4 == 0 && row < p.t) {
      p.lse[static_cast<long long>(bh) * p.t + row] =
          l[r] == 0.f ? INFINITY : m[r] + logf(l[r]);
    }
  }
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n) {
    acc[n][0] = acc[n][0] / denom[0];
    acc[n][1] = acc[n][1] / denom[0];
    acc[n][2] = acc[n][2] / denom[1];
    acc[n][3] = acc[n][3] / denom[1];
  }
  stage_rows(sQ, acc, 1.f);
  __syncthreads();
  store_tile<kRowsQ, kThreadsBf16>(og, p.o_st, sQ, q0, p.t);
}

// ------------------------------------------------------------- float32 ----

constexpr int kBlockQ = 64;  // query rows (and threads) a block
constexpr int kBlockK = 64;

// The float32 variant, for models run in float32 (the bf16 kernel above is
// the serving path). The same function with full-precision products and no
// rounding of p: one thread per query row, 64 rows per block, K/V tiles of
// 64 keys in shared memory read as broadcasts, scalar FMAs.
struct ParamsF32 {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;
  const int* lengths;
  int heads, t;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  float scale;
};

__global__ void __launch_bounds__(kBlockQ)
flash_fwd_f32_kernel(const ParamsF32 p) {
  __shared__ __align__(16) float sK[kBlockK * kHeadDim];
  __shared__ __align__(16) float sV[kBlockK * kHeadDim];

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int row = blockIdx.y * kBlockQ + threadIdx.x;
  const float* kg = p.k + b * p.k_sb + h * p.k_sh;
  const float* vg = p.v + b * p.v_sb + h * p.v_sh;
  const int len = min(max(p.lengths[b], 0), p.t);

  float qr[kHeadDim];
  float acc[kHeadDim];
  const float* qg = p.q + b * p.q_sb + h * p.q_sh + row * p.q_st;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) {
    qr[d] = row < p.t ? qg[d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  const int num_k_tiles = (len + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < num_k_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    load_tile_f32<kBlockQ>(sK, kg, p.k_st, k0, p.t);
    load_tile_f32<kBlockQ>(sV, vg, p.v_st, k0, p.t);
    __syncthreads();

    float s[kBlockK];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) {
        dot = fmaf(qr[d], sK[j * kHeadDim + d], dot);
      }
      s[j] = k0 + j < len ? dot * p.scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m - m_use);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      s[j] = expf(s[j] - m_use);
      rs += s[j];
    }
    l = l * alpha + rs;
    m = m_new;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) {
        acc[d] = fmaf(s[j], sV[j * kHeadDim + d], acc[d]);
      }
    }
  }

  if (row >= p.t) return;
  const float denom = l == 0.f ? 1.f : l;
  if (p.lse != nullptr) {
    p.lse[static_cast<long long>(bh) * p.t + row] =
        l == 0.f ? INFINITY : m + logf(l);
  }
  float* og = p.o + b * p.o_sb + h * p.o_sh + row * p.o_st;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) og[d] = acc[d] / denom;
}

template <typename P, typename E>
void fill_params(P& p, const void* q, const void* k, const void* v, void* o,
                 void* lse, const void* lengths, int heads, int t,
                 const long long* strides, float scale) {
  p.q = static_cast<const E*>(q);
  p.k = static_cast<const E*>(k);
  p.v = static_cast<const E*>(v);
  p.o = static_cast<E*>(o);
  p.lse = static_cast<float*>(lse);
  p.lengths = static_cast<const int*>(lengths);
  p.heads = heads;
  p.t = t;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_st = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_st = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_st = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_st = strides[11];
  p.scale = scale;
}

}  // namespace

// Both entry points launch on `stream` and return cudaGetLastError() (0 on
// success). Strides are in elements, in the order q, k, v, o and within
// each batch, head, time; lengths is a device pointer to B int32 values;
// lse is null or a contiguous (B, H, T) float32 buffer.
#define APTAI_FLASH_ARGS                                                     \
  const void *q, const void *k, const void *v, void *o, void *lse,           \
      const void *lengths, int batch, int heads, int t, int head_dim,        \
      long long q_sb, long long q_sh, long long q_st, long long k_sb,        \
      long long k_sh, long long k_st, long long v_sb, long long v_sh,        \
      long long v_st, long long o_sb, long long o_sh, long long o_st,        \
      float scale, void *stream
#define APTAI_FLASH_STRIDES                                                  \
  {q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st}

extern "C" int aptai_flash_attn_fwd_bf16(APTAI_FLASH_ARGS) {
  if (head_dim != kHeadDim || batch <= 0 || heads <= 0 || t <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long strides[12] = APTAI_FLASH_STRIDES;
  Params p;
  fill_params<Params, __nv_bfloat16>(p, q, k, v, o, lse, lengths, heads, t,
                                     strides, scale);
  p.q_tiles = (t + kRowsQ - 1) / kRowsQ;
  const long long blocks = static_cast<long long>(batch) * heads * p.q_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // above the 48 KB default; as much of L1 as shared memory as can be, so
  // that 2 blocks fit on an SM
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBf16);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_fwd_bf16_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_bf16_kernel<<<static_cast<unsigned>(blocks), kThreadsBf16,
                          kSmemBf16, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int aptai_flash_attn_fwd_f32(APTAI_FLASH_ARGS) {
  if (head_dim != kHeadDim || batch <= 0 || heads <= 0 || t <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long strides[12] = APTAI_FLASH_STRIDES;
  ParamsF32 p;
  fill_params<ParamsF32, float>(p, q, k, v, o, lse, lengths, heads, t,
                                strides, scale);
  const dim3 grid(batch * heads, (t + kBlockQ - 1) / kBlockQ);
  flash_fwd_f32_kernel<<<grid, kBlockQ, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
