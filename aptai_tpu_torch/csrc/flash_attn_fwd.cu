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
// traffic q, k, v, o = 131 MB (39 us at 3.35 TB/s), so bytes bound it, just.
// This first version is simple rather than fast: one block of 4 warps per
// (b*h, 64-query tile); 64-key K/V tiles staged in shared memory with plain
// 16-byte loads; mma.sync m16n8k16 bf16 tensor-core products with f32
// accumulators in registers; no load/compute overlap. Key tiles past
// length[b] are skipped, since every key in them is masked. TMA, wgmma and
// warp specialisation are later work.

#include <math.h>

#include "flash_attn_common.cuh"

namespace {

constexpr int kBlockQ = 64;   // 4 warps x 16 query rows
constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

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
};

__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockQ * kPitch];
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockK * kPitch];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockK * kPitch];

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = blockIdx.y * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row group
  const int t4 = lane % 4;  // thread within the group

  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const int len = min(max(p.lengths[b], 0), p.t);

  load_tile<kThreads>(sQ, qg, p.q_st, q0, p.t);
  __syncthreads();

  // this warp's 16 query rows as A fragments, 4 k-steps of 16 over D
  uint32_t qa[kHeadDim / 16][4];
  load_a_frags(qa, sQ, warp * 16);
  const int qr = warp * 16 + g;

  // per thread: rows qr (index 0) and qr + 8 (index 1)
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  const int num_k_tiles = (len + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < num_k_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<kThreads>(sK, kg, p.k_st, k0, p.t);
    load_tile<kThreads>(sV, vg, p.v_st, k0, p.t);
    __syncthreads();

    // s = q . k^T for 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[kBlockK / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < kHeadDim / 16; ++ks) {
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) {
        uint32_t bf[2];
        load_b_cols(bf, sK, n * 8, ks * 16);
        mma_16816(s[n], qa[ks], bf);
      }
    }

    // scale, mask, row max (the 4 threads of a group share a row)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + n * 8 + 2 * t4 + (i & 1);
        const float x = col < len ? s[n][i] * p.scale : -INFINITY;
        s[n][i] = x;
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

    // p = exp(s - m); the C fragments of n-tiles 2j and 2j+1 are exactly
    // the A fragment of k-step j for the p . v product
    float rs[2] = {0.f, 0.f};
    uint32_t pa[kBlockK / 16][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      const float p0 = __expf(s[n][0] - m_use[0]);
      const float p1 = __expf(s[n][1] - m_use[0]);
      const float p2 = __expf(s[n][2] - m_use[1]);
      const float p3 = __expf(s[n][3] - m_use[1]);
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

    // acc += p . v: 4 k-steps of 16 keys, 8 n-tiles of 8 head columns
#pragma unroll
    for (int ks = 0; ks < kBlockK / 16; ++ks) {
#pragma unroll
      for (int n = 0; n < kHeadDim / 8; ++n) {
        uint32_t bf[2];
        load_b_rows(bf, sV, ks * 16, n * 8);
        mma_16816(acc[n], pa[ks], bf);
      }
    }
  }

  __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + r * 8;
    if (row >= p.t) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    // the 4 threads of a group hold the same m and l; one writes the lse
    if (p.lse != nullptr && t4 == 0) {
      p.lse[static_cast<long long>(bh) * p.t + row] =
          l[r] == 0.f ? INFINITY : m[r] + logf(l[r]);
    }
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) {
      const int col = n * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(og + row * p.o_st + col) =
          pack_bf16(acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
    }
  }
}

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
  const dim3 grid(batch * heads, (t + kBlockQ - 1) / kBlockQ);
  flash_fwd_bf16_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(p);
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
