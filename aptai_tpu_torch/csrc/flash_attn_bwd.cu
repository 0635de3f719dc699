// Flash-attention backward with per-item key lengths, for Hopper (sm_90a).
//
// Replaces the TPU kernels aptai_tpu/ops/attention.py:_flash_bwd_dq_kernel
// and _flash_bwd_dkv_kernel (both launched by _bwd_call). Same functions,
// not the same blocks. From the forward's inputs, its per-row logsumexp
// lse, the output gradient dO and delta = rowsum(dO * O) (f32, computed
// outside the kernels as in JAX):
//   s  = (q . k^T) * scale        bf16 products, f32 accumulation
//   p  = exp(s - lse), 0 where key >= length[b]   (masked by column index)
//   dp = dO . v^T
//   ds = p * (dp - delta), rounded to bf16 before its products
//   dq = scale * ds . k
//   dv = bf16(p)^T . dO
//   dk = scale * ds^T . q
// A row with no valid key has p = 0 everywhere, so its gradients are
// exactly 0 (its lse is +inf, and its keys are all masked in any case).
// Query rows at or after length[b] take part like any other row: their dO
// is real (the TV low-pass reads pad frames).
//
// The split is the TPU grid's own, and needs no atomics, so every sum is
// taken in one fixed order:
//   dq kernel:   one block of 4 warps per (b*h, 64-query tile), looping over
//                the 64-key tiles below length[b];
//   dk/dv kernel: one block of 4 warps per (b*h, 64-key tile), looping over
//                every 64-query tile (all T rows, pad rows included); a key
//                tile wholly past length[b] writes zeros and returns.
//
// Layout: q, k, v, dO and the outputs are (B, H, T, 64) with any batch /
// head / time strides (multiples of 8 elements) and a contiguous head
// dimension; lse and delta are contiguous (B, H, T) float32.
//
// What bounds them on this card: at the training shape (B=8, H=16, T=249,
// D=64, bf16, every frame valid) the dq kernel does 6*B*H*T^2*D = 3.0e9
// FLOP (3 us at 989 TFLOP/s) and moves q, k, v, dO, dq, lse, delta = 20.6 MB
// (6 us at 3.35 TB/s); the dk/dv kernel does 8*B*H*T^2*D = 4.1e9 FLOP
// (4 us) and moves 24.7 MB (7 us). Both are bound by bytes. This first
// version is simple rather than fast: tiles staged in shared memory with
// plain 16-byte loads, mma.sync m16n8k16 products with f32 accumulators in
// registers, the probability and ds tiles kept in registers as the A
// operand of the next product, operands that contract over tile rows
// gathered as scalars, no load/compute overlap. TMA, wgmma, ldmatrix and
// warp specialisation are later work.

#include <math.h>

#include "flash_attn_common.cuh"

namespace {

constexpr int kBlock = 64;  // rows of the block's own tile: 4 warps x 16
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <typename E>
struct BwdParams {
  const E* q;
  const E* k;
  const E* v;
  const E* dout;
  const float* lse;    // (B, H, T) contiguous
  const float* delta;  // (B, H, T) contiguous
  const int* lengths;  // (B,)
  E* out_a;            // dq (dq kernel) or dk (dk/dv kernel)
  E* out_b;            // dv (dk/dv kernel)
  int heads, t;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long do_sb, do_sh, do_st;
  long long a_sb, a_sh, a_st;
  long long b_sb, b_sh, b_st;
  float scale;
};

template <typename E>
struct Slices {  // this block's (b, h) slices of every tensor
  const E* q;
  const E* k;
  const E* v;
  const E* dout;
  E* a;
  E* b;
  const float* lse;
  const float* delta;
  int len;
};

template <typename E>
__device__ __forceinline__ Slices<E> slices(const BwdParams<E>& p) {
  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  Slices<E> s;
  s.q = p.q + b * p.q_sb + h * p.q_sh;
  s.k = p.k + b * p.k_sb + h * p.k_sh;
  s.v = p.v + b * p.v_sb + h * p.v_sh;
  s.dout = p.dout + b * p.do_sb + h * p.do_sh;
  s.a = p.out_a + b * p.a_sb + h * p.a_sh;
  s.b = p.out_b == nullptr ? nullptr : p.out_b + b * p.b_sb + h * p.b_sh;
  s.lse = p.lse + static_cast<long long>(bh) * p.t;
  s.delta = p.delta + static_cast<long long>(bh) * p.t;
  s.len = min(max(p.lengths[b], 0), p.t);
  return s;
}

// ---------------------------------------------------------------- bf16 ----

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const BwdParams<__nv_bfloat16> p) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlock * kPitch];  // q, then dO
  __shared__ __align__(16) __nv_bfloat16 sK[kBlock * kPitch];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlock * kPitch];

  const Slices<__nv_bfloat16> g = slices(p);
  const int q0 = blockIdx.y * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int qr = warp * 16 + lane / 4;  // rows qr and qr + 8 of the tile

  // this warp's 16 query rows of q and of dO as A fragments over D
  uint32_t qa[kHeadDim / 16][4];
  uint32_t doa[kHeadDim / 16][4];
  load_tile<kThreads>(sQ, g.q, p.q_st, q0, p.t);
  __syncthreads();
  load_a_frags(qa, sQ, warp * 16);
  __syncthreads();
  load_tile<kThreads>(sQ, g.dout, p.do_st, q0, p.t);
  __syncthreads();
  load_a_frags(doa, sQ, warp * 16);

  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + r * 8;
    // a row past T: p = exp(. - inf) = 0 and ds = 0
    lse[r] = row < p.t ? g.lse[row] : INFINITY;
    delta[r] = row < p.t ? g.delta[row] : 0.f;
  }

  float dq[kHeadDim / 8][4];
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n) {
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  }

  const int num_k_tiles = (g.len + kBlock - 1) / kBlock;
  for (int kt = 0; kt < num_k_tiles; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<kThreads>(sK, g.k, p.k_st, k0, p.t);
    load_tile<kThreads>(sV, g.v, p.v_st, k0, p.t);
    __syncthreads();

    // s = q . k^T and dp = dO . v^T, 16 rows x 64 keys each
    float s[kBlock / 8][4], dp[kBlock / 8][4];
#pragma unroll
    for (int n = 0; n < kBlock / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < kHeadDim / 16; ++ks) {
#pragma unroll
      for (int n = 0; n < kBlock / 8; ++n) {
        uint32_t bk[2], bv[2];
        load_b_cols(bk, sK, n * 8, ks * 16);
        load_b_cols(bv, sV, n * 8, ks * 16);
        mma_16816(s[n], qa[ks], bk);
        mma_16816(dp[n], doa[ks], bv);
      }
    }

    // ds = p * (dp - delta) in bf16, as the A fragments of ds . k
    uint32_t da[kBlock / 16][4];
#pragma unroll
    for (int n = 0; n < kBlock / 8; ++n) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + n * 8 + 2 * t4 + (i & 1);
        const float pv =
            col < g.len ? __expf(s[n][i] * p.scale - lse[i / 2]) : 0.f;
        ds[i] = pv * (dp[n][i] - delta[i / 2]);
      }
      da[n / 2][(n % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      da[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dq += ds . k: 4 k-steps of 16 keys, 8 n-tiles of 8 head columns
#pragma unroll
    for (int ks = 0; ks < kBlock / 16; ++ks) {
#pragma unroll
      for (int n = 0; n < kHeadDim / 8; ++n) {
        uint32_t bk[2];
        load_b_rows(bk, sK, ks * 16, n * 8);
        mma_16816(dq[n], da[ks], bk);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + r * 8;
    if (row >= p.t) continue;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) {
      *reinterpret_cast<uint32_t*>(g.a + row * p.a_st + n * 8 + 2 * t4) =
          pack_bf16(dq[n][2 * r] * p.scale, dq[n][2 * r + 1] * p.scale);
    }
  }
}

// zero rows [k0, min(k0 + 64, T)) of a (T, 64) output slice
template <typename E>
__device__ __forceinline__ void zero_rows(E* dst, long long stride, int k0,
                                          int t) {
  constexpr int kVec = 16 / sizeof(E);
  for (int c = threadIdx.x; c < kBlock * (kHeadDim / kVec); c += blockDim.x) {
    const int r = k0 + c / (kHeadDim / kVec);
    if (r < t) {
      *reinterpret_cast<uint4*>(dst + r * stride + (c % (kHeadDim / kVec)) *
                                kVec) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(const BwdParams<__nv_bfloat16> p) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlock * kPitch];
  __shared__ __align__(16) __nv_bfloat16 sO[kBlock * kPitch];  // dO
  __shared__ __align__(16) __nv_bfloat16 sKV[kBlock * kPitch];  // k, then v
  __shared__ float sLse[kBlock];
  __shared__ float sDelta[kBlock];

  const Slices<__nv_bfloat16> g = slices(p);
  const int k0 = blockIdx.y * kBlock;
  if (k0 >= g.len) {  // every key of the tile is masked
    zero_rows(g.a, p.a_st, k0, p.t);
    zero_rows(g.b, p.b_st, k0, p.t);
    return;
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int kr = warp * 16 + lane / 4;  // keys kr and kr + 8 of the tile
  const bool key_valid[2] = {k0 + kr < g.len, k0 + kr + 8 < g.len};

  // this warp's 16 keys of k and of v as A fragments over D
  uint32_t ka[kHeadDim / 16][4];
  uint32_t va[kHeadDim / 16][4];
  load_tile<kThreads>(sKV, g.k, p.k_st, k0, p.t);
  __syncthreads();
  load_a_frags(ka, sKV, warp * 16);
  __syncthreads();
  load_tile<kThreads>(sKV, g.v, p.v_st, k0, p.t);
  __syncthreads();
  load_a_frags(va, sKV, warp * 16);

  float dk[kHeadDim / 8][4], dv[kHeadDim / 8][4];
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;
  }

  const int num_q_tiles = (p.t + kBlock - 1) / kBlock;
  for (int qt = 0; qt < num_q_tiles; ++qt) {
    const int q0 = qt * kBlock;
    __syncthreads();  // every warp is done with the previous q/dO tile
    load_tile<kThreads>(sQ, g.q, p.q_st, q0, p.t);
    load_tile<kThreads>(sO, g.dout, p.do_st, q0, p.t);
    for (int i = threadIdx.x; i < kBlock; i += blockDim.x) {
      const int row = q0 + i;  // a row past T: p = 0 and ds = 0
      sLse[i] = row < p.t ? g.lse[row] : INFINITY;
      sDelta[i] = row < p.t ? g.delta[row] : 0.f;
    }
    __syncthreads();

    // transposed scores: s^T = k . q^T and dp^T = v . dO^T, 16 keys x 64
    // queries each
    float s[kBlock / 8][4], dp[kBlock / 8][4];
#pragma unroll
    for (int n = 0; n < kBlock / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < kHeadDim / 16; ++ks) {
#pragma unroll
      for (int n = 0; n < kBlock / 8; ++n) {
        uint32_t bq[2], bo[2];
        load_b_cols(bq, sQ, n * 8, ks * 16);
        load_b_cols(bo, sO, n * 8, ks * 16);
        mma_16816(s[n], ka[ks], bq);
        mma_16816(dp[n], va[ks], bo);
      }
    }

    // p^T and ds^T in bf16, as the A fragments of the products over queries
    uint32_t pa[kBlock / 16][4], da[kBlock / 16][4];
#pragma unroll
    for (int n = 0; n < kBlock / 8; ++n) {
      float pv[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = n * 8 + 2 * t4 + (i & 1);
        pv[i] = key_valid[i / 2] ? __expf(s[n][i] * p.scale - sLse[qc]) : 0.f;
        ds[i] = pv[i] * (dp[n][i] - sDelta[qc]);
      }
      pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(pv[0], pv[1]);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(pv[2], pv[3]);
      da[n / 2][(n % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      da[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dv += p^T . dO and dk += ds^T . q: 4 k-steps of 16 queries, 8 n-tiles
    // of 8 head columns
#pragma unroll
    for (int ks = 0; ks < kBlock / 16; ++ks) {
#pragma unroll
      for (int n = 0; n < kHeadDim / 8; ++n) {
        uint32_t bo[2], bq[2];
        load_b_rows(bo, sO, ks * 16, n * 8);
        load_b_rows(bq, sQ, ks * 16, n * 8);
        mma_16816(dv[n], pa[ks], bo);
        mma_16816(dk[n], da[ks], bq);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kr + r * 8;
    if (key >= p.t) continue;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) {
      const int col = n * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(g.a + key * p.a_st + col) =
          pack_bf16(dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(g.b + key * p.b_st + col) =
          pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------- float32 ----
//
// The float32 variants, for models run in float32 (the bf16 kernels above
// are the training path). The same functions with full-precision products
// and no rounding of p or ds. 128 threads per block own the block's 64 rows
// in pairs: the two threads of a pair (neighbouring lanes) each hold half
// of the row's 64 values, take partial dot products over their half and
// combine them with one shuffle. The tile looped over sits in shared
// memory and is read as broadcasts; scalar FMAs.

constexpr int kHalf = kHeadDim / 2;

// the pair's dot product of a (32 values in registers) with row `row` of a
// tile (at pitch kHeadDim), over this thread's half of the columns
__device__ __forceinline__ float pair_dot(const float a[kHalf],
                                          const float* tile, int row,
                                          int half) {
  const float* r = tile + row * kHeadDim + half * kHalf;
  float dot = 0.f;
#pragma unroll
  for (int d = 0; d < kHalf; ++d) dot = fmaf(a[d], r[d], dot);
  return dot + __shfl_xor_sync(0xffffffffu, dot, 1);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const BwdParams<float> p) {
  __shared__ __align__(16) float sK[kBlock * kHeadDim];
  __shared__ __align__(16) float sV[kBlock * kHeadDim];

  const Slices<float> g = slices(p);
  const int row = blockIdx.y * kBlock + threadIdx.x / 2;
  const int half = threadIdx.x % 2;
  const bool in_range = row < p.t;

  float q[kHalf], dout[kHalf], dq[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    q[d] = in_range ? g.q[row * p.q_st + half * kHalf + d] : 0.f;
    dout[d] = in_range ? g.dout[row * p.do_st + half * kHalf + d] : 0.f;
    dq[d] = 0.f;
  }
  const float lse = in_range ? g.lse[row] : INFINITY;
  const float delta = in_range ? g.delta[row] : 0.f;

  const int num_k_tiles = (g.len + kBlock - 1) / kBlock;
  for (int kt = 0; kt < num_k_tiles; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();
    load_tile_f32<kThreads>(sK, g.k, p.k_st, k0, p.t);
    load_tile_f32<kThreads>(sV, g.v, p.v_st, k0, p.t);
    __syncthreads();
    for (int j = 0; j < kBlock; ++j) {
      const float s = pair_dot(q, sK, j, half);
      const float dp = pair_dot(dout, sV, j, half);
      const float pv = k0 + j < g.len ? expf(s * p.scale - lse) : 0.f;
      const float ds = pv * (dp - delta);
      const float* kr = sK + j * kHeadDim + half * kHalf;
#pragma unroll
      for (int d = 0; d < kHalf; ++d) dq[d] = fmaf(ds, kr[d], dq[d]);
    }
  }

  if (!in_range) return;
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    g.a[row * p.a_st + half * kHalf + d] = dq[d] * p.scale;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const BwdParams<float> p) {
  __shared__ __align__(16) float sQ[kBlock * kHeadDim];
  __shared__ __align__(16) float sO[kBlock * kHeadDim];  // dO
  __shared__ float sLse[kBlock];
  __shared__ float sDelta[kBlock];

  const Slices<float> g = slices(p);
  const int k0 = blockIdx.y * kBlock;
  if (k0 >= g.len) {  // every key of the tile is masked
    zero_rows(g.a, p.a_st, k0, p.t);
    zero_rows(g.b, p.b_st, k0, p.t);
    return;
  }
  const int key = k0 + threadIdx.x / 2;
  const int half = threadIdx.x % 2;
  const bool in_range = key < p.t;
  const bool key_valid = key < g.len;

  float k[kHalf], v[kHalf], dk[kHalf], dv[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    k[d] = in_range ? g.k[key * p.k_st + half * kHalf + d] : 0.f;
    v[d] = in_range ? g.v[key * p.v_st + half * kHalf + d] : 0.f;
    dk[d] = dv[d] = 0.f;
  }

  const int num_q_tiles = (p.t + kBlock - 1) / kBlock;
  for (int qt = 0; qt < num_q_tiles; ++qt) {
    const int q0 = qt * kBlock;
    __syncthreads();
    load_tile_f32<kThreads>(sQ, g.q, p.q_st, q0, p.t);
    load_tile_f32<kThreads>(sO, g.dout, p.do_st, q0, p.t);
    for (int i = threadIdx.x; i < kBlock; i += blockDim.x) {
      const int row = q0 + i;
      sLse[i] = row < p.t ? g.lse[row] : INFINITY;
      sDelta[i] = row < p.t ? g.delta[row] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < kBlock; ++i) {
      const float s = pair_dot(k, sQ, i, half);
      const float dp = pair_dot(v, sO, i, half);
      const float pv = key_valid ? expf(s * p.scale - sLse[i]) : 0.f;
      const float ds = pv * (dp - sDelta[i]);
      const float* qr = sQ + i * kHeadDim + half * kHalf;
      const float* dor = sO + i * kHeadDim + half * kHalf;
#pragma unroll
      for (int d = 0; d < kHalf; ++d) {
        dv[d] = fmaf(pv, dor[d], dv[d]);
        dk[d] = fmaf(ds, qr[d], dk[d]);
      }
    }
  }

  if (!in_range) return;
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    g.a[key * p.a_st + half * kHalf + d] = dk[d] * p.scale;
    g.b[key * p.b_st + half * kHalf + d] = dv[d];
  }
}

template <typename E>
int launch(void (*kernel)(BwdParams<E>), const void* q, const void* k,
           const void* v, const void* dout, const void* lse,
           const void* delta, const void* lengths, void* out_a, void* out_b,
           int batch, int heads, int t, int head_dim,
           const long long* strides, float scale, void* stream) {
  if (head_dim != kHeadDim || batch <= 0 || heads <= 0 || t <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdParams<E> p;
  p.q = static_cast<const E*>(q);
  p.k = static_cast<const E*>(k);
  p.v = static_cast<const E*>(v);
  p.dout = static_cast<const E*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.lengths = static_cast<const int*>(lengths);
  p.out_a = static_cast<E*>(out_a);
  p.out_b = static_cast<E*>(out_b);
  p.heads = heads;
  p.t = t;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_st = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_st = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_st = strides[8];
  p.do_sb = strides[9]; p.do_sh = strides[10]; p.do_st = strides[11];
  p.a_sb = strides[12]; p.a_sh = strides[13]; p.a_st = strides[14];
  p.b_sb = strides[15]; p.b_sh = strides[16]; p.b_st = strides[17];
  p.scale = scale;
  const dim3 grid(batch * heads, (t + kBlock - 1) / kBlock);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point launches on `stream` and returns cudaGetLastError() (0
// on success). Strides are in elements, in the order q, k, v, dO, out_a,
// out_b and within each batch, head, time; lse and delta are contiguous
// (B, H, T) float32; lengths is a device pointer to B int32 values. The dq
// kernels write dq to out_a and ignore out_b (pass null and repeat out_a's
// strides); the dk/dv kernels write dk to out_a and dv to out_b.
#define APTAI_FLASH_BWD_ARGS                                                 \
  const void *q, const void *k, const void *v, const void *dout,             \
      const void *lse, const void *delta, const void *lengths, void *out_a,  \
      void *out_b, int batch, int heads, int t, int head_dim,                \
      long long q_sb, long long q_sh, long long q_st, long long k_sb,        \
      long long k_sh, long long k_st, long long v_sb, long long v_sh,        \
      long long v_st, long long do_sb, long long do_sh, long long do_st,     \
      long long a_sb, long long a_sh, long long a_st, long long b_sb,        \
      long long b_sh, long long b_st, float scale, void *stream
#define APTAI_FLASH_BWD_CALL(E, kernel)                                      \
  const long long strides[18] = {q_sb,  q_sh,  q_st,  k_sb, k_sh, k_st,     \
                                 v_sb,  v_sh,  v_st,  do_sb, do_sh, do_st,  \
                                 a_sb,  a_sh,  a_st,  b_sb, b_sh, b_st};    \
  return launch<E>(kernel, q, k, v, dout, lse, delta, lengths, out_a, out_b, \
                   batch, heads, t, head_dim, strides, scale, stream)

extern "C" int aptai_flash_attn_bwd_dq_bf16(APTAI_FLASH_BWD_ARGS) {
  APTAI_FLASH_BWD_CALL(__nv_bfloat16, flash_bwd_dq_bf16_kernel);
}

extern "C" int aptai_flash_attn_bwd_dkv_bf16(APTAI_FLASH_BWD_ARGS) {
  APTAI_FLASH_BWD_CALL(__nv_bfloat16, flash_bwd_dkv_bf16_kernel);
}

extern "C" int aptai_flash_attn_bwd_dq_f32(APTAI_FLASH_BWD_ARGS) {
  APTAI_FLASH_BWD_CALL(float, flash_bwd_dq_f32_kernel);
}

extern "C" int aptai_flash_attn_bwd_dkv_f32(APTAI_FLASH_BWD_ARGS) {
  APTAI_FLASH_BWD_CALL(float, flash_bwd_dkv_f32_kernel);
}
