// Flash-attention backward with per-item key lengths, for Hopper (sm_90a).
//
// Replaces the TPU kernels aptai_tpu/ops/attention.py:_flash_bwd_dq_kernel
// and _flash_bwd_dkv_kernel (both launched by _bwd_call). Same functions,
// not the same blocks. From the forward's inputs q, k, v, its output o, its
// per-row logsumexp lse and the output gradient dO:
//   delta = rowsum(dO * o)        f32, computed by the dq kernel (the TPU
//                                 version computes it outside its kernels)
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
// taken by one block in one fixed order and two launches on the same
// inputs give bit-identical outputs:
//   dq kernel:    one block of 4 warps (a warpgroup) per (b*h, 64-query
//                 tile): delta for its rows from o and dO, written out as
//                 (B, H, T) f32, then a loop over the 64-key tiles below
//                 length[b];
//   dk/dv kernel: one block per (b*h, 64-key tile), run after the dq kernel
//                 on the same stream, looping over every 64-query tile (all
//                 T rows, pad rows included) and reading delta; a key tile
//                 wholly past length[b] writes zeros and returns.
//
// Layout: q, k, v, o, dO and the outputs are (B, H, T, 64) with any batch /
// head / time strides (multiples of 8 elements) and a contiguous head
// dimension; lse and delta are contiguous (B, H, T) float32.
//
// What bounds them on this card: at the training shape (B=8, H=16, T=249,
// D=64, bf16, every frame valid) the dq kernel does 6*B*H*T^2*D = 3.0e9
// FLOP (3 us at 989 TFLOP/s) and moves q, k, v, o, dO, dq, lse, delta =
// 24.7 MB (7.4 us at 3.35 TB/s); the dk/dv kernel does 8*B*H*T^2*D = 4.1e9
// FLOP (4 us) and moves 24.7 MB (7.4 us). Both are bound by bytes, and a
// block's loop is short (4 tiles at T = 249), so what decides their time is
// how much of each block's chain (copies in, products, exp, products) the
// other blocks on its SM hide. The design:
//   - every tile reaches shared memory by cp.async (16-byte copies that
//     skip the registers; lse and delta by 4-byte ones): the block's own
//     tiles and the first looped tile in one group, then a two-stage ring in
//     which tile i + 1 is in flight while tile i is multiplied. cp.async
//     rather than TMA: a tile is 64 rows of 128 bytes at a caller's
//     strides, which per-thread copies handle with a zero-filled ragged
//     edge and no tensor map to encode on the host per launch;
//   - tiles are stored with the 128-byte swizzle (16-byte chunk c of row r
//     at chunk c ^ (r % 8)), which wgmma reads natively, K-major and
//     transposed, and which keeps the ldmatrix reads of dO and o (for
//     delta) free of bank conflicts;
//   - every product is a wgmma of the block's one warpgroup: s = q . k^T
//     and dp = dO . v^T (s^T and dp^T in dk/dv) with both operands in
//     shared memory, m64n32k16, 32 columns at a time so the accumulators
//     stay small; ds . k, p^T . dO and ds^T . q with p^T, ds or ds^T as the
//     A operand straight from registers (their accumulator layout is the A
//     fragment layout) and the B tile read transposed, m64n64k16. The same
//     kernels with mma.sync m16n8k16 and ldmatrix.trans B fragments for
//     those three products measured 14 % slower at the training shape;
//   - 128 threads, at most 128 registers and ~50 KB of shared memory a
//     block, so 4 blocks fit on an SM and the 512 blocks of the training
//     shape run in one wave on 132 SMs. Blocks of two warpgroups sharing
//     each looped tile (half the reads from L2) measured no faster;
//   - outputs are staged in shared memory and written in 16-byte pieces.

#include <math.h>

#include "wgmma_tiles.cuh"

namespace {

constexpr int kBlock = 64;  // rows of the block's own tile: 4 warps x 16
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSub = 32;  // columns of s / dp per wgmma
constexpr int kTileBytes = kBlock * kHeadDim * 2;  // a swizzled bf16 tile
// six tiles, and slack to align the first to the 1024-byte swizzle period
constexpr int kSmemBf16 = 6 * kTileBytes + 1024;

template <typename E>
struct BwdParams {
  const E* q;
  const E* k;
  const E* v;
  const E* dout;
  const E* o;          // the forward's output (dq kernel), else null
  const float* lse;    // (B, H, T) contiguous
  float* delta;        // (B, H, T) contiguous: dq writes, dk/dv reads
  const int* lengths;  // (B,)
  E* out_a;            // dq (dq kernel) or dk (dk/dv kernel)
  E* out_b;            // dv (dk/dv kernel)
  int heads, t;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long do_sb, do_sh, do_st;
  long long o_sb, o_sh, o_st;
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
  const E* o;
  E* a;
  E* b;
  const float* lse;
  float* delta;
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
  s.o = p.o == nullptr ? nullptr : p.o + b * p.o_sb + h * p.o_sh;
  s.a = p.out_a + b * p.a_sb + h * p.a_sh;
  s.b = p.out_b == nullptr ? nullptr : p.out_b + b * p.b_sb + h * p.b_sh;
  s.lse = p.lse + static_cast<long long>(bh) * p.t;
  s.delta = p.delta + static_cast<long long>(bh) * p.t;
  s.len = min(max(p.lengths[b], 0), p.t);
  return s;
}

// ---------------------------------------------------------------- bf16 ----

// s = a_tile . b_tile[b0 : b0 + 32]^T and t = c_tile . d_tile[b0 : b0 +
// 32]^T over the 64 head columns, as one wgmma group. Each warp gets its 16
// rows: register 4j + i holds (row lane/4 + 8 (i / 2), column 8j + 2
// (lane % 4) + i % 2), the mma.sync accumulator layout of 4 n-tiles.
__device__ __forceinline__ void wg_two_products(
    float (&s)[16], float (&t)[16], const unsigned char* a_tile,
    const unsigned char* b_tile, const unsigned char* c_tile,
    const unsigned char* d_tile, int b0) {
  const uint64_t da = smem_desc(a_tile);
  const uint64_t db = smem_desc(b_tile + b0 * 128);
  const uint64_t dc = smem_desc(c_tile);
  const uint64_t dd = smem_desc(d_tile + b0 * 128);
  fence_regs(s);
  fence_regs(t);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kHeadDim / 16; ++ks) {
    wgmma_m64n32k16(s, da + 2 * ks, db + 2 * ks, ks > 0);
  }
#pragma unroll
  for (int ks = 0; ks < kHeadDim / 16; ++ks) {
    wgmma_m64n32k16(t, dc + 2 * ks, dd + 2 * ks, ks > 0);
  }
  wgmma_commit_and_wait();
  fence_regs(s);
  fence_regs(t);
}

__global__ void __launch_bounds__(kThreads, 4)
flash_bwd_dq_bf16_kernel(const BwdParams<__nv_bfloat16> p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = aligned_smem(smem_raw);
  unsigned char* const sQ = smem;
  unsigned char* const sDO = smem + kTileBytes;
  // ring stage st: its K tile at sKV + 2 st tiles, its V tile after it
  unsigned char* const sKV = smem + 2 * kTileBytes;
  unsigned char* const sO = sKV + 2 * kTileBytes;  // stage 1's K, at first

  const Slices<__nv_bfloat16> g = slices(p);
  const int q0 = blockIdx.y * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int qr = warp * 16 + lane / 4;  // rows qr and qr + 8 of the tile
  const int num_k_tiles = (g.len + kBlock - 1) / kBlock;

  // one group: the block's own q, dO and o tiles and the first K/V tile
  copy_tile_async(sQ, g.q, p.q_st, q0, p.t);
  copy_tile_async(sDO, g.dout, p.do_st, q0, p.t);
  copy_tile_async(sO, g.o, p.o_st, q0, p.t);
  if (num_k_tiles > 0) {
    copy_tile_async(sKV, g.k, p.k_st, 0, p.t);
    copy_tile_async(sKV + kTileBytes, g.v, p.v_st, 0, p.t);
  }
  cp_async_commit();
  float lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + r * 8;
    lse[r] = row < p.t ? g.lse[row] : INFINITY;  // past T: p = 0, ds = 0
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // delta = rowsum(dO * o) in f32 for this thread's rows qr and qr + 8: the
  // warp's 16 rows of dO and of o as ldmatrix fragments (the same positions
  // in both), products summed along the row in each lane and then over the
  // quad of lanes that shares the row
  float delta[2] = {0.f, 0.f};
  {
    const int m = lane / 8;  // the matrix this lane addresses
    const int row = warp * 16 + (m & 1) * 8 + lane % 8;
#pragma unroll
    for (int c = 0; c < kHeadDim / 8; c += 2) {  // 16 columns a step
      uint32_t df[4], of[4];  // matrices: rows +0 / +8 x chunks c / c + 1
      ldmatrix_x4(df, sDO + swz(row, c + (m >> 1)));
      ldmatrix_x4(of, sO + swz(row, c + (m >> 1)));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 d2 =
            __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&df[j]));
        const float2 o2 =
            __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&of[j]));
        delta[j & 1] = fmaf(d2.x, o2.x, delta[j & 1]);
        delta[j & 1] = fmaf(d2.y, o2.y, delta[j & 1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
      const int row_t = q0 + qr + r * 8;
      if (t4 == 0 && row_t < p.t) g.delta[row_t] = delta[r];
    }
  }
  __syncthreads();  // every warp is done with o: stage 1 of the ring is free

  float dq[kHeadDim / 8][4];
  zero_acc(dq);

  for (int kt = 0; kt < num_k_tiles; ++kt) {
    const int k0 = kt * kBlock;
    if (kt + 1 < num_k_tiles) {  // into the stage of tile kt - 1
      unsigned char* next = sKV + ((kt + 1) % 2) * 2 * kTileBytes;
      copy_tile_async(next, g.k, p.k_st, k0 + kBlock, p.t);
      copy_tile_async(next + kTileBytes, g.v, p.v_st, k0 + kBlock, p.t);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile kt has landed
    fence_proxy_async();
    __syncthreads();
    const unsigned char* sK = sKV + (kt % 2) * 2 * kTileBytes;
    const unsigned char* sV = sK + kTileBytes;

#pragma unroll
    for (int half = 0; half < kBlock / kSub; ++half) {
      const int c0 = k0 + half * kSub;
      if (c0 >= g.len) break;
      float s[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
      wg_two_products(s, dp, sQ, sK, sDO, sV, half * kSub);

      // ds = p * (dp - delta) in bf16, as the A fragments of ds . k
      uint32_t da[kSub / 16][4];
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n) {
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = c0 + n * 8 + 2 * t4 + (i & 1);
          const float pv = col < g.len
                               ? __expf(s[4 * n + i] * p.scale - lse[i / 2])
                               : 0.f;
          ds[i] = pv * (dp[4 * n + i] - delta[i / 2]);
        }
        da[n / 2][(n % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
        da[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      wg_rows(dq, da, sK, half * kSub);  // dq += ds . k
    }
    wg_wait(dq);      // the products have read stage kt % 2 ...
    __syncthreads();  // ... in every warp
  }

  // sQ is free (the last barrier, or no product at all): stage dq in it
  stage_rows(sQ, dq, p.scale);
  __syncthreads();
  store_tile(g.a, p.a_st, sQ, q0, p.t);
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

// query tile q0's q, dO, lse and delta into a ring stage (4-byte copies for
// the statistics: a (B, H, T) row need not start on 16 bytes). The slices
// are recomputed from the parameters, so that no pointer stays in a
// register across the loop.
__device__ __forceinline__ void copy_query_stage(
    unsigned char* tiles, float* stats, const BwdParams<__nv_bfloat16>& p,
    int q0) {
  const Slices<__nv_bfloat16> g = slices(p);
  copy_tile_async(tiles, g.q, p.q_st, q0, p.t);
  copy_tile_async(tiles + kTileBytes, g.dout, p.do_st, q0, p.t);
  const int i = threadIdx.x % kBlock;
  const bool valid = q0 + i < p.t;  // past T: 0, and q = dO = 0 there
  const float* src = threadIdx.x < kBlock ? g.lse : g.delta;
  cp_async4(stats + threadIdx.x, valid ? src + q0 + i : src, valid);
}

__global__ void __launch_bounds__(kThreads, 4)
flash_bwd_dkv_bf16_kernel(const BwdParams<__nv_bfloat16> p) {
  static_assert(kThreads == 2 * kBlock, "one statistic copy per thread");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = aligned_smem(smem_raw);
  unsigned char* const sK = smem;
  unsigned char* const sV = smem + kTileBytes;
  // ring stage st: its q tile at sQO + 2 st tiles, its dO tile after it
  unsigned char* const sQO = smem + 2 * kTileBytes;
  __shared__ __align__(16) float sStats[2][2 * kBlock];  // lse, then delta

  const int k0 = blockIdx.y * kBlock;
  bool key_valid[2];
  {
    const Slices<__nv_bfloat16> g = slices(p);
    if (k0 >= g.len) {  // every key of the tile is masked
      zero_rows(g.a, p.a_st, k0, p.t);
      zero_rows(g.b, p.b_st, k0, p.t);
      return;
    }
    // keys kr and kr + 8 of the tile
    const int kr = (threadIdx.x / 32) * 16 + (threadIdx.x % 32) / 4;
    key_valid[0] = k0 + kr < g.len;
    key_valid[1] = k0 + kr + 8 < g.len;
    // one group: the block's own K and V tiles and the first query tile
    copy_tile_async(sK, g.k, p.k_st, k0, p.t);
    copy_tile_async(sV, g.v, p.v_st, k0, p.t);
  }
  copy_query_stage(sQO, sStats[0], p, 0);
  cp_async_commit();
  const int t4 = threadIdx.x % 4;
  const int num_q_tiles = (p.t + kBlock - 1) / kBlock;

  float dk[kHeadDim / 8][4], dv[kHeadDim / 8][4];
  zero_acc(dk);
  zero_acc(dv);

  for (int qt = 0; qt < num_q_tiles; ++qt) {
    const int q0 = qt * kBlock;
    if (qt + 1 < num_q_tiles) {  // into the stage of tile qt - 1
      copy_query_stage(sQO + ((qt + 1) % 2) * 2 * kTileBytes,
                       sStats[(qt + 1) % 2], p, q0 + kBlock);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile qt has landed
    fence_proxy_async();
    __syncthreads();
    const unsigned char* sQ = sQO + (qt % 2) * 2 * kTileBytes;
    const unsigned char* sDO = sQ + kTileBytes;
    const float* lse = sStats[qt % 2];
    const float* delta = lse + kBlock;

    // one half at a time: unrolled, the two halves' live values spill
#pragma unroll 1
    for (int half = 0; half < kBlock / kSub; ++half) {
      if (q0 + half * kSub >= p.t) break;
      // transposed scores: s^T = k . q^T and dp^T = v . dO^T, 64 keys x
      // 32 queries over the warpgroup
      float s[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
      wg_two_products(s, dp, sK, sQ, sV, sDO, half * kSub);

      // p^T in f32 in place of s^T, and in bf16 as the A fragments of
      // dv += p^T . dO (issued, running while ds^T is computed); then ds^T
      // for dk += ds^T . q
      uint32_t pa[kSub / 16][4];
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = half * kSub + n * 8 + 2 * t4 + (i & 1);
          s[4 * n + i] = key_valid[i / 2]
                             ? __expf(s[4 * n + i] * p.scale - lse[qc])
                             : 0.f;
        }
        pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(s[4 * n], s[4 * n + 1]);
        pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(s[4 * n + 2], s[4 * n + 3]);
      }
      wg_rows(dv, pa, sDO, half * kSub);
      uint32_t da[kSub / 16][4];
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n) {
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = half * kSub + n * 8 + 2 * t4 + (i & 1);
          ds[i] = s[4 * n + i] * (dp[4 * n + i] - delta[qc]);
        }
        da[n / 2][(n % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
        da[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      wg_rows(dk, da, sQ, half * kSub);
    }
    wg_wait(dk);      // the products have read stage qt % 2 ...
    fence_acc(dv);
    __syncthreads();  // ... in every warp
  }

  // the K and V tiles are free: stage dk and dv in them
  stage_rows(sK, dk, p.scale);
  stage_rows(sV, dv, 1.f);
  __syncthreads();
  const Slices<__nv_bfloat16> g = slices(p);
  store_tile(g.a, p.a_st, sK, k0, p.t);
  store_tile(g.b, p.b_st, sV, k0, p.t);
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
  float dsum = 0.f;  // this half's share of rowsum(dO * o)
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    const int col = half * kHalf + d;
    q[d] = in_range ? g.q[row * p.q_st + col] : 0.f;
    dout[d] = in_range ? g.dout[row * p.do_st + col] : 0.f;
    const float o = in_range ? g.o[row * p.o_st + col] : 0.f;
    dsum = fmaf(dout[d], o, dsum);
    dq[d] = 0.f;
  }
  const float delta = dsum + __shfl_xor_sync(0xffffffffu, dsum, 1);
  if (in_range && half == 0) g.delta[row] = delta;
  const float lse = in_range ? g.lse[row] : INFINITY;

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
int launch(void (*kernel)(BwdParams<E>), int smem_bytes, const void* q,
           const void* k, const void* v, const void* dout, const void* o,
           const void* lse, void* delta, const void* lengths, void* out_a,
           void* out_b, int batch, int heads, int t, int head_dim,
           const long long* strides, float scale, void* stream) {
  if (head_dim != kHeadDim || batch <= 0 || heads <= 0 || t <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdParams<E> p;
  p.q = static_cast<const E*>(q);
  p.k = static_cast<const E*>(k);
  p.v = static_cast<const E*>(v);
  p.dout = static_cast<const E*>(dout);
  p.o = static_cast<const E*>(o);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.lengths = static_cast<const int*>(lengths);
  p.out_a = static_cast<E*>(out_a);
  p.out_b = static_cast<E*>(out_b);
  p.heads = heads;
  p.t = t;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_st = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_st = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_st = strides[8];
  p.do_sb = strides[9]; p.do_sh = strides[10]; p.do_st = strides[11];
  p.o_sb = strides[12]; p.o_sh = strides[13]; p.o_st = strides[14];
  p.a_sb = strides[15]; p.a_sh = strides[16]; p.a_st = strides[17];
  p.b_sb = strides[18]; p.b_sh = strides[19]; p.b_st = strides[20];
  p.scale = scale;
  if (smem_bytes > 0) {  // above the 48 KB default; as much L1 as smem
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(batch * heads, (t + kBlock - 1) / kBlock);
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point launches on `stream` and returns cudaGetLastError() (0
// on success). Strides are in elements, in the order q, k, v, dO, o, out_a,
// out_b and within each batch, head, time; lse and delta are contiguous
// (B, H, T) float32; lengths is a device pointer to B int32 values. The dq
// kernels read o, write delta and dq (to out_a), and ignore out_b (pass
// null and repeat out_a's strides); the dk/dv kernels ignore o (pass null
// and repeat q's strides), read delta and write dk to out_a and dv to
// out_b. Run the dk/dv kernel after the dq kernel on the same stream.
#define APTAI_FLASH_BWD_ARGS                                                 \
  const void *q, const void *k, const void *v, const void *dout,             \
      const void *o, const void *lse, void *delta, const void *lengths,      \
      void *out_a, void *out_b, int batch, int heads, int t, int head_dim,   \
      long long q_sb, long long q_sh, long long q_st, long long k_sb,        \
      long long k_sh, long long k_st, long long v_sb, long long v_sh,        \
      long long v_st, long long do_sb, long long do_sh, long long do_st,     \
      long long o_sb, long long o_sh, long long o_st, long long a_sb,        \
      long long a_sh, long long a_st, long long b_sb, long long b_sh,        \
      long long b_st, float scale, void *stream
#define APTAI_FLASH_BWD_CALL(E, kernel, smem)                                \
  const long long strides[21] = {q_sb,  q_sh,  q_st,  k_sb, k_sh, k_st,     \
                                 v_sb,  v_sh,  v_st,  do_sb, do_sh, do_st,  \
                                 o_sb,  o_sh,  o_st,  a_sb, a_sh, a_st,     \
                                 b_sb,  b_sh,  b_st};                       \
  return launch<E>(kernel, smem, q, k, v, dout, o, lse, delta, lengths,      \
                   out_a, out_b, batch, heads, t, head_dim, strides, scale,  \
                   stream)

extern "C" int aptai_flash_attn_bwd_dq_bf16(APTAI_FLASH_BWD_ARGS) {
  APTAI_FLASH_BWD_CALL(__nv_bfloat16, flash_bwd_dq_bf16_kernel, kSmemBf16);
}

extern "C" int aptai_flash_attn_bwd_dkv_bf16(APTAI_FLASH_BWD_ARGS) {
  APTAI_FLASH_BWD_CALL(__nv_bfloat16, flash_bwd_dkv_bf16_kernel, kSmemBf16);
}

extern "C" int aptai_flash_attn_bwd_dq_f32(APTAI_FLASH_BWD_ARGS) {
  APTAI_FLASH_BWD_CALL(float, flash_bwd_dq_f32_kernel, 0);
}

extern "C" int aptai_flash_attn_bwd_dkv_f32(APTAI_FLASH_BWD_ARGS) {
  APTAI_FLASH_BWD_CALL(float, flash_bwd_dkv_f32_kernel, 0);
}
