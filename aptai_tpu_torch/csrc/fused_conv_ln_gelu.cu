// Fused strided Conv1d + LayerNorm + exact GELU, channels-last, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel aptai_tpu/ops/fused_conv.py:fused_conv_ln_gelu
// (its _kernel and _conv_ln_gelu_tile). Same function, not the same blocks:
//   acc[t, :] = sum_j x[s*t + j, :] @ W[j]    f32 accumulation over the
//                                              inputs' values, + bias
//   y = (acc - mean) * rsqrt(mean((acc - mean)^2) + eps) * ln_w + ln_b
//                                              two-pass statistics over all
//                                              C_out channels, f32 ln_w/ln_b
//   out = 0.5 * y * (1 + erf(y / sqrt(2)))     rounded once to the input type
//
// The conv as one GEMM, out = A . W^T with K = k*C_in: A is the im2col
// matrix (T_out, k*C_in) whose row t is x[s*t .. s*t + k) flattened, and
// the weight is stored (C_out, k, C_in) = (C_out, K). The reduction runs
// over chunks of 64 channels (128-byte rows) of one tap j: A's chunk is
// rows s*t + j of x, W's columns j*C_in + c0 .. + 63. The TPU kernel pads
// L to whole 1024-row cells and slices its output; here rows t >= T_out
// are computed and never stored, and no row at or past an item's L is
// read.
//
// What bounds it on this card: at the serving shape (32 x 10 s, C = 512,
// bf16) layer 1 (T_out 15999, k 3) is 8.05e11 FLOP (0.81 ms at 989
// TFLOP/s) against 1.57 GB of traffic (0.47 ms at 3.35 TB/s): operations
// bound the wide layers. The LayerNorm needs whole output rows, and a
// block's registers hold the f32 accumulators of 64 rows x 512 columns at
// most, so a one-block design re-streams all of W from L2 every 64 rows.
// The bf16 kernel (the serving path):
// - A cluster of two blocks owns 128 whole rows: block r of the pair the
//   columns [r C_out/2, (r+1) C_out/2). A block runs two consumer
//   warpgroups of 64 rows, each a wgmma m64nNk16 with N = C_out/2 from
//   shared memory (128 f32 accumulators a thread at C_out 512), and a
//   producer warpgroup that gives its registers to them (setmaxnreg), one
//   thread of which issues the copies. W is streamed once per 128 rows and
//   half a W per block.
// - The producer keeps a ring of kStages stages filled by TMA; each stage
//   has a full mbarrier (its bytes) and an empty one (the consumer warps'
//   releases). A is read in place through a 3-D tensor map over x (C_in,
//   L, B) that traverses L in steps of s: a box 64 s rows long lands 64
//   rows, tap j of rows t0 .. t0+63 starting at row s t0 + j, zero-filled
//   at and past L. W comes through a 2-D map over (K, C_out). Both land
//   128-byte swizzled, as wgmma reads them.
// - Row statistics: each block sums its half of a row (in-thread, then two
//   quad shuffles; a row lives in one quad of one warp), writes the partial
//   to shared memory and, after a cluster barrier, reads its peer's through
//   distributed shared memory. Both add the two partials in rank order, so
//   both halves use bit-identical statistics. Mean, then the mean of the
//   squared deviations, as the TPU kernel; then the affine, erff GELU
//   and one rounding to bf16. The tile is staged swizzled in the freed ring
//   and written by TMA stores, which skip rows >= T_out. A last cluster
//   barrier keeps each block's shared memory alive while its peer reads.
// On an H100 SXM at 700 W this runs layer 1 at about 490 TFLOP/s, half
// the peak. Multicasting A to both blocks of the pair, or W to two row
// tiles in a cluster of four, cut L2 reads but measured no faster: each
// block's shared memory still takes in 48 KB a chunk (PERF.md §6).

#include <math.h>

#include "tma_cluster.cuh"
#include "wgmma_tiles.cuh"

namespace {

constexpr int kRowsBf16 = 128;        // output rows per block: 2 warpgroups
constexpr int kChunk = 64;            // channels per reduction chunk
constexpr int kStages = 4;            // depth of the TMA ring
constexpr int kClusterSize = 2;       // the two column halves of a row tile
constexpr int kConsumerWarps = 8;
constexpr int kProducerWarp = kConsumerWarps;  // warp 0 of warpgroup 2
constexpr int kThreadsBf16 = (kConsumerWarps + 4) * 32;
// registers a thread after the split. Each SM sub-partition holds one warp
// of each warpgroup, and setmaxnreg only moves registers within the
// block's allocation, 168 a thread at launch (65536 / 384, in steps of 8):
// what the producer gives up must cover what the consumers take, or their
// setmaxnreg.inc waits forever
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kLaunchRegs = 65536 / kThreadsBf16 / 8 * 8;
static_assert(2 * kConsumerRegs + kProducerRegs <= 3 * kLaunchRegs,
              "the consumers would wait for registers the producer keeps");
// a box of 64 rows of A spans 64 s rows of x; TMA boxes span <= 256
constexpr int kMaxStrideBf16 = 4;
static_assert(kStages >= 2, "the ring needs two stages at least");

template <int kCout>
struct Bf16Tiles {
  static constexpr int kCols = kCout / 2;  // this block's output columns
  static constexpr int kABytes = kRowsBf16 * 128;
  static constexpr int kWBytes = kCols * 128;
  static constexpr int kStageBytes = kABytes + kWBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  // ring, full and empty barriers, two passes of row partials, and the
  // slack to a 1024-byte boundary
  static constexpr int kSmemBytes =
      1024 + kRingBytes + 2 * kStages * 8 + 2 * kRowsBf16 * 4;
  static_assert(kRowsBf16 * kCols * 2 <= kRingBytes,
                "the output tile is staged in the ring");
  static_assert(kSmemBytes <= 232448, "more than a block's shared memory");
};

struct Bf16Params {
  CUtensorMap x;    // (C_in, L, B), L in steps of s; box (64, 64 s, 1)
  CUtensorMap w;    // (K, C_out); box (64, C_out / 2)
  CUtensorMap out;  // (C_out, T_out, B); box (64, 64, 1)
  const __nv_bfloat16* bias;  // (C_out,) or null
  const float* ln_w;          // (C_out,)
  const float* ln_b;          // (C_out,)
  int t_out, c_in, taps, stride;
  float eps;
};

__device__ __forceinline__ float gelu_exact(float y) {
  return 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
}

// where a block's ring, barriers and rows are. Each role builds it after
// setmaxnreg: a value live across the split would have to fit in the
// producer's few registers.
template <int kCout>
struct Bf16Block {
  unsigned char* ring;
  uint64_t* full;   // [kStages]
  uint64_t* empty;  // [kStages]
  float* red;       // [2][kRowsBf16]: each pass's row partials
  int half;         // the block's cluster rank: which half of the columns
  int t0, b, n0, chunks_per_tap, num_k;

  __device__ __forceinline__ Bf16Block(unsigned char* raw,
                                       const Bf16Params& p) {
    ring = aligned_smem(raw);
    full = reinterpret_cast<uint64_t*>(ring + Bf16Tiles<kCout>::kRingBytes);
    empty = full + kStages;
    red = reinterpret_cast<float*>(empty + kStages);
    half = static_cast<int>(cluster_ctarank());
    t0 = (blockIdx.x / kClusterSize) * kRowsBf16;
    b = blockIdx.y;
    n0 = half * Bf16Tiles<kCout>::kCols;
    chunks_per_tap = p.c_in / kChunk;
    num_k = p.taps * chunks_per_tap;
  }
};

template <int kCout>
__global__ void __launch_bounds__(kThreadsBf16, 1)
fused_conv_ln_gelu_bf16_kernel(const __grid_constant__ Bf16Params p) {
  using T = Bf16Tiles<kCout>;
  constexpr int kCols = T::kCols;
  constexpr int kNT = kCols / 8;  // n-tiles of 8 columns in a thread's rows
  extern __shared__ unsigned char smem_raw[];

  if (threadIdx.x == 0) {
    const Bf16Block<kCout> blk(smem_raw, p);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&blk.full[s], 1);
      mbar_init(&blk.empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  // the barriers are local; the peer's shared memory is first read after
  // the epilogue's first cluster barrier
  __syncthreads();

  if (threadIdx.x / 32 >= kProducerWarp) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kProducerWarp * 32) {
      const Bf16Block<kCout> blk(smem_raw, p);
      unsigned char* ring = blk.ring;
      uint64_t* full = blk.full;
      uint64_t* empty = blk.empty;
      const int t0 = blk.t0, b = blk.b, n0 = blk.n0;
      const int chunks_per_tap = blk.chunks_per_tap;
      tma_prefetch_map(&p.x);
      tma_prefetch_map(&p.w);
      for (int it = 0; it < blk.num_k; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        unsigned char* a = ring + s * T::kStageBytes;
        unsigned char* w = a + T::kABytes;
        mbar_arrive_expect_tx(&full[s], T::kStageBytes);
        const int j = it / chunks_per_tap;
        const int c0 = (it % chunks_per_tap) * kChunk;
        tma_load_3d(a, &p.x, &full[s], c0, p.stride * t0 + j, b);
        tma_load_3d(a + 64 * 128, &p.x, &full[s], c0,
                    p.stride * (t0 + 64) + j, b);
        tma_load_2d(w, &p.w, &full[s], j * p.c_in + c0, n0);
      }
    }
    __syncwarp();
    // the consumers' three cluster barriers (two statistics, the end)
    cluster_sync();
    cluster_sync();
    cluster_sync();
    return;
  }

  // -- consumers: warpgroup wg owns rows t0 + 64 wg .. + 63 ------------------
  setmaxnreg_inc<kConsumerRegs>();
  const Bf16Block<kCout> blk(smem_raw, p);
  unsigned char* ring = blk.ring;
  uint64_t* full = blk.full;
  uint64_t* empty = blk.empty;
  const int half = blk.half, t0 = blk.t0, b = blk.b, n0 = blk.n0;
  const int num_k = blk.num_k;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  float acc[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < num_k; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const unsigned char* a = ring + s * T::kStageBytes + wg * 64 * 128;
    const uint64_t da = smem_desc(a);
    const uint64_t dw = smem_desc(a - wg * 64 * 128 + T::kABytes);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      wgmma_ss<kCols>(acc, da + 2 * kk, dw + 2 * kk, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // this chunk's products stay in flight; the previous chunk's are done
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_regs(acc);
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs(acc);

  // acc[4 j + 2 h + e]: row r_loc + 8 h of the warpgroup, column
  // n0 + 8 j + 2 t4 + e (the wgmma accumulator layout)
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int r_loc = (warp % 4) * 16 + g;
  const int row = wg * 64 + r_loc;  // in the block's 128
  if (p.bias != nullptr) {  // rounded to bf16 by the caller, added in f32
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = n0 + 8 * j + 2 * t4;
      const float b0 = __bfloat162float(p.bias[col]);
      const float b1 = __bfloat162float(p.bias[col + 1]);
      acc[4 * j] += b0;
      acc[4 * j + 1] += b1;
      acc[4 * j + 2] += b0;
      acc[4 * j + 3] += b1;
    }
  }

  const uint32_t peer = static_cast<uint32_t>(half ^ 1);
  float mean[2], rstd[2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float* part = blk.red + pass * kRowsBf16;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float v0 = acc[4 * j + 2 * h];
        const float v1 = acc[4 * j + 2 * h + 1];
        if (pass == 0) {
          s += v0 + v1;
        } else {
          const float d0 = v0 - mean[h], d1 = v1 - mean[h];
          s += d0 * d0 + d1 * d1;
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t4 == 0) part[row + 8 * h] = s;
    }
    cluster_sync();  // both halves' partials are written
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mine = part[row + 8 * h];
      const float theirs = ld_cluster_f32(map_to_rank(&part[row + 8 * h],
                                                      peer));
      const float total = half == 0 ? mine + theirs : theirs + mine;
      if (pass == 0) {
        mean[h] = total / kCout;
      } else {
        rstd[h] = rsqrtf(total / kCout + p.eps);
      }
    }
  }

  // normalise, GELU, round; stage the warpgroup's 64 rows as kCols / 64
  // swizzled sub-tiles of 64 columns in the freed ring, then TMA them out
  unsigned char* tile = ring + wg * (kCols / 64) * 8192;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = n0 + 8 * j + 2 * t4;
    const float w0 = p.ln_w[col], w1 = p.ln_w[col + 1];
    const float c0 = p.ln_b[col], c1 = p.ln_b[col + 1];
    unsigned char* sub = tile + (j / 8) * 8192;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_loc + 8 * h;
      const float y0 = (acc[4 * j + 2 * h] - mean[h]) * rstd[h] * w0 + c0;
      const float y1 = (acc[4 * j + 2 * h + 1] - mean[h]) * rstd[h] * w1 + c1;
      *reinterpret_cast<uint32_t*>(sub + r * 128 + (((j % 8) ^ (r & 7)) << 4) +
                                   4 * t4) =
          pack_bf16(gelu_exact(y0), gelu_exact(y1));
    }
  }
  fence_proxy_async();  // the staged tile, visible to the TMA stores
  named_barrier_sync(1 + wg, 128);
  if (threadIdx.x % 128 == 0 && t0 + 64 * wg < p.t_out) {
#pragma unroll
    for (int c = 0; c < kCols / 64; ++c) {
      tma_store_3d(&p.out, tile + c * 8192, n0 + 64 * c, t0 + 64 * wg, b);
    }
    tma_store_commit_and_wait_read();
  }
  cluster_sync();  // the peer has read this block's partials
}

// The float32 variant, for models run in float32 (the bf16 kernel above is
// the serving path): scalar FMAs in full precision, no TF32. One block of
// C_out / 2 threads owns 16 output rows x all C_out columns, each thread two
// columns (tid and tid + C_out/2) of all 16 rows; operand tiles of 16
// reduction steps are staged in shared memory and read as broadcasts (A) and
// at a pitch of 17 words (W, conflict-free).
constexpr int kRowsF32 = 16;
constexpr int kChunkF32 = 16;

struct Params {
  const void* x;       // (B, L, C_in) contiguous
  const void* w;       // (C_out, k, C_in) contiguous
  const void* bias;    // (C_out,) float32, or null
  const float* ln_w;   // (C_out,)
  const float* ln_b;   // (C_out,)
  void* out;           // (B, T_out, C_out) contiguous
  int length, t_out, c_in, taps, stride;
  float eps;
};

template <int kCout>
__global__ void __launch_bounds__(kCout / 2)
fused_conv_ln_gelu_f32_kernel(const Params p) {
  constexpr int kThreads = kCout / 2;
  constexpr int kWarps = kThreads / 32;
  __shared__ float sa[kRowsF32][kChunkF32];
  __shared__ float sw[kCout][kChunkF32 + 1];
  __shared__ float red[kWarps][kRowsF32];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRowsF32;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int k_total = p.taps * p.c_in;
  const float* xb = static_cast<const float*>(p.x) +
                    static_cast<long long>(b) * p.length * p.c_in;
  const float* w = static_cast<const float*>(p.w);

  float acc[kRowsF32][2];
#pragma unroll
  for (int r = 0; r < kRowsF32; ++r) acc[r][0] = acc[r][1] = 0.f;

  for (int k0 = 0; k0 < k_total; k0 += kChunkF32) {
    for (int i = tid; i < kRowsF32 * kChunkF32; i += kThreads) {
      const int r = i / kChunkF32, c = i % kChunkF32;
      const int t = t0 + r;
      sa[r][c] = t < p.t_out
                     ? xb[static_cast<long long>(t) * p.stride * p.c_in + k0 + c]
                     : 0.f;
    }
    for (int i = tid; i < kCout * kChunkF32; i += kThreads) {
      const int n = i / kChunkF32, c = i % kChunkF32;
      sw[n][c] = w[static_cast<long long>(n) * k_total + k0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kChunkF32; ++c) {
      const float w0 = sw[tid][c];
      const float w1 = sw[tid + kThreads][c];
#pragma unroll
      for (int r = 0; r < kRowsF32; ++r) {
        acc[r][0] = fmaf(sa[r][c], w0, acc[r][0]);
        acc[r][1] = fmaf(sa[r][c], w1, acc[r][1]);
      }
    }
    __syncthreads();
  }

  const int n0 = tid, n1 = tid + kThreads;
  if (p.bias != nullptr) {
    const float* bias = static_cast<const float*>(p.bias);
    const float b0 = bias[n0], b1 = bias[n1];
#pragma unroll
    for (int r = 0; r < kRowsF32; ++r) {
      acc[r][0] += b0;
      acc[r][1] += b1;
    }
  }

  float mean[kRowsF32], rstd[kRowsF32];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int r = 0; r < kRowsF32; ++r) {
      float s;
      if (pass == 0) {
        s = acc[r][0] + acc[r][1];
      } else {
        const float d0 = acc[r][0] - mean[r], d1 = acc[r][1] - mean[r];
        s = d0 * d0 + d1 * d1;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      if (lane == 0) red[warp][r] = s;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsF32; ++r) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) s += red[wi][r];
      if (pass == 0) {
        mean[r] = s / kCout;
      } else {
        rstd[r] = rsqrtf(s / kCout + p.eps);
      }
    }
    __syncthreads();
  }

  float* ob = static_cast<float*>(p.out) +
              (static_cast<long long>(b) * p.t_out + t0) * kCout;
  const float w0 = p.ln_w[n0], w1 = p.ln_w[n1];
  const float c0 = p.ln_b[n0], c1 = p.ln_b[n1];
#pragma unroll
  for (int r = 0; r < kRowsF32; ++r) {
    if (t0 + r >= p.t_out) break;
    ob[r * kCout + n0] = gelu_exact((acc[r][0] - mean[r]) * rstd[r] * w0 + c0);
    ob[r * kCout + n1] = gelu_exact((acc[r][1] - mean[r]) * rstd[r] * w1 + c1);
  }
}

template <int kCout>
int launch_bf16(const void* x, const void* w, const void* bias,
                const void* ln_w, const void* ln_b, void* out, int batch,
                int length, int c_in, int taps, int stride, int t_out,
                float eps, cudaStream_t stream) {
  using T = Bf16Tiles<kCout>;
  Bf16Params p;
  const cuuint64_t k_total = static_cast<cuuint64_t>(taps) * c_in;
  const cuuint64_t x_dims[3] = {static_cast<cuuint64_t>(c_in),
                                static_cast<cuuint64_t>(length),
                                static_cast<cuuint64_t>(batch)};
  const cuuint64_t x_strides[2] = {2ull * c_in, 2ull * length * c_in};
  const cuuint32_t x_box[3] = {kChunk, 64u * stride, 1};
  const cuuint32_t x_step[3] = {1, static_cast<cuuint32_t>(stride), 1};
  const cuuint64_t w_dims[2] = {k_total, kCout};
  const cuuint64_t w_strides[1] = {2 * k_total};
  const cuuint32_t w_box[2] = {kChunk, T::kCols};
  const cuuint64_t o_dims[3] = {kCout, static_cast<cuuint64_t>(t_out),
                                static_cast<cuuint64_t>(batch)};
  const cuuint64_t o_strides[2] = {2ull * kCout, 2ull * kCout * t_out};
  const cuuint32_t o_box[3] = {64, 64, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  if (!encode_bf16_map(&p.x, x, 3, x_dims, x_strides, x_box, x_step) ||
      !encode_bf16_map(&p.w, w, 2, w_dims, w_strides, w_box, ones) ||
      !encode_bf16_map(&p.out, out, 3, o_dims, o_strides, o_box, ones)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.ln_w = static_cast<const float*>(ln_w);
  p.ln_b = static_cast<const float*>(ln_b);
  p.t_out = t_out;
  p.c_in = c_in;
  p.taps = taps;
  p.stride = stride;
  p.eps = eps;

  auto kernel = fused_conv_ln_gelu_bf16_kernel<kCout>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (t_out + kRowsBf16 - 1) / kRowsBf16;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterSize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * kClusterSize, batch, 1);
  cfg.blockDim = dim3(kThreadsBf16, 1, 1);
  cfg.dynamicSmemBytes = T::kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int kCout>
int launch_f32(const Params& p, int batch, cudaStream_t stream) {
  const dim3 grid((p.t_out + kRowsF32 - 1) / kRowsF32, batch);
  fused_conv_ln_gelu_f32_kernel<kCout><<<grid, kCout / 2, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int batch, int length, int c_in, int taps, int stride,
                 int t_out, int chunk) {
  return batch > 0 && taps > 0 && stride > 0 && c_in > 0 &&
         c_in % chunk == 0 && length >= taps &&
         t_out == (length - taps) / stride + 1;
}

}  // namespace

// Both entry points launch on `stream` and return a CUDA error code (0 on
// success). x (B, L, C_in), w (C_out, taps, C_in), out (B, T_out, C_out) are
// contiguous device buffers of the entry point's type with 16-byte aligned
// starts; bias (C_out,) of the same type or null; ln_w, ln_b (C_out,) float32.
// C_out must be 128, 256 or 512; C_in a multiple of 64 (bf16) or 16 (f32);
// the bf16 kernel takes strides 1 to 4.
#define APTAI_FUSED_CONV_ARGS                                               \
  const void *x, const void *w, const void *bias, const void *ln_w,         \
      const void *ln_b, void *out, int batch, int length, int c_in,         \
      int c_out, int taps, int stride, int t_out, float eps, void *stream

extern "C" int aptai_fused_conv_ln_gelu_bf16(APTAI_FUSED_CONV_ARGS) {
  const auto misaligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 != 0;
  };
  if (!valid_shape(batch, length, c_in, taps, stride, t_out, kChunk) ||
      stride > kMaxStrideBf16 || misaligned(x) || misaligned(w) ||
      misaligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define APTAI_LAUNCH_BF16(N)                                                 \
  launch_bf16<N>(x, w, bias, ln_w, ln_b, out, batch, length, c_in, taps,     \
                 stride, t_out, eps, s)
  switch (c_out) {
    case 128: return APTAI_LAUNCH_BF16(128);
    case 256: return APTAI_LAUNCH_BF16(256);
    case 512: return APTAI_LAUNCH_BF16(512);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef APTAI_LAUNCH_BF16
}

extern "C" int aptai_fused_conv_ln_gelu_f32(APTAI_FUSED_CONV_ARGS) {
  if (!valid_shape(batch, length, c_in, taps, stride, t_out, kChunkF32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = x;
  p.w = w;
  p.bias = bias;
  p.ln_w = static_cast<const float*>(ln_w);
  p.ln_b = static_cast<const float*>(ln_b);
  p.out = out;
  p.length = length;
  p.t_out = t_out;
  p.c_in = c_in;
  p.taps = taps;
  p.stride = stride;
  p.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c_out) {
    case 128: return launch_f32<128>(p, batch, s);
    case 256: return launch_f32<256>(p, batch, s);
    case 512: return launch_f32<512>(p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
