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
// The conv as one GEMM. With x item-contiguous (L, C_in), the k taps of
// output row t are the flat range x[s*t*C_in, (s*t + k)*C_in): an im2col
// matrix A (T_out, k*C_in) whose rows overlap, read in place with row stride
// s*C_in. The weight is stored (C_out, k, C_in) = (C_out, K), which is the
// "col" B operand of mma.sync row.col, so out = A . W^T with K = k*C_in.
// The TPU kernel pads L to whole 1024-row cells and slices its output; here
// every block bounds-checks: rows t >= T_out are zero-filled on load and
// never stored, and no row at or past L is read.
//
// What bounds it on this card: at the serving shape (32 x 10 s, C = 512,
// bf16) layer 1 (T_out 15999, k 3) is 8.05e11 FLOP (0.81 ms at 989
// TFLOP/s) against 1.57 GB of traffic (0.47 ms at 3.35 TB/s): operations
// bound the wide layers. The LayerNorm needs whole output rows, so one block
// owns 64 rows x all C_out columns: 8 warps as 2 (rows) x 4 (columns), each
// 32 rows x C_out/4 columns of f32 accumulators (128 a thread at C_out 512).
// Row statistics cross the 4 column warps through shared memory. Operand
// tiles of 32 reduction steps stream through a three-stage cp.async ring
// and reach the tensor cores through ldmatrix; the output tile is staged in
// the freed ring and written in 16-byte pieces.
// The accumulators fill the register file at 64 rows, so every 64 output
// rows stream all of W (1.5 MB at k 3) from L2 again: 13.6 GB at layer 1,
// which, not the ring's depth (2, 3 and 4 stages time the same), holds the
// kernel near 190 TFLOP/s. Sharing W tiles across a cluster of blocks (TMA
// multicast) and wgmma are the next steps; this version is mma.sync, no
// TMA, one block an SM.

#include <math.h>

#include "flash_attn_common.cuh"

namespace {

constexpr int kBlockM = 64;            // output rows per block
constexpr int kBlockK = 32;            // reduction chunk of k * C_in
constexpr int kPitchK = kBlockK + 8;   // 80-byte rows: conflict-free ldmatrix
constexpr int kStages = 3;             // depth of the cp.async ring
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kThreadsBf16 = kWarpsM * kWarpsN * 32;
static_assert(kStages >= 2, "the ring needs two stages at least");

struct Params {
  const void* x;       // (B, L, C_in) contiguous
  const void* w;       // (C_out, k, C_in) contiguous
  const void* bias;    // (C_out,) in the input type, or null
  const float* ln_w;   // (C_out,)
  const float* ln_b;   // (C_out,)
  void* out;           // (B, T_out, C_out) contiguous
  int length, t_out, c_in, taps, stride;
  float eps;
};

__device__ __forceinline__ float gelu_exact(float y) {
  return 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
}

template <int kCout>
constexpr int smem_bytes_bf16() {
  // the operand ring, reused afterwards as the output tile
  constexpr int ring = kStages * (kBlockM + kCout) * kPitchK * 2;
  constexpr int tile = kBlockM * (kCout + 8) * 2;
  return ring > tile ? ring : tile;
}

// One stage of the ring: A rows t0 .. t0+63 and all C_out rows of W, over
// reduction columns k0 .. k0+31, in 16-byte pieces.
template <int kCout>
__device__ __forceinline__ void load_stage(__nv_bfloat16* sa,
                                           __nv_bfloat16* sb,
                                           const __nv_bfloat16* xb,
                                           const __nv_bfloat16* w,
                                           const Params& p, int t0, int k0,
                                           int k_total) {
  constexpr int kPieces = kBlockK / 8;
  {
    const int r = threadIdx.x / kPieces;
    const int c = (threadIdx.x % kPieces) * 8;
    const int t = t0 + r;
    const bool valid = t < p.t_out;
    const __nv_bfloat16* src =
        valid ? xb + static_cast<long long>(t) * p.stride * p.c_in + k0 + c
              : xb;
    cp_async16(sa + r * kPitchK + c, src, valid);
  }
#pragma unroll
  for (int i = threadIdx.x; i < kCout * kPieces; i += kThreadsBf16) {
    const int n = i / kPieces;
    const int c = (i % kPieces) * 8;
    cp_async16(sb + n * kPitchK + c,
               w + static_cast<long long>(n) * k_total + k0 + c, true);
  }
}

template <int kCout>
__global__ void __launch_bounds__(kThreadsBf16, 1)
fused_conv_ln_gelu_bf16_kernel(const Params p) {
  static_assert(kBlockM * kBlockK / 8 == kThreadsBf16,
                "one A piece per thread");
  constexpr int kWarpCols = kCout / kWarpsN;
  constexpr int kNT = kWarpCols / 8;  // n-tiles of 8 columns per warp
  static_assert(kNT % 2 == 0, "W fragments are loaded two n-tiles at once");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  // stage s: A at ring + s * kStageElems, W right after it
  constexpr int kStageElems = (kBlockM + kCout) * kPitchK;
  __shared__ float red[kWarpsN][kBlockM];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int k_total = p.taps * p.c_in;
  const int num_k = k_total / kBlockK;

  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(p.x) +
                            static_cast<long long>(b) * p.length * p.c_in;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);

  float acc[2][kNT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;
    }
  }

  // ldmatrix row addresses of this lane (matrix q = lane / 8, its row
  // lane % 8): A matrices (rows +0 / +8) x (k +0 / +8); W matrices
  // (k +0 / +8) x (n-tile +0 / +1)
  const int q = lane / 8, rr = lane % 8;
  const int a_off = (wm * 32 + (q & 1) * 8 + rr) * kPitchK + (q >> 1) * 8;
  const int b_off = (kBlockM + wn * kWarpCols + (q >> 1) * 8 + rr) * kPitchK +
                    (q & 1) * 8;

  // prologue: stages 0 .. kStages-2 in flight (a group per stage, empty
  // groups past the end keep the count uniform)
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < num_k) {
      __nv_bfloat16* stage = ring + st * kStageElems;
      load_stage<kCout>(stage, stage + kBlockM * kPitchK, xb, w, p, t0,
                        st * kBlockK, k_total);
    }
    cp_async_commit();
  }
  for (int kc = 0; kc < num_k; ++kc) {
    cp_async_wait<kStages - 2>();  // chunk kc has landed
    __syncthreads();  // ... for every thread; and chunk kc - 1 is consumed
    {
      const int next = kc + kStages - 1;  // into the stage of chunk kc - 1
      if (next < num_k) {
        __nv_bfloat16* stage = ring + (next % kStages) * kStageElems;
        load_stage<kCout>(stage, stage + kBlockM * kPitchK, xb, w, p, t0,
                          next * kBlockK, k_total);
      }
      cp_async_commit();
    }

    const __nv_bfloat16* tile = ring + (kc % kStages) * kStageElems;
#pragma unroll
    for (int ks = 0; ks < kBlockK / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        ldmatrix_x4(af[mi], tile + a_off + mi * 16 * kPitchK + ks * 16);
      }
#pragma unroll
      for (int ni = 0; ni < kNT; ni += 2) {
        uint32_t bf[4];  // n-tiles ni and ni + 1, k +0 and +8
        ldmatrix_x4(bf, tile + b_off + ni * 8 * kPitchK + ks * 16);
        mma_16816(acc[0][ni], af[0], bf);
        mma_16816(acc[1][ni], af[1], bf);
        mma_16816(acc[0][ni + 1], af[0], bf + 2);
        mma_16816(acc[1][ni + 1], af[1], bf + 2);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it becomes the tile

  // bias, rounded to bf16 by the caller, added in f32
  if (p.bias != nullptr) {
    const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(p.bias);
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      const int col = wn * kWarpCols + ni * 8 + 2 * t4;
      const float b0 = __bfloat162float(bias[col]);
      const float b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        acc[mi][ni][0] += b0;
        acc[mi][ni][1] += b1;
        acc[mi][ni][2] += b0;
        acc[mi][ni][3] += b1;
      }
    }
  }

  // per thread: rows wm*32 + mi*16 + g + 8*h, indexed ri = 2*mi + h
  float mean[4], rstd[4];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const int mi = ri / 2, h = ri % 2;
      float s = 0.f;
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        const float v0 = acc[mi][ni][2 * h];
        const float v1 = acc[mi][ni][2 * h + 1];
        if (pass == 0) {
          s += v0 + v1;
        } else {
          const float d0 = v0 - mean[ri], d1 = v1 - mean[ri];
          s += d0 * d0 + d1 * d1;
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t4 == 0) red[wn][wm * 32 + mi * 16 + h * 8 + g] = s;
    }
    __syncthreads();
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const int row = wm * 32 + (ri / 2) * 16 + (ri % 2) * 8 + g;
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarpsN; ++wi) s += red[wi][row];
      if (pass == 0) {
        mean[ri] = s / kCout;
      } else {
        rstd[ri] = rsqrtf(s / kCout + p.eps);
      }
    }
    __syncthreads();  // red is rewritten by the next pass
  }

  // normalise, GELU, round, into the output tile staged in the ring
  constexpr int kOutPitch = kCout + 8;
  __nv_bfloat16* tile = ring;
#pragma unroll
  for (int ni = 0; ni < kNT; ++ni) {
    const int col = wn * kWarpCols + ni * 8 + 2 * t4;
    const float w0 = p.ln_w[col], w1 = p.ln_w[col + 1];
    const float c0 = p.ln_b[col], c1 = p.ln_b[col + 1];
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const int mi = ri / 2, h = ri % 2;
      const int row = wm * 32 + mi * 16 + h * 8 + g;
      const float y0 = (acc[mi][ni][2 * h] - mean[ri]) * rstd[ri] * w0 + c0;
      const float y1 =
          (acc[mi][ni][2 * h + 1] - mean[ri]) * rstd[ri] * w1 + c1;
      *reinterpret_cast<uint32_t*>(&tile[row * kOutPitch + col]) =
          pack_bf16(gelu_exact(y0), gelu_exact(y1));
    }
  }
  __syncthreads();
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.out) +
                      (static_cast<long long>(b) * p.t_out + t0) * kCout;
  constexpr int kRowPieces = kCout / 8;
  for (int i = threadIdx.x; i < kBlockM * kRowPieces; i += kThreadsBf16) {
    const int r = i / kRowPieces;
    const int c = (i % kRowPieces) * 8;
    if (t0 + r < p.t_out) {
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(r) * kCout + c) =
          *reinterpret_cast<const uint4*>(&tile[r * kOutPitch + c]);
    }
  }
}

// The float32 variant, for models run in float32 (the bf16 kernel above is
// the serving path): scalar FMAs in full precision, no TF32. One block of
// C_out / 2 threads owns 16 output rows x all C_out columns, each thread two
// columns (tid and tid + C_out/2) of all 16 rows; operand tiles of 16
// reduction steps are staged in shared memory and read as broadcasts (A) and
// at a pitch of 17 words (W, conflict-free).
constexpr int kRowsF32 = 16;
constexpr int kChunkF32 = 16;

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
int launch_bf16(const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = smem_bytes_bf16<kCout>();
  auto kernel = fused_conv_ln_gelu_bf16_kernel<kCout>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.t_out + kBlockM - 1) / kBlockM, batch);
  kernel<<<grid, kThreadsBf16, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int kCout>
int launch_f32(const Params& p, int batch, cudaStream_t stream) {
  const dim3 grid((p.t_out + kRowsF32 - 1) / kRowsF32, batch);
  fused_conv_ln_gelu_f32_kernel<kCout><<<grid, kCout / 2, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int check_and_fill(Params& p, const void* x, const void* w, const void* bias,
                   const void* ln_w, const void* ln_b, void* out, int batch,
                   int length, int c_in, int taps, int stride, int t_out,
                   float eps, int chunk) {
  if (batch <= 0 || taps <= 0 || stride <= 0 || c_in <= 0 ||
      c_in % chunk != 0 || length < taps ||
      t_out != (length - taps) / stride + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  return 0;
}

}  // namespace

// Both entry points launch on `stream` and return a CUDA error code (0 on
// success). x (B, L, C_in), w (C_out, taps, C_in), out (B, T_out, C_out) are
// contiguous device buffers of the entry point's type with 16-byte aligned
// starts; bias (C_out,) of the same type or null; ln_w, ln_b (C_out,) float32.
// C_out must be 128, 256 or 512; C_in a multiple of 32 (bf16) or 16 (f32).
#define APTAI_FUSED_CONV_ARGS                                               \
  const void *x, const void *w, const void *bias, const void *ln_w,         \
      const void *ln_b, void *out, int batch, int length, int c_in,         \
      int c_out, int taps, int stride, int t_out, float eps, void *stream

extern "C" int aptai_fused_conv_ln_gelu_bf16(APTAI_FUSED_CONV_ARGS) {
  Params p;
  const int rc = check_and_fill(p, x, w, bias, ln_w, ln_b, out, batch, length,
                                c_in, taps, stride, t_out, eps, kBlockK);
  if (rc != 0) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c_out) {
    case 128: return launch_bf16<128>(p, batch, s);
    case 256: return launch_bf16<256>(p, batch, s);
    case 512: return launch_bf16<512>(p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int aptai_fused_conv_ln_gelu_f32(APTAI_FUSED_CONV_ARGS) {
  Params p;
  const int rc = check_and_fill(p, x, w, bias, ln_w, ln_b, out, batch, length,
                                c_in, taps, stride, t_out, eps, kChunkF32);
  if (rc != 0) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c_out) {
    case 128: return launch_f32<128>(p, batch, s);
    case 256: return launch_f32<256>(p, batch, s);
    case 512: return launch_f32<512>(p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
