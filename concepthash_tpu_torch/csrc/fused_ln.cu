// LayerNorm -> matmul in one pass on Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas kernel `_ln_matmul_kernel` of
// concepthash_tpu/ops/fused_ln.py, driven there by `_pallas_ln_matmul` and
// `ln_matmul(impl="pallas")`.
//
// What it computes, at the same rounding points as the TPU kernel:
//   mu_n, var_n = mean and biased variance of row n of x, in f32
//                 (two passes: the variance is the mean of (x - mu)^2)
//   xn[n, d]    = bf16(((x[n, d] - mu_n) * rsqrt(var_n + eps)) * g[d] + b[d])
//   out[n, f]   = bf16(sum_d xn[n, d] * W[f, d] + bias[f])   f32 accumulation
// x: (N, D) bf16; g, b: (D,) f32; W: (F, D) bf16, torch Linear layout;
// bias: (F,) f32; out: (N, F) bf16. Any N: the TPU kernel pads N to its row
// block and zeroes the tail, here the tail rows are simply not stored.
// D % 8 == 0 (16-byte loads).
//
// Design: one block per 64 x 64 output tile, four warps of 32 x 32 each,
// bf16 WMMA 16x16x16 fragments with f32 accumulators, K staged through
// shared memory 32 at a time (the GEMM of csrc/fused_layer.cu). The
// LayerNorm is the tile's prologue: each warp takes 16 of the block's 64
// rows and computes their mean and rstd from x in device memory; the 64
// pairs stay in shared memory, and every A tile is normalized in f32 and
// rounded to bf16 on its way into shared memory. The normalized tensor never
// goes to device memory. The bias add and the bf16 cast are the epilogue.
//
// Bound on the H100: operations. At N = 1,728 (32 images x 54 tokens),
// D = 768, F = 2,304 (q|k|v) the product is 6.1 GFLOP, 6.2 us at 989
// TFLOP/s bf16 dense, against 14.2 MB of x, W and out (4.2 us at 3.35 TB/s).
// This first version uses mma.sync through WMMA, not wgmma or TMA, and does
// not pipeline its loads, so it stays well below the tensor-core peak; each
// of the F / 64 column blocks recomputes its rows' statistics from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int LDS = BK + 8;   // smem pitch of the A and W tiles, in bf16
constexpr int LDC = BN + 4;   // smem pitch of the f32 output tile
constexpr int THREADS = 128;
constexpr int SMEM = (BM * LDC * 4 > (BM + BN) * LDS * 2)
                         ? BM * LDC * 4 : (BM + BN) * LDS * 2;

union Pack8 {
  uint4 u;
  bf16 h[8];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
ln_matmul_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, const bf16* __restrict__ W,
                 const float* __restrict__ bias, bf16* __restrict__ out,
                 int N, int D, int F, float eps) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ float mu_s[BM];
  __shared__ float rstd_s[BM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Ws = As + BM * LDS;
  float* Cs = reinterpret_cast<float*>(smem);

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // row statistics of the block's rows (rows past N get 0, 0 and are never
  // stored)
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int gm = m0 + r;
    float mu = 0.0f;
    float rstd = 0.0f;
    if (gm < N) {
      const bf16* row = x + (size_t)gm * D;
      float s = 0.0f;
      for (int c = lane; c < D; c += 32) s += __bfloat162float(row[c]);
      mu = warp_sum(s) / D;
      float q = 0.0f;
      for (int c = lane; c < D; c += 32) {
        const float d = __bfloat162float(row[c]) - mu;
        q += d * d;
      }
      rstd = rsqrtf(warp_sum(q) / D + eps);
    }
    if (lane == 0) {
      mu_s[r] = mu;
      rstd_s[r] = rstd;
    }
  }
  __syncthreads();

  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int v = threadIdx.x; v < BM * BK / 8; v += THREADS) {
      const int r = v / (BK / 8);
      const int c = (v % (BK / 8)) * 8;
      const int gk = k0 + c;
      Pack8 a;
      Pack8 w;
      a.u = make_uint4(0, 0, 0, 0);
      w.u = make_uint4(0, 0, 0, 0);
      if (gk < D) {
        if (m0 + r < N) {
          Pack8 raw;
          raw.u = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * D + gk);
          const float mu = mu_s[r];
          const float rs = rstd_s[r];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            a.h[e] = __float2bfloat16(
                ((__bfloat162float(raw.h[e]) - mu) * rs) * g[gk + e] + b[gk + e]);
        }
        if (n0 + r < F)
          w.u = *reinterpret_cast<const uint4*>(W + (size_t)(n0 + r) * D + gk);
      }
      *reinterpret_cast<uint4*>(As + r * LDS + c) = a.u;
      *reinterpret_cast<uint4*>(Ws + r * LDS + c) = w.u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Ws + (wn + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN;
    const int c = e % BN;
    const int gm = m0 + r;
    const int gn = n0 + c;
    if (gm >= N || gn >= F) continue;
    out[(size_t)gm * F + gn] = __float2bfloat16(Cs[r * LDC + c] + bias[gn]);
  }
}

}  // namespace

extern "C" {

const char* ln_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (N, D) bf16; gamma, beta: (D,) f32; w: (F, D) bf16; bias: (F,) f32;
// out: (N, F) bf16. N >= 1, D % 8 == 0. Returns a cudaError_t.
int ln_matmul_fwd(const void* x, const void* gamma, const void* beta,
                  const void* w, const void* bias, void* out, int N, int D,
                  int F, float eps, void* stream) {
  dim3 grid((F + BN - 1) / BN, (N + BM - 1) / BM);
  ln_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), N, D, F, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
