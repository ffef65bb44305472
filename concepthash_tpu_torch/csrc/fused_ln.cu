// LayerNorm -> matmul on Hopper (sm_90a), bf16 in and out.
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
// bias: (F,) f32; out: (N, F) bf16. Any N and F: the TPU kernel pads N to its
// row block and zeroes the tail, here TMA zero-fills the edges and the tail
// is simply not stored. D % 8 == 0 (TMA's 16-byte row stride).
//
// Design: two launches behind one C entry. A row-statistics pass (one warp
// per row) writes each row's (mu, rstd) once, in f32, to a (N, 2) workspace
// the wrapper allocates. Then the Hopper GEMM core of gemm_sm90.cuh with its
// LayerNorm prologue, on 64 x 256 tiles: TMA brings raw x and W tiles
// through an mbarrier ring; the consumer warpgroup that owns a tile
// normalises each x stage in place in shared memory and feeds wgmma from
// there; the bias add and the bf16 cast are the epilogue. The normalised
// tensor never goes to device memory. (The WMMA design this replaces
// recomputed each row's statistics once per 64-column block, 36 times for
// q|k|v and 48 for fc1, and staged K through shared memory with nothing in
// flight.)
//
// Bound on the H100: operations. At N = 1,728 (32 images x 54 tokens),
// D = 768, the q|k|v (F = 2,304) and fc1 (F = 3,072) calls are 14.3 GFLOP
// together, 14.4 us at 989 TFLOP/s bf16 dense, against 32 MB of x, W and
// out (10 us at 3.35 TB/s). What keeps it above: at that N each call has
// only 243-324 tiles for 132 SMs, so the ring's fill and the last tile's
// epilogue weigh; every column tile normalises its x stages again (9-12
// times per row at F = 2,304-3,072); and the host work of one call (checks,
// two launches, two tensor maps) is longer than its device time.

#include "gemm_sm90.cuh"

typedef __nv_bfloat16 bf16;

extern "C" {

const char* ln_matmul_error_string(int code) {
  return gemm_sm90::error_string(code);
}

// x: (N, D) bf16; gamma, beta: (D,) f32; w: (F, D) bf16; bias: (F,) f32;
// out: (N, F) bf16; stats: (N, 2) f32 workspace. N >= 1, D % 8 == 0.
// Returns 0, a cudaError_t, or a tensor-map encode failure.
int ln_matmul_fwd(const void* x, const void* gamma, const void* beta,
                  const void* w, const void* bias, void* out, int N, int D,
                  int F, float eps, void* stats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  float* sts = static_cast<float*>(stats);
  if (int e = gemm_sm90::row_stats(st, xb, N, D, eps, sts)) return e;
  gemm_sm90::Epilogue ep{static_cast<const float*>(bias),
                         gemm_sm90::ACT_NONE,
                         nullptr,
                         nullptr,
                         nullptr,
                         nullptr,
                         static_cast<bf16*>(out)};
  gemm_sm90::LnPrologue ln{sts, static_cast<const float*>(gamma),
                           static_cast<const float*>(beta)};
  return gemm_sm90::gemm(st, xb, static_cast<const bf16*>(w), N, F, D, ep,
                         &ln);
}

}  // extern "C"
