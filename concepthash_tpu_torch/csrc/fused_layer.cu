// One pre-LN CLIP encoder layer forward on Hopper (sm_90a), bf16 in and out.
//
// Replaces the Pallas kernel `_layer_kernel` (with its in-kernel helper
// `_adapter_kernel`) of concepthash_tpu/ops/fused_layer.py, driven there by
// `_pallas_layer` and `encoder_layer`.
//
// What it computes, at the same rounding points as the TPU kernel:
//   xn1 = bf16(LN1(x))                       LN statistics in f32
//   qkv = bf16(xn1 @ Wqkv^T + bqkv)          f32 accumulation
//   per (image, head): logits = (f32(q) * hd^-0.5) . f32(k), f32 softmax,
//   probabilities cast to bf16, o = bf16(p @ v) with f32 accumulation
//   h_att = o @ Wout^T + bout                kept in f32
//   [adapter_attn] h_att += adapter(bf16(h_att))
//   x2 = x + h_att;  LN2 statistics on the f32 x2;  x2 and LN2(x2) stored bf16
//   h = bf16(act(xn2 @ Wfc1^T + bfc1))
//   branch = bfc2 + h @ Wfc2^T               f32
//   [adapter_mlp] branch += adapter(bf16(branch))
//   out = bf16(f32(bf16(x2)) + branch)
// adapter(z) = ((gelu(bf16(LN_1e-5(z)) @ Wd^T + bd) as bf16) @ Wu^T + bu) * scale.
// The exact GELU uses CUDA's erff; the TPU kernel uses the Abramowitz-Stegun
// 7.1.26 approximation (|err| < 1.5e-7), which is below a bf16 ulp.
//
// Weights are in torch Linear layout, (out_features, in_features) row-major,
// bf16; LayerNorm parameters, biases and the adapter scale are f32.
//
// Design: a fixed sequence of hand-written kernels behind one C entry
// `encoder_layer_fwd`, all on the caller's stream:
//   LN1 -> GEMM(qkv) -> attention -> GEMM(out-proj)
//   [-> LN -> GEMM(down, GELU) -> GEMM(up, scale, += h_att)]
//   -> residual + LN2 -> GEMM(fc1, act) -> GEMM(fc2, + x2 residual)
//   [fc2 writes the f32 branch instead; then LN -> GEMM(down, GELU)
//    -> GEMM(up, scale, + branch, + x2 residual)]
// That is 8 launches per layer without adapters and 14 with both.
// The GEMM is one kernel with a fused epilogue (bias, activation, scale,
// f32 accumulate-in, bf16 residual, bf16 or f32 store): 64x64 output tiles,
// four warps of 32x32 each, bf16 WMMA 16x16x16 fragments with f32
// accumulators, K staged through shared memory 32 at a time. Attention runs
// one block per (image, head) with q, k, v, and the L x L logits in shared
// memory (L = 54 at ViT-B/32 with four concept tokens); L is not padded, so
// no key mask is needed.
//
// Bound on the H100: operations. One image at L = 54, D = 768, F = 3072,
// 12 heads, with both adapters of width 384, is about 0.89 GFLOP per layer
// (2*L*D*(3D + D + 2F) + 4*L*L*D + 8*L*D*A); at 989 TFLOP/s bf16 dense that
// is 0.9 us per image per layer. The weights (about 14 MB in bf16) are read
// once per 64-row tile of activations, from L2 after the first tile. This
// first version uses mma.sync through WMMA, not wgmma or TMA, and does not
// pipeline its shared-memory loads, so it stays well below the wgmma peak;
// the intermediates between the kernels (qkv, h_att, the MLP hidden) go
// through device memory. Both are work for a later change.

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
constexpr int GEMM_THREADS = 128;
constexpr int GEMM_SMEM = (BM * LDC * 4 > (BM + BN) * LDS * 2)
                              ? BM * LDC * 4 : (BM + BN) * LDS * 2;

enum Act { ACT_NONE = 0, ACT_QUICK_GELU = 1, ACT_GELU = 2 };

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == ACT_QUICK_GELU) return v * (1.0f / (1.0f + expf(-1.702f * v)));
  if (act == ACT_GELU) return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  return v;
}

struct Epilogue {
  const float* bias;     // (N,) or null
  int act;               // Act
  const float* scale;    // (1,) device scalar or null
  const float* add_f32;  // (M, N) f32 added after the scale, or null
  const bf16* resid;     // (M, N) bf16 added last, or null
  float* out_f32;        // exactly one of out_f32 / out_bf16 is set
  bf16* out_bf16;
};

// C[m, n] = sum_k A[m, k] * W[n, k], then the epilogue.
// A: (M, K) bf16 row-major; W: (N, K) bf16 row-major. K % 8 == 0.
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                 int M, int N, int K, Epilogue ep) {
  __shared__ __align__(128) unsigned char smem[GEMM_SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Ws = As + BM * LDS;
  float* Cs = reinterpret_cast<float*>(smem);

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int v = threadIdx.x; v < BM * BK / 8; v += GEMM_THREADS) {
      const int r = v / (BK / 8);
      const int c = (v % (BK / 8)) * 8;
      uint4 a = make_uint4(0, 0, 0, 0);
      uint4 w = make_uint4(0, 0, 0, 0);
      if (k0 + c < K) {
        if (m0 + r < M)
          a = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + c);
        if (n0 + r < N)
          w = *reinterpret_cast<const uint4*>(W + (size_t)(n0 + r) * K + k0 + c);
      }
      *reinterpret_cast<uint4*>(As + r * LDS + c) = a;
      *reinterpret_cast<uint4*>(Ws + r * LDS + c) = w;
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

  for (int e = threadIdx.x; e < BM * BN; e += GEMM_THREADS) {
    const int r = e / BN;
    const int c = e % BN;
    const int gm = m0 + r;
    const int gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    float v = Cs[r * LDC + c];
    if (ep.bias) v += ep.bias[gn];
    v = apply_act(v, ep.act);
    if (ep.scale) v *= ep.scale[0];
    const size_t o = (size_t)gm * N + gn;
    if (ep.add_f32) v = ep.add_f32[o] + v;
    if (ep.resid) v = __bfloat162float(ep.resid[o]) + v;
    if (ep.out_f32)
      ep.out_f32[o] = v;
    else
      ep.out_bf16[o] = __float2bfloat16(v);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Input modes of the LayerNorm kernel.
enum LnIn {
  LN_BF16 = 0,       // x_bf16
  LN_F32_AS_BF16 = 1,  // x_f32 rounded to bf16 first (the adapters' input)
  LN_RESIDUAL = 2    // f32(x_bf16) + x_f32 (x2 = x + h_att), unrounded
};

constexpr int LN_THREADS = 256;

// One warp per row: out = bf16(LN(row)); with LN_RESIDUAL also x2_out = bf16(row).
__global__ void __launch_bounds__(LN_THREADS)
layernorm_kernel(const bf16* __restrict__ xb, const float* __restrict__ xf,
                 int mode, const float* __restrict__ g,
                 const float* __restrict__ b, float eps, int M, int D,
                 bf16* __restrict__ out, bf16* __restrict__ x2_out) {
  const int row = blockIdx.x * (LN_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const size_t base = (size_t)row * D;
  auto load = [&](int c) -> float {
    if (mode == LN_BF16) return __bfloat162float(xb[base + c]);
    if (mode == LN_F32_AS_BF16) return round_bf16(xf[base + c]);
    return __bfloat162float(xb[base + c]) + xf[base + c];
  };
  float s = 0.0f;
  for (int c = lane; c < D; c += 32) s += load(c);
  const float mu = warp_sum(s) / D;
  float q = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float d = load(c) - mu;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / D + eps);
  for (int c = lane; c < D; c += 32) {
    const float v = load(c);
    out[base + c] = __float2bfloat16((v - mu) * rstd * g[c] + b[c]);
    if (x2_out) x2_out[base + c] = __float2bfloat16(v);
  }
}

constexpr int ATTN_THREADS = 128;

__host__ __device__ inline size_t attention_smem_bytes(int L, int hd) {
  // q (scaled) and k with a +1 pitch, v, and the L x (L+1) scores, all f32
  return sizeof(float) * ((size_t)2 * L * (hd + 1) + (size_t)L * hd +
                          (size_t)L * (L + 1));
}

// One block per (image, head). qkv: (B*L, 3D) bf16 rows [q | k | v];
// out: (B*L, D) bf16 with head h in columns [h*hd, (h+1)*hd).
__global__ void __launch_bounds__(ATTN_THREADS)
attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int L,
                 int D, int H, float scale) {
  extern __shared__ float sm[];
  const int hd = D / H;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  float* qs = sm;
  float* ks = qs + L * (hd + 1);
  float* vs = ks + L * (hd + 1);
  float* ps = vs + L * hd;
  const size_t row0 = (size_t)b * L;
  const int ld = 3 * D;

  for (int e = threadIdx.x; e < L * hd; e += ATTN_THREADS) {
    const int i = e / hd;
    const int d = e % hd;
    const bf16* r = qkv + (row0 + i) * ld + h * hd + d;
    qs[i * (hd + 1) + d] = __bfloat162float(r[0]) * scale;
    ks[i * (hd + 1) + d] = __bfloat162float(r[D]);
    vs[i * hd + d] = __bfloat162float(r[2 * D]);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < L * L; e += ATTN_THREADS) {
    const int i = e / L;
    const int j = e % L;
    const float* qi = qs + i * (hd + 1);
    const float* kj = ks + j * (hd + 1);
    float s = 0.0f;
    for (int d = 0; d < hd; ++d) s += qi[d] * kj[d];
    ps[i * (L + 1) + j] = s;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < L; i += ATTN_THREADS / 32) {
    float* p = ps + i * (L + 1);
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, p[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float ex = expf(p[j] - m);
      p[j] = ex;
      s += ex;
    }
    s = warp_sum(s);
    for (int j = lane; j < L; j += 32) p[j] = round_bf16(p[j] / s);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < L * hd; e += ATTN_THREADS) {
    const int i = e / hd;
    const int d = e % hd;
    const float* p = ps + i * (L + 1);
    float s = 0.0f;
    for (int j = 0; j < L; ++j) s += p[j] * vs[j * hd + d];
    out[(row0 + i) * D + h * hd + d] = __float2bfloat16(s);
  }
}

size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

struct Workspace {
  bf16* xn;    // (M, D)   LN outputs
  bf16* qkv;   // (M, 3D)
  bf16* o;     // (M, D)   attention output
  float* acc;  // (M, D)   h_att, then the MLP branch
  bf16* x2;    // (M, D)
  bf16* hid;   // (M, max(F, A))
  size_t bytes;
};

Workspace carve(unsigned char* base, size_t M, size_t D, size_t F, size_t A) {
  Workspace w;
  size_t off = 0;
  auto take = [&](size_t n) {
    unsigned char* p = base ? base + off : nullptr;
    off += align256(n);
    return p;
  };
  w.xn = reinterpret_cast<bf16*>(take(M * D * 2));
  w.qkv = reinterpret_cast<bf16*>(take(M * 3 * D * 2));
  w.o = reinterpret_cast<bf16*>(take(M * D * 2));
  w.acc = reinterpret_cast<float*>(take(M * D * 4));
  w.x2 = reinterpret_cast<bf16*>(take(M * D * 2));
  w.hid = reinterpret_cast<bf16*>(take(M * (F > A ? F : A) * 2));
  w.bytes = off;
  return w;
}

cudaError_t gemm(cudaStream_t st, const bf16* A, const bf16* W, int M, int N,
                 int K, const float* bias, int act, const float* scale,
                 const float* add_f32, const bf16* resid, float* out_f32,
                 bf16* out_bf16) {
  Epilogue ep{bias, act, scale, add_f32, resid, out_f32, out_bf16};
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<<<grid, GEMM_THREADS, 0, st>>>(A, W, M, N, K, ep);
  return cudaGetLastError();
}

cudaError_t layernorm(cudaStream_t st, const bf16* xb, const float* xf,
                      int mode, const float* g, const float* b, float eps,
                      int M, int D, bf16* out, bf16* x2_out) {
  const int rows_per_block = LN_THREADS / 32;
  layernorm_kernel<<<(M + rows_per_block - 1) / rows_per_block, LN_THREADS, 0,
                     st>>>(xb, xf, mode, g, b, eps, M, D, out, x2_out);
  return cudaGetLastError();
}

// Adapter on the f32 stream `acc` (rounded to bf16 at its input), added in
// place: acc += adapter(bf16(acc)); with resid/out_bf16 set the sum is
// instead written as bf16(resid + acc + adapter(...)).
cudaError_t adapter(cudaStream_t st, const Workspace& w, const void* const* p,
                    int M, int D, int A, const bf16* resid, bf16* out_bf16) {
  const float* ln_g = static_cast<const float*>(p[0]);
  const float* ln_b = static_cast<const float*>(p[1]);
  const bf16* wd = static_cast<const bf16*>(p[2]);
  const float* bd = static_cast<const float*>(p[3]);
  const bf16* wu = static_cast<const bf16*>(p[4]);
  const float* bu = static_cast<const float*>(p[5]);
  const float* sc = static_cast<const float*>(p[6]);
  cudaError_t e = layernorm(st, nullptr, w.acc, LN_F32_AS_BF16, ln_g, ln_b,
                            1e-5f, M, D, w.xn, nullptr);
  if (e != cudaSuccess) return e;
  e = gemm(st, w.xn, wd, M, A, D, bd, ACT_GELU, nullptr, nullptr, nullptr,
           nullptr, w.hid);
  if (e != cudaSuccess) return e;
  if (out_bf16)
    return gemm(st, w.hid, wu, M, D, A, bu, ACT_NONE, sc, w.acc, resid,
                nullptr, out_bf16);
  return gemm(st, w.hid, wu, M, D, A, bu, ACT_NONE, sc, w.acc, nullptr,
              w.acc, nullptr);
}

}  // namespace

// Pointer table of encoder_layer_fwd, in this order:
//  0 ln1_scale  1 ln1_bias  2 w_qkv  3 b_qkv  4 w_out  5 b_out
//  6 ln2_scale  7 ln2_bias  8 w_fc1  9 b_fc1 10 w_fc2 11 b_fc2
// 12..18 adapter_attn: ln_scale ln_bias w_down b_down w_up b_up scale
// 19..25 adapter_mlp: the same seven
extern "C" {

size_t encoder_layer_workspace_bytes(int M, int D, int F, int A) {
  return carve(nullptr, M, D, F, A).bytes;
}

size_t encoder_layer_attention_smem_bytes(int L, int hd) {
  return attention_smem_bytes(L, hd);
}

const char* encoder_layer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, out: (B, L, D) bf16. act: 1 quick_gelu, 2 gelu. a1, a2: adapter
// bottleneck widths, 0 for no adapter. Returns a cudaError_t.
int encoder_layer_fwd(const void* x, void* out, int B, int L, int D, int H,
                      int F, int act, float eps, const void* const* p, int a1,
                      int a2, void* workspace, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * L;
  const int amax = a1 > a2 ? a1 : a2;
  Workspace w = carve(static_cast<unsigned char*>(workspace), M, D, F, amax);
  const bf16* xb = static_cast<const bf16*>(x);
  auto f32 = [&](int i) { return static_cast<const float*>(p[i]); };
  auto b16 = [&](int i) { return static_cast<const bf16*>(p[i]); };
  cudaError_t e;
#define CK(call)                       \
  do {                                 \
    e = (call);                        \
    if (e != cudaSuccess) return (int)e; \
  } while (0)

  CK(layernorm(st, xb, nullptr, LN_BF16, f32(0), f32(1), eps, M, D, w.xn,
               nullptr));
  CK(gemm(st, w.xn, b16(2), M, 3 * D, D, f32(3), ACT_NONE, nullptr, nullptr,
          nullptr, nullptr, w.qkv));
  const int hd = D / H;
  const size_t smem = attention_smem_bytes(L, hd);
  CK(cudaFuncSetAttribute(attention_kernel,
                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                          (int)smem));
  attention_kernel<<<B * H, ATTN_THREADS, smem, st>>>(w.qkv, w.o, L, D, H,
                                                       1.0f / sqrtf((float)hd));
  CK(cudaGetLastError());
  CK(gemm(st, w.o, b16(4), M, D, D, f32(5), ACT_NONE, nullptr, nullptr,
          nullptr, w.acc, nullptr));
  if (a1) CK(adapter(st, w, p + 12, M, D, a1, nullptr, nullptr));
  CK(layernorm(st, xb, w.acc, LN_RESIDUAL, f32(6), f32(7), eps, M, D, w.xn,
               w.x2));
  CK(gemm(st, w.xn, b16(8), M, F, D, f32(9), act, nullptr, nullptr, nullptr,
          nullptr, w.hid));
  bf16* ob = static_cast<bf16*>(out);
  if (a2) {
    CK(gemm(st, w.hid, b16(10), M, D, F, f32(11), ACT_NONE, nullptr, nullptr,
            nullptr, w.acc, nullptr));
    CK(adapter(st, w, p + 19, M, D, a2, w.x2, ob));
  } else {
    CK(gemm(st, w.hid, b16(10), M, D, F, f32(11), ACT_NONE, nullptr, nullptr,
            w.x2, nullptr, ob));
  }
#undef CK
  return (int)cudaGetLastError();
}

}  // extern "C"
