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
// Design: a fixed sequence of launches behind one C entry
// `encoder_layer_fwd`, all on the caller's stream:
//   LN1 statistics -> GEMM(qkv, LN1 in its prologue) -> attention
//   -> GEMM(out-proj)
//   [-> LN -> GEMM(down, GELU) -> GEMM(up, scale, += h_att)]
//   -> residual + LN2 -> GEMM(fc1, act) -> GEMM(fc2, + x2 residual)
//   [fc2 writes the f32 branch instead; then LN -> GEMM(down, GELU)
//    -> GEMM(up, scale, + branch, + x2 residual)]
// That is 7 launches per layer without adapters and 13 with both. Every
// product runs on the Hopper GEMM core of gemm_sm90.cuh (TMA-fed mbarrier
// ring, warp-specialised wgmma, persistent blocks, fused epilogue: bias,
// activation, scale, f32 accumulate-in, bf16 residual, bf16 or f32 store);
// LN1 is its LayerNorm prologue, so xn1 never reaches device memory. LN2
// stays its own pass because it writes x2 too and normalises the unrounded
// f32 x2; the adapters' LN normalises the f32 branch rounded to bf16
// (LN_F32_AS_BF16), a pass of its own as well.
//
// Attention runs on the tensor cores (attention_sm90.cuh, shared with the
// attention kernel of attention.cu): one block per (image, head) stages q,
// k and v in shared memory (bf16, rows padded with zeros: q to 16, k and v
// to 64); each warp takes 16 query rows at a time. S = Q K^T is mma.sync
// m16n8k16 bf16 -> f32 over 64-key chunks, scaled by hd^-0.5 in f32 (the
// reference scales f32(q) first: the same values at hd = 16 and 64, where
// the scale is a power of two, within an f32 rounding otherwise); keys past
// L are masked to -inf. The softmax of the whole row is f32, in registers,
// with quad shuffles; the probabilities rounded to bf16 are the A operand
// of P V straight from the registers (the m16n8 accumulator layout is the
// m16k16 A layout). At L <= 64 one chunk holds the whole row; a longer row
// takes three passes over its chunks (maximum, sum, then products), so the
// rounding points stay those of the reference at every L.
//
// Bound on the H100: operations. One image at L = 54, D = 768, F = 3072,
// 12 heads, with both adapters of width 384, is about 0.89 GFLOP per layer
// (2*L*D*(3D + D + 2F) + 4*L*L*D + 8*L*D*A); at 989 TFLOP/s bf16 dense that
// is 0.9 us per image per layer. What keeps the layer above it: the
// intermediates between the launches (qkv, the f32 stream h_att / branch,
// x2, the MLP hidden) go through device memory, about 0.25 GB per layer at
// B = 256, read and written again by the f32 epilogues and the LayerNorm
// passes; and the GEMM core's own limits (gemm_sm90.cuh), the LN1 prologue's
// normalising above all.

#include "attention_sm90.cuh"
#include "gemm_sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using gemm_sm90::ACT_GELU;
using gemm_sm90::ACT_NONE;
using gemm_sm90::Epilogue;
using gemm_sm90::LnPrologue;

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
  LN_F32_AS_BF16 = 1,  // x_f32 rounded to bf16 first (the adapters' input)
  LN_RESIDUAL = 2      // f32(x_bf16) + x_f32 (x2 = x + h_att), unrounded
};

constexpr int LN_THREADS = 256;

// One warp per row, the row held in registers: lane l keeps columns
// [8(l + 32c), 8(l + 32c) + 8) for c < CH, so D <= 256 CH, read once.
// out = bf16(LN(row)); with LN_RESIDUAL also x2_out = bf16(row). D % 8 == 0.
template <int CH>
__global__ void __launch_bounds__(LN_THREADS)
layernorm_kernel(const bf16* __restrict__ xb, const float* __restrict__ xf,
                 int mode, const float* __restrict__ g,
                 const float* __restrict__ b, float eps, int M, int D,
                 bf16* __restrict__ out, bf16* __restrict__ x2_out) {
  const int row = blockIdx.x * (LN_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const size_t base = (size_t)row * D;
  float v[CH][8];
  float s = 0.0f;
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) {
    const int c = (lane + 32 * ch) * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[ch][e] = 0.0f;
    if (c >= D) continue;
    const float4 f0 = *reinterpret_cast<const float4*>(xf + base + c);
    const float4 f1 = *reinterpret_cast<const float4*>(xf + base + c + 4);
    const float f[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
    if (mode == LN_F32_AS_BF16) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[ch][e] = round_bf16(f[e]);
    } else {
      const uint4 h = *reinterpret_cast<const uint4*>(xb + base + c);
      const uint32_t w[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[ch][2 * e] = gemm_sm90::bf16_lo(w[e]) + f[2 * e];
        v[ch][2 * e + 1] = gemm_sm90::bf16_hi(w[e]) + f[2 * e + 1];
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) s += v[ch][e];
  }
  const float mu = warp_sum(s) / D;
  float q = 0.0f;
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) {
    if ((lane + 32 * ch) * 8 >= D) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) q += (v[ch][e] - mu) * (v[ch][e] - mu);
  }
  const float rstd = rsqrtf(warp_sum(q) / D + eps);
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) {
    const int c = (lane + 32 * ch) * 8;
    if (c >= D) continue;
    const float4 g0 = *reinterpret_cast<const float4*>(g + c);
    const float4 g1 = *reinterpret_cast<const float4*>(g + c + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b + c);
    const float4 b1 = *reinterpret_cast<const float4*>(b + c + 4);
    const float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint32_t o[4], x2[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[e] = gemm_sm90::pack_bf16(
          (v[ch][2 * e] - mu) * rstd * gg[2 * e] + bb[2 * e],
          (v[ch][2 * e + 1] - mu) * rstd * gg[2 * e + 1] + bb[2 * e + 1]);
      x2[e] = gemm_sm90::pack_bf16(v[ch][2 * e], v[ch][2 * e + 1]);
    }
    *reinterpret_cast<uint4*>(out + base + c) = make_uint4(o[0], o[1], o[2], o[3]);
    if (x2_out)
      *reinterpret_cast<uint4*>(x2_out + base + c) =
          make_uint4(x2[0], x2[1], x2[2], x2[3]);
  }
}

// ---------------------------------------------------------------------------
// attention on the tensor cores
// ---------------------------------------------------------------------------

// One block per (image, head) on the shared tensor-core attention of
// attention_sm90.cuh, probabilities rounded to bf16 as the reference rounds
// them. qkv: (B*L, 3D) bf16 rows [q | k | v]; out: (B*L, D) bf16 with head h
// in columns [h*hd, (h+1)*hd).
template <int HD>
__global__ void __launch_bounds__(attention_sm90::MAX_WARPS * 32)
attention_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                     int L, int D, int H, float scale) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const size_t row0 = (size_t)b * L;
  const int ld = 3 * D;
  attention_sm90::attend<HD, false>(
      att_smem, L, scale,
      [&](int i, const bf16*& q, const bf16*& k, const bf16*& v) {
        q = qkv + (row0 + i) * ld + h * HD;
        k = q + D;
        v = q + 2 * D;
      },
      [&](int r, int d, float x0, float x1) {
        *reinterpret_cast<__nv_bfloat162*>(out + (row0 + r) * D + h * HD + d) =
            __floats2bfloat162_rn(x0, x1);
      });
}

template <int HD>
cudaError_t attention_launch(cudaStream_t st, const bf16* qkv, bf16* out,
                             int B, int L, int D, int H) {
  const size_t smem = attention_sm90::smem_bytes(L, HD);
  cudaError_t e = ensure_smem_limit(attention_mma_kernel<HD>, (int)smem);
  if (e != cudaSuccess) return e;
  attention_mma_kernel<HD><<<B * H, attention_sm90::block_threads(L), smem,
                             st>>>(qkv, out, L, D, H, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

cudaError_t attention(cudaStream_t st, const bf16* qkv, bf16* out, int B,
                      int L, int D, int H) {
  switch (D / H) {
    case 16: return attention_launch<16>(st, qkv, out, B, L, D, H);
    case 32: return attention_launch<32>(st, qkv, out, B, L, D, H);
    case 64: return attention_launch<64>(st, qkv, out, B, L, D, H);
    case 128: return attention_launch<128>(st, qkv, out, B, L, D, H);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the layer
// ---------------------------------------------------------------------------

size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

struct Workspace {
  float* stats;  // (M, 2)   LN1 (mu, rstd)
  bf16* xn;      // (M, D)   LN outputs
  bf16* qkv;     // (M, 3D)
  bf16* o;       // (M, D)   attention output
  float* acc;    // (M, D)   h_att, then the MLP branch
  bf16* x2;      // (M, D)
  bf16* hid;     // (M, max(F, A))
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
  w.stats = reinterpret_cast<float*>(take(M * 2 * 4));
  w.xn = reinterpret_cast<bf16*>(take(M * D * 2));
  w.qkv = reinterpret_cast<bf16*>(take(M * 3 * D * 2));
  w.o = reinterpret_cast<bf16*>(take(M * D * 2));
  w.acc = reinterpret_cast<float*>(take(M * D * 4));
  w.x2 = reinterpret_cast<bf16*>(take(M * D * 2));
  w.hid = reinterpret_cast<bf16*>(take(M * (F > A ? F : A) * 2));
  w.bytes = off;
  return w;
}

int gemm(cudaStream_t st, const bf16* A, const bf16* W, int M, int N, int K,
         const float* bias, int act, const float* scale, const float* add_f32,
         const bf16* resid, float* out_f32, bf16* out_bf16) {
  Epilogue ep{bias, act, scale, add_f32, resid, out_f32, out_bf16};
  return gemm_sm90::gemm(st, A, W, M, N, K, ep);
}

template <int CH>
int layernorm_launch(cudaStream_t st, const bf16* xb, const float* xf,
                     int mode, const float* g, const float* b, float eps,
                     int M, int D, bf16* out, bf16* x2_out) {
  const int rows_per_block = LN_THREADS / 32;
  layernorm_kernel<CH><<<(M + rows_per_block - 1) / rows_per_block,
                         LN_THREADS, 0, st>>>(xb, xf, mode, g, b, eps, M, D,
                                              out, x2_out);
  return (int)cudaGetLastError();
}

int layernorm(cudaStream_t st, const bf16* xb, const float* xf, int mode,
              const float* g, const float* b, float eps, int M, int D,
              bf16* out, bf16* x2_out) {
  switch ((D + 255) / 256) {
    case 1: return layernorm_launch<1>(st, xb, xf, mode, g, b, eps, M, D, out, x2_out);
    case 2: return layernorm_launch<2>(st, xb, xf, mode, g, b, eps, M, D, out, x2_out);
    case 3: return layernorm_launch<3>(st, xb, xf, mode, g, b, eps, M, D, out, x2_out);
    case 4: return layernorm_launch<4>(st, xb, xf, mode, g, b, eps, M, D, out, x2_out);
    case 5: return layernorm_launch<5>(st, xb, xf, mode, g, b, eps, M, D, out, x2_out);
    case 6: return layernorm_launch<6>(st, xb, xf, mode, g, b, eps, M, D, out, x2_out);
    case 7: return layernorm_launch<7>(st, xb, xf, mode, g, b, eps, M, D, out, x2_out);
    case 8: return layernorm_launch<8>(st, xb, xf, mode, g, b, eps, M, D, out, x2_out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Adapter on the f32 stream `acc` (rounded to bf16 at its input), added in
// place: acc += adapter(bf16(acc)); with resid/out_bf16 set the sum is
// instead written as bf16(resid + acc + adapter(...)).
int adapter(cudaStream_t st, const Workspace& w, const void* const* p, int M,
            int D, int A, const bf16* resid, bf16* out_bf16) {
  const float* ln_g = static_cast<const float*>(p[0]);
  const float* ln_b = static_cast<const float*>(p[1]);
  const bf16* wd = static_cast<const bf16*>(p[2]);
  const float* bd = static_cast<const float*>(p[3]);
  const bf16* wu = static_cast<const bf16*>(p[4]);
  const float* bu = static_cast<const float*>(p[5]);
  const float* sc = static_cast<const float*>(p[6]);
  if (int e = layernorm(st, nullptr, w.acc, LN_F32_AS_BF16, ln_g, ln_b, 1e-5f,
                        M, D, w.xn, nullptr))
    return e;
  if (int e = gemm(st, w.xn, wd, M, A, D, bd, ACT_GELU, nullptr, nullptr,
                   nullptr, nullptr, w.hid))
    return e;
  if (out_bf16)
    return gemm(st, w.hid, wu, M, D, A, bu, ACT_NONE, sc, w.acc, resid,
                nullptr, out_bf16);
  return gemm(st, w.hid, wu, M, D, A, bu, ACT_NONE, sc, w.acc, nullptr, w.acc,
              nullptr);
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
  return attention_sm90::smem_bytes(L, hd);
}

const char* encoder_layer_error_string(int code) {
  return gemm_sm90::error_string(code);
}

// x, out: (B, L, D) bf16. act: 1 quick_gelu, 2 gelu. a1, a2: adapter
// bottleneck widths, 0 for no adapter. D / H in {16, 32, 64, 128}. Returns
// 0, a cudaError_t, or a tensor-map encode failure.
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
#define CK(call)            \
  do {                      \
    const int e_ = (call);  \
    if (e_) return e_;      \
  } while (0)

  CK(gemm_sm90::row_stats(st, xb, M, D, eps, w.stats));
  const LnPrologue ln1{w.stats, f32(0), f32(1)};
  const Epilogue qkv_ep{f32(3), ACT_NONE, nullptr, nullptr,
                        nullptr, nullptr,  w.qkv};
  CK(gemm_sm90::gemm(st, xb, b16(2), M, 3 * D, D, qkv_ep, &ln1));
  CK(attention(st, w.qkv, w.o, B, L, D, H));
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
