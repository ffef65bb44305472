// Full-row softmax attention on Hopper (sm_90a), bf16 in and out, f32 inside.
//
// Replaces the Pallas kernel `_attn_kernel` of concepthash_tpu/ops/attention.py,
// driven there by `_pallas_forward`, `fused_attention` and
// `attention(impl="pallas")`.
//
// What it computes, as the TPU kernel does, in f32 from the loaded values:
//   logits[i, j] = (f32(q[b, i, h, :]) * hd^-0.5) . f32(k[b, j, h, :])
//   p[i, :]      = exp(logits[i, :] - max_j logits[i, j]) / sum of the same
//   out[b, i, h] = bf16(sum_j p[i, j] * f32(v[b, j, h, :]))
// The probabilities stay in f32 (no bf16 rounding before P.V, unlike the
// einsum path of the model).
//
// q, k and v are (B, L, H, hd) bf16 views, each with its own batch, token and
// head strides and unit element stride, so the three are read in place from
// the (B, L, 3D) q|k|v output of the LayerNorm -> matmul kernel, without the
// (B*H, L, hd) transposes and the padding of L that the TPU version makes.
// out is (B, L, H, hd) contiguous.
//
// Design: one block of 128 threads per (image, head, tile of 32 queries).
// The tile's queries (scaled), all L keys and values of that (image, head),
// and the 32 x L logits sit in f32 shared memory, with +1 pitches where a
// warp reads down a column. The logits are one dot product per thread and
// entry, the softmax one warp per row, P.V one thread per output element.
// L is not padded, so no key mask is needed. Shared memory grows with L:
// 4 * (32 * (hd + 1) + L * (2 * hd + 1) + 32 * (L + 1)) bytes, 43 KB at
// L = 54 and 135 KB at L = 197 (ViT-B/16 at 224^2) for hd = 64; the wrapper
// raises past the 227 KB a block may have (L > 347 at hd = 64).
//
// Bound on the H100: bytes. At B = 32, L = 54, H = 12, hd = 64 the function
// reads 7.96 MB of q, k, v and writes 2.65 MB (3.2 us at 3.35 TB/s) for
// 0.29 GFLOP of products. This first version runs the products on the CUDA
// cores in f32 (scalar loops), not on the tensor cores, and reloads each
// (image, head)'s keys and values once per query tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 32;
constexpr int THREADS = 128;

struct View {
  const bf16* p;
  long long sb, sl, sh;   // batch, token and head strides, in elements
};

__host__ __device__ inline size_t smem_bytes(int L, int hd) {
  return sizeof(float) * ((size_t)BQ * (hd + 1) + (size_t)L * (hd + 1) +
                          (size_t)L * hd + (size_t)BQ * (L + 1));
}

__device__ __forceinline__ const bf16* at(const View& t, int b, int i, int h) {
  return t.p + b * t.sb + i * t.sl + h * t.sh;
}

__global__ void __launch_bounds__(THREADS)
attention_kernel(View q, View k, View v, bf16* __restrict__ out, int L, int H,
                 int hd, float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int i0 = blockIdx.y * BQ;
  const int nq = min(BQ, L - i0);
  float* qs = sm;                     // BQ x (hd + 1)
  float* ks = qs + BQ * (hd + 1);     // L x (hd + 1)
  float* vs = ks + L * (hd + 1);      // L x hd
  float* ps = vs + L * hd;            // BQ x (L + 1)

  for (int e = threadIdx.x; e < nq * hd; e += THREADS) {
    const int i = e / hd;
    const int d = e % hd;
    qs[i * (hd + 1) + d] = __bfloat162float(at(q, b, i0 + i, h)[d]) * scale;
  }
  for (int e = threadIdx.x; e < L * hd; e += THREADS) {
    const int j = e / hd;
    const int d = e % hd;
    ks[j * (hd + 1) + d] = __bfloat162float(at(k, b, j, h)[d]);
    vs[j * hd + d] = __bfloat162float(at(v, b, j, h)[d]);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < nq * L; e += THREADS) {
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
  for (int i = warp; i < nq; i += THREADS / 32) {
    float* p = ps + i * (L + 1);
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, p[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float ex = expf(p[j] - m);
      p[j] = ex;
      s += ex;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    for (int j = lane; j < L; j += 32) p[j] = p[j] / s;
  }
  __syncthreads();

  for (int e = threadIdx.x; e < nq * hd; e += THREADS) {
    const int i = e / hd;
    const int d = e % hd;
    const float* p = ps + i * (L + 1);
    float s = 0.0f;
    for (int j = 0; j < L; ++j) s += p[j] * vs[j * hd + d];
    out[(((size_t)b * L + i0 + i) * H + h) * hd + d] = __float2bfloat16(s);
  }
}

}  // namespace

extern "C" {

const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

size_t attention_smem_bytes(int L, int hd) { return smem_bytes(L, hd); }

// q, k, v: base pointers of (B, L, H, hd) bf16 views; strides[9] holds the
// batch, token and head strides (in elements) of q, then k, then v. out:
// (B, L, H, hd) bf16 contiguous. scale: hd^-0.5 as the caller rounds it to
// f32. Returns a cudaError_t.
int attention_fwd(const void* q, const void* k, const void* v,
                  const long long* strides, void* out, int B, int L, int H,
                  int hd, float scale, void* stream) {
  const size_t smem = smem_bytes(L, hd);
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  View vq{static_cast<const bf16*>(q), strides[0], strides[1], strides[2]};
  View vk{static_cast<const bf16*>(k), strides[3], strides[4], strides[5]};
  View vv{static_cast<const bf16*>(v), strides[6], strides[7], strides[8]};
  dim3 grid(B * H, (L + BQ - 1) / BQ);
  attention_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      vq, vk, vv, static_cast<bf16*>(out), L, H, hd, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
