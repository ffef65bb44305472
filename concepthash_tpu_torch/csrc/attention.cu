// Full-row softmax attention on Hopper (sm_90a), bf16 in and out, f32 inside,
// on the tensor cores.
//
// Replaces the Pallas kernel `_attn_kernel` of concepthash_tpu/ops/attention.py,
// driven there by `_pallas_forward`, `fused_attention` and
// `attention(impl="pallas")`.
//
// What it computes, as the TPU kernel does, in f32 from the loaded values:
//   logits[i, j] = (f32(q[b, i, h, :]) * hd^-0.5) . f32(k[b, j, h, :])
//   p[i, :]      = exp(logits[i, :] - max_j logits[i, j]) / sum of the same
//   out[b, i, h] = bf16(sum_j p[i, j] * f32(v[b, j, h, :]))
// The probabilities keep f32 precision into P.V (no bf16 rounding, unlike
// the einsum path of the model).
//
// q, k and v are (B, L, H, hd) bf16 views, each with its own batch, token and
// head strides (multiples of 8 elements, 16-byte aligned bases) and unit
// element stride, so the three are read in place from the (B, L, 3D) q|k|v
// output of the LayerNorm -> matmul kernel, without the (B*H, L, hd)
// transposes and the padding of L that the TPU version makes. out is
// (B, L, H, hd) contiguous. hd is 16, 32, 64 or 128.
//
// Design: one block per (image, head), one warp per 16 queries (at most 8
// warps), on the tensor-core attention of attention_sm90.cuh that the
// encoder-layer kernel uses too: q, k and v staged once per (image, head)
// with 16-byte loads into bf16 shared memory (padding rows zero, no padding
// in device memory, keys past L masked in registers), S = Q K^T and O = P V
// on mma.sync m16n8k16 with f32 accumulation, the softmax in registers. The
// logits are the unscaled bf16 products summed in f32, times hd^-0.5 in f32
// (the reference's value exactly at hd 16 and 64, within an f32 rounding at
// 32 and 128). P enters P V as P_hi + P_lo, two bf16 products into one f32
// accumulator, so P keeps 16 significant bits where a bf16 P keeps 8.
// Shared memory is (round_up(L, 16) + 2 round_up(L, 64)) (hd + 8) bf16: 36 KB
// at L = 54 and 83 KB at L = 197 for hd = 64; the wrapper raises past the
// 227 KB a block may have (L > 512 at hd = 64, L > 256 at hd = 128).
//
// Bound on the H100: bytes. At B = 32, L = 54, H = 12, hd = 64 the function
// reads 7.96 MB of q, k, v and writes 2.65 MB (3.2 us at 3.35 TB/s) for
// 0.29 GFLOP of products (0.3 us at 989 TFLOP/s, three times that with the
// split P). 384 blocks of 128 threads fill the card about 1.5 times over.

#include "attention_sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

struct View {
  const bf16* p;
  long long sb, sl, sh;   // batch, token and head strides, in elements
};

template <int HD, bool SPLIT_P>
__global__ void __launch_bounds__(attention_sm90::MAX_WARPS * 32)
attention_kernel(View q, View k, View v, bf16* __restrict__ out, int L, int H,
                 float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  attention_sm90::attend<HD, SPLIT_P>(
      smem, L, scale,
      [&](int i, const bf16*& qr, const bf16*& kr, const bf16*& vr) {
        qr = q.p + b * q.sb + i * q.sl + h * q.sh;
        kr = k.p + b * k.sb + i * k.sl + h * k.sh;
        vr = v.p + b * v.sb + i * v.sl + h * v.sh;
      },
      [&](int r, int d, float x0, float x1) {
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((size_t)b * L + r) * H + h) * HD + d) =
            __floats2bfloat162_rn(x0, x1);
      });
}

template <int HD, bool SPLIT_P>
cudaError_t launch(View q, View k, View v, bf16* out, int B, int L, int H,
                   float scale, cudaStream_t st) {
  const size_t smem = attention_sm90::smem_bytes(L, HD);
  cudaError_t e = ensure_smem_limit(attention_kernel<HD, SPLIT_P>, (int)smem);
  if (e != cudaSuccess) return e;
  attention_kernel<HD, SPLIT_P>
      <<<B * H, attention_sm90::block_threads(L), smem, st>>>(q, k, v, out, L,
                                                              H, scale);
  return cudaGetLastError();
}

template <bool SPLIT_P>
int attention_dispatch(const void* q, const void* k, const void* v,
                       const long long* strides, void* out, int B, int L,
                       int H, int hd, float scale, void* stream) {
  View vq{static_cast<const bf16*>(q), strides[0], strides[1], strides[2]};
  View vk{static_cast<const bf16*>(k), strides[3], strides[4], strides[5]};
  View vv{static_cast<const bf16*>(v), strides[6], strides[7], strides[8]};
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)launch<16, SPLIT_P>(vq, vk, vv, o, B, L, H, scale, st);
    case 32: return (int)launch<32, SPLIT_P>(vq, vk, vv, o, B, L, H, scale, st);
    case 64: return (int)launch<64, SPLIT_P>(vq, vk, vv, o, B, L, H, scale, st);
    case 128: return (int)launch<128, SPLIT_P>(vq, vk, vv, o, B, L, H, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

size_t attention_smem_bytes(int L, int hd) {
  return attention_sm90::smem_bytes(L, hd);
}

// q, k, v: base pointers of (B, L, H, hd) bf16 views; strides[9] holds the
// batch, token and head strides (in elements) of q, then k, then v. out:
// (B, L, H, hd) bf16 contiguous. scale: hd^-0.5 as the caller rounds it to
// f32. Returns a cudaError_t.
int attention_fwd(const void* q, const void* k, const void* v,
                  const long long* strides, void* out, int B, int L, int H,
                  int hd, float scale, void* stream) {
  return attention_dispatch<true>(q, k, v, strides, out, B, L, H, hd, scale,
                                  stream);
}

}  // extern "C"
