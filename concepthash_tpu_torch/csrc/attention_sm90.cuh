// Full-row softmax attention of one (image, head) on Hopper's tensor cores,
// shared by the encoder-layer kernel (fused_layer.cu) and the attention
// kernel (attention.cu).
//
// The block stages q, k and v of its (image, head) in shared memory as bf16
// rows of pitch hd + 8 (16 bytes more than the row keeps ldmatrix free of
// bank conflicts); q is padded with zero rows to a multiple of 16, k and v to
// a multiple of 64. Each warp takes 16 query rows at a time:
//   S = Q K^T      mma.sync m16n8k16 bf16 -> f32 over 64-key chunks, the
//                  unscaled bf16 products summed in f32, then times
//                  hd^-0.5 in f32; keys past L at -inf;
//   softmax        f32, in registers, row maximum and sum with quad shuffles;
//   O = P V        mma.sync again, the probabilities taken straight from the
//                  score registers (the m16n8 accumulator layout is the
//                  m16k16 A layout).
// A row of L <= 64 keys is one chunk; a longer row takes three passes over
// its chunks (maximum, sum, then products), so L = 197 (ViT-B/16) fits.
//
// The probabilities enter P V in one of two precisions (SPLIT_P):
//   false  rounded to bf16, one product per chunk (the rounding point of the
//          encoder layer's reference);
//   true   kept at f32 precision: P = P_hi + P_lo with both bf16 (P_lo the
//          bf16 rounding of P - P_hi, so P_hi + P_lo holds 16 significant
//          bits), two products into the same f32 accumulator; v is bf16
//          and every product exact, so P V is P's f32 value times v up to
//          an f32 sum and 2^-17 relative in P.
//
// The scale: the reference computes (f32(q) * hd^-0.5) . f32(k); here
// (q . k) * hd^-0.5 in f32. Equal at hd = 16 and 64, where the scale is a
// power of two, within an f32 rounding at 32 and 128.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace attention_sm90 {

typedef __nv_bfloat16 bf16;

constexpr int MAX_WARPS = 8;
constexpr int KCHUNK = 64;     // keys per score chunk: 8 n8 blocks

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Shared memory of one block: q rows padded to 16, k and v rows to 64, each
// row hd + 8 bf16.
__host__ __device__ inline size_t smem_bytes(int L, int hd) {
  return (size_t)(round_up(L, 16) + 2 * round_up(L, KCHUNK)) * (hd + 8) *
         sizeof(bf16);
}

// Threads of one block: one warp per 16 query rows, at most MAX_WARPS.
__host__ __device__ inline int block_threads(int L) {
  const int warps = round_up(L, 16) / 16;
  return 32 * (warps < MAX_WARPS ? warps : MAX_WARPS);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Scores of the warp's 16 query rows against keys [64c, 64c + 64): s[nb][e]
// is row lane/4 (+8 for e >= 2), key 64c + 8nb + 2(lane%4) + (e & 1); scaled,
// keys past L at -inf.
template <int HD>
__device__ __forceinline__ void scores(float (&s)[8][4],
                                       const uint32_t (&qa)[HD / 16][4],
                                       uint32_t ks, int c, int L, float scale,
                                       int lane) {
  constexpr int P = (HD + 8) * 2;   // row pitch in bytes
  const int mi = lane / 8;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      // matrices: keys +0..7 / +8..15 (mi >> 1), d +0 / +8 (mi & 1)
      uint32_t b[4];
      const int key = c * KCHUNK + np * 16 + (mi >> 1) * 8 + lane % 8;
      ldmatrix_x4(b, ks + key * P + (kk * 16 + (mi & 1) * 8) * 2);
      mma_bf16(s[2 * np], qa[kk], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qa[kk], b[2], b[3]);
    }
  }
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = c * KCHUNK + nb * 8 + 2 * (lane % 4) + (e & 1);
      s[nb][e] = key < L ? s[nb][e] * scale : -INFINITY;
    }
}

// o += P @ v over keys [64c, 64c + 64), P = exp(s - m) / sum: bf16, or
// P_hi + P_lo at f32 precision (SPLIT_P).
template <int HD, bool SPLIT_P>
__device__ __forceinline__ void probs_times_v(float (&o)[HD / 8][4],
                                              const float (&s)[8][4],
                                              const float (&m)[2],
                                              const float (&inv)[2],
                                              uint32_t vs, int c, int lane) {
  constexpr int P = (HD + 8) * 2;
  const int mi = lane / 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // the m16n8 score blocks 2j, 2j+1 are the m16k16 A fragment of keys
    // 16j..16j+15: regs 0/1 rows lane/4 and +8 at keys +0..7, regs 2/3 at +8
    uint32_t pa[4], pl[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* sb = s[2 * j + h];
      const float p[4] = {expf(sb[0] - m[0]) * inv[0],
                          expf(sb[1] - m[0]) * inv[0],
                          expf(sb[2] - m[1]) * inv[1],
                          expf(sb[3] - m[1]) * inv[1]};
      pa[2 * h] = pack_bf16(p[0], p[1]);
      pa[2 * h + 1] = pack_bf16(p[2], p[3]);
      if constexpr (SPLIT_P) {
        const __nv_bfloat162 hi0 = *reinterpret_cast<__nv_bfloat162*>(&pa[2 * h]);
        const __nv_bfloat162 hi1 =
            *reinterpret_cast<__nv_bfloat162*>(&pa[2 * h + 1]);
        pl[2 * h] = pack_bf16(p[0] - __low2float(hi0), p[1] - __high2float(hi0));
        pl[2 * h + 1] =
            pack_bf16(p[2] - __low2float(hi1), p[3] - __high2float(hi1));
      }
    }
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      // transposed matrices: keys +0..7 / +8..15 (mi & 1), d +0 / +8 (mi >> 1)
      uint32_t b[4];
      const int key = c * KCHUNK + j * 16 + (mi & 1) * 8 + lane % 8;
      ldmatrix_x4_trans(b, vs + key * P + (dp * 16 + (mi >> 1) * 8) * 2);
      mma_bf16(o[2 * dp], pa, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
      if constexpr (SPLIT_P) {
        mma_bf16(o[2 * dp], pl, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pl, b[2], b[3]);
      }
    }
  }
}

// Attention of one (image, head) by the whole block (block_threads(L)
// threads, smem_bytes(L, HD) of dynamic shared memory at `smem`).
// rows(i, q, k, v) sets the three row pointers of token i < L (HD bf16 each,
// 16-byte aligned); store(r, d, x0, x1) writes output token r < L, head
// dims d and d + 1.
template <int HD, bool SPLIT_P, class Rows, class Store>
__device__ __forceinline__ void attend(unsigned char* smem, int L, float scale,
                                       Rows rows, Store store) {
  constexpr int P = HD + 8;
  const int Lq = round_up(L, 16);
  const int Lk = round_up(L, KCHUNK);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + Lq * P;
  bf16* vs = ks + Lk * P;

  for (int e = threadIdx.x; e < Lk * (HD / 8); e += blockDim.x) {
    const int i = e / (HD / 8);
    const int c = (e % (HD / 8)) * 8;
    uint4 q = make_uint4(0, 0, 0, 0), k = q, v = q;
    if (i < L) {
      const bf16 *qr, *kr, *vr;
      rows(i, qr, kr, vr);
      q = *reinterpret_cast<const uint4*>(qr + c);
      k = *reinterpret_cast<const uint4*>(kr + c);
      v = *reinterpret_cast<const uint4*>(vr + c);
    }
    if (i < Lq) *reinterpret_cast<uint4*>(qs + i * P + c) = q;
    *reinterpret_cast<uint4*>(ks + i * P + c) = k;
    *reinterpret_cast<uint4*>(vs + i * P + c) = v;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8;
  const uint32_t qs_a = smem_u32(qs);
  const uint32_t ks_a = smem_u32(ks);
  const uint32_t vs_a = smem_u32(vs);
  const int nchunks = Lk / KCHUNK;
  for (int q0 = warp * 16; q0 < Lq; q0 += (blockDim.x / 32) * 16) {
    // Q fragments: matrices rows +0..7 / +8..15 (mi & 1), d +0 / +8 (mi >> 1)
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldmatrix_x4(qa[kk], qs_a + ((q0 + (mi & 1) * 8 + lane % 8) * P +
                                  kk * 16 + (mi >> 1) * 8) * 2);
    float o[HD / 8][4];
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nb][e] = 0.0f;
    float s[8][4];
    float m[2] = {-INFINITY, -INFINITY};
    float sum[2] = {0.0f, 0.0f};
    // maximum of each row
    for (int c = 0; c < nchunks; ++c) {
      scores<HD>(s, qa, ks_a, c, L, scale, lane);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        m[0] = fmaxf(m[0], fmaxf(s[nb][0], s[nb][1]));
        m[1] = fmaxf(m[1], fmaxf(s[nb][2], s[nb][3]));
      }
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
    // sum of exp(s - m); a one-chunk row keeps its scores from above
    for (int c = 0; c < nchunks; ++c) {
      if (nchunks > 1) scores<HD>(s, qa, ks_a, c, L, scale, lane);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        sum[0] += expf(s[nb][0] - m[0]) + expf(s[nb][1] - m[0]);
        sum[1] += expf(s[nb][2] - m[1]) + expf(s[nb][3] - m[1]);
      }
    }
    const float inv[2] = {1.0f / quad_sum(sum[0]), 1.0f / quad_sum(sum[1])};
    for (int c = 0; c < nchunks; ++c) {
      if (nchunks > 1) scores<HD>(s, qa, ks_a, c, L, scale, lane);
      probs_times_v<HD, SPLIT_P>(o, s, m, inv, vs_a, c, lane);
    }
    const int r = q0 + lane / 4;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      const int d = nb * 8 + 2 * (lane % 4);
      if (r < L) store(r, d, o[nb][0], o[nb][1]);
      if (r + 8 < L) store(r + 8, d, o[nb][2], o[nb][3]);
    }
  }
}

}  // namespace attention_sm90
