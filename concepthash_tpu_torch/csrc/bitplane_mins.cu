// Per-subblock minimum Hamming distance over a bit-plane gallery, for exact
// top-k serving on Hopper (sm_90a).
//
// Replaces the Pallas kernel `_mins_kernel_bitplane` (via
// `subblock_min_dists_bitplane`) of concepthash_tpu/ops/topk_select.py.
//
// What it computes: the gallery is (G, 128) uint8 bit-planes. Bit j of
// byte bp[g, l] is the sign bit of packed row r = 8g + j at lane l, and code
// c = r * P + p (P = 128 / nbit) holds lanes [p * nbit, (p + 1) * nbit) of
// its packed row. For subblock s (codes [s*S, (s+1)*S), S a multiple of 8P,
// so every byte row lies in one subblock) and query q,
//   out[s, q] = min over the subblock's codes of popcount(code XOR query)
// which is the TPU kernel's 0.5 * (nbit - max <code, q>) for +-1 codes.
// Packed rows at or past n_rows count as distance nbit + 1, so a subblock
// with no valid row reads nbit + 1. The output is (m, Q), bf16 (exact: every
// value is an integer <= 129) or f32.
//
// Design: the TPU kernel unpacks the planes to {0, 1} int8 and runs an MXU
// dot against block-diagonal queries, working around Mosaic's int8 limits.
// Here the direct form is XOR and popcount on code-major words. One thread
// per query holds its query as the two 64-bit words of a 128-lane packed row
// (lane l carries query bit l % nbit). A block of 128 queries walks a run of
// subblocks, staging 32 byte rows (4 KB) at a time in shared memory: each
// 8-lane x 8-plane byte group is turned into code-major form by an 8x8 bit
// transpose of one uint64, so that packed row r becomes 16 bytes with lane l
// at bit l % 8 of byte l / 8. Every thread then reads each packed row as a
// shared-memory broadcast and takes P popcounts (two 32-bit POPC per 64
// code bits). The grid is 1-D with the query block varying fastest, so the
// blocks that share a gallery run read it from L2.
//
// Bound on the H100: for Q = 256 queries over N = 2^20 codes of 64 bits the
// 16 MB gallery takes 5 us at 3.35 TB/s, and the 2*Q*N*nbit int8-equivalent
// operations 17 us at 1,979 TOP/s on the tensor cores. This version runs on
// the CUDA cores, where the POPC rate (16 per SM per clock) bounds it at
// about 0.13 ms for that shape; the tensor cores' b1 mma (AND + popcount) is
// work for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;          // queries per block
constexpr int TILE_G = 32;            // byte rows staged per step
constexpr int ROWS_PER_BLOCK = 2048;  // packed rows a block walks (at least one subblock)

// 8x8 bit matrix in a uint64, element (k, b) at bit 8k + b -> (b, k).
__device__ __forceinline__ uint64_t transpose8x8(uint64_t x) {
  uint64_t t;
  t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x ^= t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x ^= t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  x ^= t ^ (t << 28);
  return x;
}

// Least Hamming distance between the query and the P codes of one packed
// row (w0: lanes 0-63, w1: lanes 64-127).
template <int NBIT>
__device__ __forceinline__ int row_min(uint64_t w0, uint64_t w1, uint64_t q0,
                                       uint64_t q1) {
  const uint64_t a = w0 ^ q0, b = w1 ^ q1;
  if constexpr (NBIT == 128) {
    return __popcll(a) + __popcll(b);
  } else if constexpr (NBIT == 64) {
    return min(__popcll(a), __popcll(b));
  } else if constexpr (NBIT == 32) {
    const int a0 = __popc((uint32_t)a), a1 = __popc((uint32_t)(a >> 32));
    const int b0 = __popc((uint32_t)b), b1 = __popc((uint32_t)(b >> 32));
    return min(min(a0, a1), min(b0, b1));
  } else {  // 16
    int m = NBIT + 1;
#pragma unroll
    for (int s = 0; s < 64; s += 16) {
      m = min(m, __popc((uint32_t)(a >> s) & 0xFFFFu));
      m = min(m, __popc((uint32_t)(b >> s) & 0xFFFFu));
    }
    return m;
  }
}

template <int NBIT>
__global__ void __launch_bounds__(THREADS)
bitplane_mins_kernel(const int8_t* __restrict__ q,
                     const uint8_t* __restrict__ bp, long long n_rows, int Q,
                     int rows_per_sb, long long m, int sb_per_block,
                     int n_qblocks, float* __restrict__ out_f32,
                     __nv_bfloat16* __restrict__ out_bf16) {
  __shared__ ulonglong2 rows[TILE_G * 8];  // code-major packed rows

  const long long qblock = blockIdx.x % n_qblocks;
  const long long gblock = blockIdx.x / n_qblocks;
  const int qi = (int)(qblock * THREADS) + threadIdx.x;

  uint64_t q0 = 0, q1 = 0;
  if (qi < Q) {
    const int8_t* qr = q + (size_t)qi * NBIT;
#pragma unroll 8
    for (int l = 0; l < 64; ++l) {
      q0 |= (uint64_t)(qr[l % NBIT] > 0) << l;
      q1 |= (uint64_t)(qr[(l + 64) % NBIT] > 0) << l;
    }
  }

  const long long sb0 = gblock * sb_per_block;
  const long long sb1 = sb0 + sb_per_block < m ? sb0 + sb_per_block : m;
  const long long r0 = sb0 * rows_per_sb;  // a multiple of 8
  const long long r_end = sb1 * rows_per_sb < n_rows ? sb1 * rows_per_sb
                                                     : n_rows;
  const int empty = NBIT + 1;

  int best = empty;
  int left = rows_per_sb;  // packed rows left in the current subblock
  long long sb = sb0;
  auto emit = [&](long long s, int v) {
    if (qi < Q) {
      const size_t o = (size_t)s * Q + qi;
      if (out_f32)
        out_f32[o] = (float)v;
      else
        out_bf16[o] = __float2bfloat16((float)v);
    }
  };

  uint8_t* rows_b = reinterpret_cast<uint8_t*>(rows);
  for (long long t0 = r0; t0 < r_end; t0 += TILE_G * 8) {
    const int nr = (int)(r_end - t0 < TILE_G * 8 ? r_end - t0 : TILE_G * 8);
    const int ng = (nr + 7) / 8;  // byte rows holding those packed rows
    const uint64_t* src =
        reinterpret_cast<const uint64_t*>(bp + (size_t)(t0 / 8) * 128);
    __syncthreads();
    for (int it = threadIdx.x; it < ng * 16; it += THREADS) {
      // byte row it / 16, lanes 8*(it % 16) .. +7: byte k of the load is
      // lane 8*(it%16) + k, its bit j is plane j; after the transpose byte j
      // holds those 8 lanes of packed row 8*(it/16) + j
      const uint64_t x = transpose8x8(src[it]);
      uint8_t* dst = rows_b + (size_t)(it >> 4) * 8 * 16 + (it & 15);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j * 16] = (uint8_t)(x >> (8 * j));
    }
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      const ulonglong2 w = rows[r];
      const int h = row_min<NBIT>(w.x, w.y, q0, q1);
      best = h < best ? h : best;
      if (--left == 0) {
        emit(sb++, best);
        best = empty;
        left = rows_per_sb;
      }
    }
  }
  // a subblock cut by n_rows, then subblocks with no valid row
  for (; sb < sb1; ++sb) {
    emit(sb, best);
    best = empty;
  }
}

template <int NBIT>
cudaError_t launch(const int8_t* q, const uint8_t* bp, long long n_rows, int Q,
                   int S, long long m, float* of, __nv_bfloat16* ob,
                   cudaStream_t st) {
  constexpr int P = 128 / NBIT;
  const int rows_per_sb = S / P;
  const int sb_per_block =
      rows_per_sb >= ROWS_PER_BLOCK ? 1 : ROWS_PER_BLOCK / rows_per_sb;
  const int n_qblocks = (Q + THREADS - 1) / THREADS;
  const long long n_gblocks = (m + sb_per_block - 1) / sb_per_block;
  const long long blocks = n_gblocks * n_qblocks;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bitplane_mins_kernel<NBIT><<<(unsigned)blocks, THREADS, 0, st>>>(
      q, bp, n_rows, Q, rows_per_sb, m, sb_per_block, n_qblocks, of, ob);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* bitplane_mins_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: (Q, nbit) int8 +-1; bp: (G, 128) uint8 bit-planes; the first n_rows
// (<= 8G) packed rows are valid; out: (m, Q), bf16 when out_bf16 != 0, else
// f32. nbit is 16, 32, 64 or 128; S is a multiple of 8 * (128 / nbit); bp is
// 16-byte aligned. Returns a cudaError_t.
int bitplane_mins_fwd(const void* q, const void* bp, long long G,
                      long long n_rows, int Q, int nbit, int S, long long m,
                      int out_bf16, void* out, void* stream) {
  const int8_t* qp = static_cast<const int8_t*>(q);
  const uint8_t* bpp = static_cast<const uint8_t*>(bp);
  float* of = out_bf16 ? nullptr : static_cast<float*>(out);
  __nv_bfloat16* ob = out_bf16 ? static_cast<__nv_bfloat16*>(out) : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nbit <= 0 || 128 % nbit || S <= 0 || S % (8 * (128 / nbit)) || Q <= 0 ||
      m <= 0 || n_rows < 0 || n_rows > 8 * G)
    return (int)cudaErrorInvalidValue;
  switch (nbit) {
    case 16: return (int)launch<16>(qp, bpp, n_rows, Q, S, m, of, ob, st);
    case 32: return (int)launch<32>(qp, bpp, n_rows, Q, S, m, of, ob, st);
    case 64: return (int)launch<64>(qp, bpp, n_rows, Q, S, m, of, ob, st);
    case 128: return (int)launch<128>(qp, bpp, n_rows, Q, S, m, of, ob, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
