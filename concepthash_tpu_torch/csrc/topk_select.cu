// Per-subblock minimum Hamming distance of sign codes, for exact top-k
// serving on Hopper (sm_90a).
//
// Replaces the Pallas kernels `_mins_kernel_packed` (via
// `subblock_min_dists_packed`) and `_mins_kernel` (via `subblock_min_dists`)
// of concepthash_tpu/ops/topk_select.py. The 128-lane packed gallery of the
// first is a row-major reshape of the same bytes as the (N, nbit) gallery of
// the second, so this one kernel serves both: it reads the gallery as N codes
// of nbit int8 values each.
//
// What it computes: q (Q, nbit) and the gallery (N, nbit) hold strict +-1
// int8 values. For subblock s (codes [s*S, (s+1)*S)) and query j,
//   out[s, j] = 0.5 * (nbit - max over the subblock's codes of <code, q_j>)
// with exact int32 similarities. Codes at or past N count as similarity
// -(nbit + 2), so a ragged tail subblock takes the max over its real codes
// and a subblock with no real code reads nbit + 1. The output is (m, Q), in
// bf16 (exact for nbit <= 128: every value is a half-integer <= 129) or f32.
//
// Design: one thread per query keeps that query's nbit/4 int32 words in
// registers; a block of 128 queries walks a run of subblocks, staging 256
// gallery codes at a time in shared memory, which every thread then reads as
// a broadcast. Each code costs nbit/4 __dp4a per query. The grid is 1-D with
// the query block varying fastest, so the blocks that share a gallery run are
// scheduled together and read it from L2.
//
// Bound on the H100: operations. For Q = 1024 queries over N = 2^20 codes of
// 64 bits, 2*Q*N*nbit = 137 G int8 operations take 69 us at 1,979 TOP/s on
// the tensor cores, while the 64 MiB gallery takes 20 us at 3.35 TB/s. This
// first version runs on the CUDA cores with __dp4a, whose rate is a small
// fraction of the int8 tensor-core rate; an IMMA (mma.sync s8) or wgmma form
// is work for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MINS_THREADS = 128;
constexpr int TILE_CODES = 256;
constexpr int CODES_PER_BLOCK = 2048;

template <int NW>  // 32-bit words per code: nbit / 4
__global__ void __launch_bounds__(MINS_THREADS)
subblock_mins_kernel(const int8_t* __restrict__ q,
                     const int8_t* __restrict__ db, long long N, int Q, int S,
                     long long m, int sb_per_block, int n_qblocks,
                     float* __restrict__ out_f32,
                     __nv_bfloat16* __restrict__ out_bf16) {
  constexpr int NBIT = NW * 4;
  constexpr int V4 = NW / 4;  // int4 vectors per code
  __shared__ int4 tile[TILE_CODES * V4];

  const long long qblock = blockIdx.x % n_qblocks;
  const long long gblock = blockIdx.x / n_qblocks;
  const int qi = (int)(qblock * MINS_THREADS) + threadIdx.x;

  int qw[NW];
  if (qi < Q) {
    const int4* qv = reinterpret_cast<const int4*>(q + (size_t)qi * NBIT);
#pragma unroll
    for (int v = 0; v < V4; ++v) {
      const int4 t = qv[v];
      qw[4 * v] = t.x;
      qw[4 * v + 1] = t.y;
      qw[4 * v + 2] = t.z;
      qw[4 * v + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int w = 0; w < NW; ++w) qw[w] = 0;
  }

  const long long sb0 = gblock * sb_per_block;
  const long long sb1 = sb0 + sb_per_block < m ? sb0 + sb_per_block : m;
  const long long c0 = sb0 * S;
  const long long c_end = sb1 * S < N ? sb1 * S : N;
  const int empty = -(NBIT + 2);

  int best = empty;
  int left = S;  // codes left in the current subblock
  long long sb = sb0;
  auto emit = [&](long long s, int v) {
    if (qi < Q) {
      const float d = 0.5f * (float)(NBIT - v);
      const size_t o = (size_t)s * Q + qi;
      if (out_f32)
        out_f32[o] = d;
      else
        out_bf16[o] = __float2bfloat16(d);
    }
  };

  for (long long t0 = c0; t0 < c_end; t0 += TILE_CODES) {
    const int nt = (int)(c_end - t0 < TILE_CODES ? c_end - t0 : TILE_CODES);
    __syncthreads();
    const int4* src = reinterpret_cast<const int4*>(db + (size_t)t0 * NBIT);
    for (int v = threadIdx.x; v < nt * V4; v += MINS_THREADS) tile[v] = src[v];
    __syncthreads();
    for (int c = 0; c < nt; ++c) {
      const int4* row = tile + c * V4;
      int s = 0;
#pragma unroll
      for (int v = 0; v < V4; ++v) {
        const int4 g = row[v];
        s = __dp4a(g.x, qw[4 * v], s);
        s = __dp4a(g.y, qw[4 * v + 1], s);
        s = __dp4a(g.z, qw[4 * v + 2], s);
        s = __dp4a(g.w, qw[4 * v + 3], s);
      }
      best = s > best ? s : best;
      if (--left == 0) {
        emit(sb++, best);
        best = empty;
        left = S;
      }
    }
  }
  // the ragged tail subblock, then subblocks with no real code
  for (; sb < sb1; ++sb) {
    emit(sb, best);
    best = empty;
  }
}

template <int NW>
cudaError_t launch(const int8_t* q, const int8_t* db, long long N, int Q,
                   int S, long long m, float* of, __nv_bfloat16* ob,
                   cudaStream_t st) {
  const int sb_per_block = S >= CODES_PER_BLOCK ? 1 : CODES_PER_BLOCK / S;
  const int n_qblocks = (Q + MINS_THREADS - 1) / MINS_THREADS;
  const long long n_gblocks = (m + sb_per_block - 1) / sb_per_block;
  const long long blocks = n_gblocks * n_qblocks;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  subblock_mins_kernel<NW><<<(unsigned)blocks, MINS_THREADS, 0, st>>>(
      q, db, N, Q, S, m, sb_per_block, n_qblocks, of, ob);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* subblock_mins_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: (Q, nbit) int8; db: N codes of nbit int8; out: (m, Q), bf16 when
// out_bf16 != 0, else f32. nbit is 16, 32, 64 or 128; both pointers are
// 16-byte aligned. Returns a cudaError_t.
int subblock_mins_fwd(const void* q, const void* db, long long N, int Q,
                      int nbit, int S, long long m, int out_bf16, void* out,
                      void* stream) {
  const int8_t* qp = static_cast<const int8_t*>(q);
  const int8_t* dp = static_cast<const int8_t*>(db);
  float* of = out_bf16 ? nullptr : static_cast<float*>(out);
  __nv_bfloat16* ob = out_bf16 ? static_cast<__nv_bfloat16*>(out) : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || Q <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  switch (nbit) {
    case 16: return (int)launch<4>(qp, dp, N, Q, S, m, of, ob, st);
    case 32: return (int)launch<8>(qp, dp, N, Q, S, m, of, ob, st);
    case 64: return (int)launch<16>(qp, dp, N, Q, S, m, of, ob, st);
    case 128: return (int)launch<32>(qp, dp, N, Q, S, m, of, ob, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
