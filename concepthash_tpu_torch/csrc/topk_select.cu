// Per-subblock minimum Hamming distance of sign codes, for exact top-k
// serving on Hopper (sm_90a), on the int8 tensor cores (wgmma).
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
//   mins[j, s] = 0.5 * (nbit - max over the subblock's codes of <code, q_j>)
// with exact int32 similarities. Codes at or past N count as similarity
// -(nbit + 2), so a ragged tail subblock takes the max over its real codes
// and a subblock with no real code reads nbit + 1. Output, in the layout the
// serving path selects from: mins (Q, m_pad), m_pad = m rounded up to a
// multiple of 64, columns m .. m_pad - 1 at nbit + 1; and, when asked, the
// superblock mins (Q, m_pad / 64), the least of each run of 64 subblocks.
// bf16 (exact: every value is an integer <= 129) or f32.
//
// Design: kernel 4's (csrc/bitplane_mins.cu) without its unpack; the wgmma,
// maxima and output helpers the two share are in csrc/mins_sm90.cuh.
// - Operands. The gallery is already a K-major (codes x nbit) int8 matrix,
//   the wgmma B operand as it stands. Stages of 1,024 codes (512 at nbit
//   128; TMA boxes of 256 rows, cp.async.bulk.tensor.2d) come into a ring
//   of up to 128 KB in shared memory, in the swizzle of the row width (32,
//   64 or 128 bytes for nbit 32, 64, 128); TMA zero-fills codes past N and
//   the last tile masks them. Each slot has a full mbarrier and a counter in
//   place of an empty barrier: the warpgroup that releases a stage last (an
//   atomicAdd that completes a multiple of two) loads the stage STAGES
//   further on into its slot, so no thread waits for a free slot and no
//   thread carries the others' loads. (A producer warp beside the
//   warpgroups puts five warps on one scheduler, and ptxas then caps a
//   thread at 96 registers and serialises the wgmmas, C7512; small stages
//   pay an mbarrier round trip every few tiles.) nbit 16 rows are 16 bytes,
//   below wgmma's k32: they land unswizzled, 8-code core matrices of 128
//   bytes side by side, and the queries' upper 16 bytes are zero, so the
//   descriptor's second k half (the next core matrix) adds nothing.
// - Products. Two warpgroups hold 128 queries each, as two m64 halves of
//   int8 A fragments in registers with an accumulator each (a thread holds
//   128 accumulators; 256 threads leave it 255 registers); each multiplies
//   every 128-code tile of every stage: wgmma m64n128k32 s8 -> s32, one k32
//   step per 32 bytes of code.
// - Maxima, as a tree of __vimax3_s32 over each thread's accumulator
//   columns (two per thread, half and tile where S is a multiple of 128;
//   four at S = 64, where a tile spans two subblocks), then folded, reduced
//   over the quad, into a shared (256 queries x 64 subblocks) table; where
//   S <= 128 each cell is written once, without a read. Over a whole stage
//   the two halves are pipelined: half 0's maxima of tile t run while half
//   1's products of tile t are in flight, and half 1's while half 0's of
//   tile t + 1 are, so the tensor cores and the maxima overlap inside a
//   warpgroup. That needs no branch between a wgmma's issue and its wait
//   (ptxas C7518) and no access to an accumulator that has a product in
//   flight (C7514): the unrolled tile loop, the unmasked tile_max and the
//   branch-free fold keep both. A partial stage (the gallery's end) and S
//   of other multiples of 8 (folded 8-code group by group) take one product
//   at a time.
// - Work. A unit is one superblock (64 subblocks, 64 S codes) for one tile
//   of 256 queries. Persistent blocks, one per SM, walk the units in steps
//   of the grid; the query tile varies fastest, so the tiles that read one
//   superblock run side by side and share it through L2. At the end of a unit
//   each warp writes 32 queries' 64 mins as contiguous rows of (Q, m_pad) and
//   their minimum into the superblock mins, and resets the table, while the
//   next unit's stages are already loading.
//
// Bound on the H100: bytes. For Q = 256 queries over N = 2^20 codes of 64
// bits the gallery (67.1 MB) and the bf16 mins (8.4 MB) take 22.5 us at
// 3.35 TB/s; the 2*Q*N*nbit = 34.4 G int8 operations 17.4 us at 1,979
// TOP/s. The maxima cost about one three-way max per two products of a
// query and a code; they overlap the other half's products.

#include "mins_sm90.cuh"

namespace {

using namespace mins_sm90;
using gemm_sm90::mbar_expect_tx;
using gemm_sm90::mbar_init;
using gemm_sm90::mbar_wait;
using gemm_sm90::named_bar_sync;
using gemm_sm90::tma_load;

constexpr int NWG = 2;                    // warpgroups
constexpr int QT = 128 * NWG;             // queries per unit
constexpr int THREADS = 128 * NWG;

template <int NBIT>
struct Geom {
  static constexpr int KS = NBIT < 32 ? 1 : NBIT / 32;   // k32 steps
  static constexpr int BOX = NBIT == 128 ? 128 : 256;     // codes per TMA box
  static constexpr int TC = NBIT == 128 ? 512 : 1024;     // codes per stage
  static constexpr int NTL = TC / NT;                     // tiles per stage
  static constexpr int STAGE = TC * NBIT;                 // bytes per stage
  static constexpr int STAGES = 128 * 1024 / STAGE < 4 ? 128 * 1024 / STAGE : 4;
  // shared memory from a 1 KB boundary: the ring, the maxima table, the
  // barriers and stage counters; and the slack to reach that boundary
  static constexpr int T_OFF = STAGES * STAGE;
  static constexpr int B_OFF = T_OFF + QT * MPITCH * 4;
  static constexpr int SMEM = B_OFF + STAGES * 16 + 1024;
};

// Descriptor of a 128-code B tile at addr: the swizzled K-major layout of
// the row width, or for nbit 16 the unswizzled one (layout 0), core
// matrices 128 bytes apart along the codes (SBO) and, for the second k half,
// along k (LBO).
template <int NBIT>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  if constexpr (NBIT == 16)
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
           ((uint64_t)(128 >> 4) << 32);
  else
    return smem_desc<NBIT>(addr);
}

// acc = the tile at desc times a warpgroup's 64 queries a; one commit group
template <int KS>
__device__ __forceinline__ void multiply(int (&acc)[64],
                                         const uint32_t (&a)[KS][4],
                                         uint64_t desc) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < KS; ++k) wgmma_s8(acc, a[k], desc + 2 * k, k);
  wgmma_commit();
}

// Where a stage of a block's walk lies: unit u (superblock u / n_qt), codes
// [c, min(c + TC, end)).
struct Pos {
  long long u, c, end;
};

// SPT: subblocks per 128-code tile where that is whole (1: S is a multiple
// of 128; 2: S = 64), or 0 for any other S that is a multiple of 8. ONCE:
// S <= 128, so each subblock lies in one tile and is folded once.
template <int NBIT, int SPT, bool ONCE>
__global__ void __launch_bounds__(THREADS, 1)
subblock_mins_kernel(const __grid_constant__ CUtensorMap tm,
                     const int8_t* __restrict__ q, long long N, int Q, int S,
                     long long m, long long m_pad, int n_qt, long long units,
                     void* out, void* msb, int out_bf16) {
  using Gm = Geom<NBIT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_1k(smem_raw);
  int* smins = reinterpret_cast<int*>(ring + Gm::T_OFF);   // QT x MPITCH
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Gm::B_OFF);
  int* released = reinterpret_cast<int*>(full + Gm::STAGES);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long span = (long long)SUB2 * S;              // codes per unit

  // the block's walk: units blockIdx.x, + gridDim.x, ..., TC codes a stage
  auto unit_at = [&](long long u) {
    const long long c0 = (u / n_qt) * span;
    return Pos{u, c0, c0 + span < N ? c0 + span : N};
  };
  auto next = [&](Pos& p) {
    p.c += Gm::TC;
    while (p.c >= p.end && p.u < units) {
      p.u += gridDim.x;
      if (p.u < units) p = unit_at(p.u);
    }
  };
  // stage p into ring slot s: boxes of BOX codes up to the stage's end (TMA
  // zero-fills past N); the slot's full barrier counts their bytes
  auto load = [&](int s, const Pos& p) {
    const long long nvc = p.end - p.c < Gm::TC ? p.end - p.c : Gm::TC;
    const int boxes = (int)((nvc + Gm::BOX - 1) / Gm::BOX);
    mbar_expect_tx(&full[s], boxes * Gm::BOX * NBIT);
    for (int b = 0; b < boxes; ++b)
      tma_load(ring + s * Gm::STAGE + b * Gm::BOX * NBIT, &tm, 0,
               (int)(p.c + b * Gm::BOX), &full[s]);
  };
  // the first stage of the walk, then (below) the one STAGES ahead of the
  // stage being read
  Pos ahead = unit_at(blockIdx.x);
  if (ahead.c >= ahead.end) {
    ahead.c -= Gm::TC;
    next(ahead);
  }

  for (int i = threadIdx.x; i < QT * MPITCH; i += THREADS) smins[i] = SENT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Gm::STAGES; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the first STAGES stages; afterwards the warpgroup that releases a stage
  // last loads the stage STAGES further on into its slot, so no thread ever
  // waits for a free slot
  for (int s = 0; s < Gm::STAGES; ++s) {
    if (threadIdx.x == 0 && ahead.u < units) load(s, ahead);
    next(ahead);
  }

  // warpgroup wg: queries 128 wg .. + 127, as two m64 halves h, each with
  // its own accumulator; the thread's rows in half h: row0 + 64 h and + 8
  const int wg = warp / 4;
  const int row0 = wg * 128 + (warp % 4) * 16 + lane / 4;
  const bool first = threadIdx.x % 128 == 0;
  int acc0[64], acc1[64];
  // the maxima of a tile (its first code cs) into the table, for the rows
  // from `row`
  auto fold_parts = [&](const int (&mx)[SPT > 0 ? SPT : 1][2], int row,
                        int cs) {
#pragma unroll
    for (int p = 0; p < SPT; ++p)
      fold<ONCE>(smins, row, cs / S + p, mx[p][0], mx[p][1]);
  };
  auto maxima = [&](const int (&acc)[64], int row, int cs, int valid) {
    if constexpr (SPT > 0) {
      int mx[SPT][2];
      tile_max<SPT>(acc, valid, lane, mx);
      fold_parts(mx, row, cs);
    } else {
      tile_fold_any(acc, smins, row, cs, S, valid, lane);
    }
  };
  int it = 0;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long sbb = u / n_qt;         // superblock
    const int qt0 = (int)(u % n_qt) * QT;
    uint32_t a0[Gm::KS][4], a1[Gm::KS][4];
    load_a<NBIT>(a0, q, Q, qt0 + row0, lane);
    load_a<NBIT>(a1, q, Q, qt0 + row0 + 64, lane);
    const Pos unit = unit_at(u);
    for (long long c = unit.c; c < unit.end; c += Gm::TC, ++it) {
      const int s = it % Gm::STAGES;
      mbar_wait(&full[s], (it / Gm::STAGES) & 1);
      const uint32_t base = smem_u32(ring + s * Gm::STAGE);
      const int cs = (int)(c - unit.c);     // the stage's first code
      const int nvc = (int)(unit.end - c < Gm::TC ? unit.end - c : Gm::TC);
      const bool piped = SPT > 0 && nvc == Gm::TC;
      if constexpr (SPT > 0) {
        if (piped) {
          // a whole stage, pipelined: half 0's maxima of tile t run while
          // half 1's products of tile t are in flight, and half 1's while
          // half 0's of tile t + 1 are; no branch between issue and wait
          multiply(acc0, a0, b_desc<NBIT>(base));
          multiply(acc1, a1, b_desc<NBIT>(base));
#pragma unroll
          for (int t = 0; t < Gm::NTL; ++t) {
            const uint64_t dn = b_desc<NBIT>(base + (t + 1) * NT * NBIT);
            // S = 64: the fold goes after the next issue; elsewhere that
            // order made ptxas serialise the wgmmas (C7518)
            constexpr bool EARLY = SPT == 2;
            int mx[SPT][2];
            wgmma_wait<1>();
            fence_regs(acc0);
            tile_max<SPT, false>(acc0, NT, lane, mx);
            if (!EARLY) fold_parts(mx, row0, cs + t * NT);
            if (t + 1 < Gm::NTL) multiply(acc0, a0, dn);
            if (EARLY) fold_parts(mx, row0, cs + t * NT);
            if (t + 1 < Gm::NTL)
              wgmma_wait<1>();
            else
              wgmma_wait<0>();
            fence_regs(acc1);
            tile_max<SPT, false>(acc1, NT, lane, mx);
            if (!EARLY) fold_parts(mx, row0 + 64, cs + t * NT);
            if (t + 1 < Gm::NTL) multiply(acc1, a1, dn);
            if (EARLY) fold_parts(mx, row0 + 64, cs + t * NT);
          }
        }
      }
      if (!piped) {
        // a partial stage (the gallery's end, or S below a stage) or any
        // other S: one product at a time, its maxima masked
        for (int t = 0; t * NT < nvc; ++t) {
          const uint64_t d = b_desc<NBIT>(base + t * NT * NBIT);
          multiply(acc0, a0, d);
          multiply(acc1, a1, d);
          wgmma_wait<0>();
          fence_regs(acc0);
          fence_regs(acc1);
          maxima(acc0, row0, cs + t * NT, nvc - t * NT);
          maxima(acc1, row0 + 64, cs + t * NT, nvc - t * NT);
        }
      }
      if (first) {
        __threadfence_block();
        if ((atomicAdd(&released[s], 1) + 1) % NWG == 0 && ahead.u < units)
          load(s, ahead);
        next(ahead);
      }
    }
    named_bar_sync(1, THREADS);             // the unit's maxima are in
    // distance 0.5 * (nbit - max <code, q>), exact: both terms share parity
    const auto dist = [](int, int v) { return (NBIT - v) >> 1; };
    if (out_bf16)
      write_mins<QT, THREADS / 32, true>(
          smins, dist, NBIT, warp, lane, qt0, Q, sbb, m, m_pad,
          static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(msb));
    else
      write_mins<QT, THREADS / 32, true>(
          smins, dist, NBIT, warp, lane, qt0, Q, sbb, m, m_pad,
          static_cast<float*>(out), static_cast<float*>(msb));
    named_bar_sync(1, THREADS);             // the table is reset
  }
}

// Tensor map of the gallery as (N, nbit) uint8, a box of BOX codes, the
// swizzle of the row width (none for 16-byte rows), zero fill past N.
template <int NBIT>
int encode_gallery(CUtensorMap* map, const int8_t* db, long long N) {
  gemm_sm90::EncodeTiled fn;
  if (int e = gemm_sm90::encode_fn(&fn)) return e;
  const cuuint64_t dims[2] = {(cuuint64_t)NBIT, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)NBIT};
  const cuuint32_t box[2] = {(cuuint32_t)NBIT, (cuuint32_t)Geom<NBIT>::BOX};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      NBIT == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : NBIT == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
      : NBIT == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                   : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<int8_t*>(db), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : gemm_sm90::TMAP_ERROR_BASE + (int)r;
}

template <int NBIT, int SPT, bool ONCE = false>
int launch(const int8_t* q, const int8_t* db, long long N, int Q, int S,
           long long m, void* out, void* msb, int out_bf16, cudaStream_t st) {
  CUtensorMap tm;
  if (int e = encode_gallery<NBIT>(&tm, db, N)) return e;
  constexpr int smem = Geom<NBIT>::SMEM;
  cudaError_t e = ensure_smem_limit(subblock_mins_kernel<NBIT, SPT, ONCE>,
                                    smem);
  if (e != cudaSuccess) return (int)e;
  int sms;
  if (int err = gemm_sm90::num_sms(&sms)) return err;
  const long long m_pad = (m + SUB2 - 1) / SUB2 * SUB2;
  const int n_qt = (Q + QT - 1) / QT;
  const long long units = m_pad / SUB2 * n_qt;
  const int grid = (int)(units < sms ? units : sms);
  subblock_mins_kernel<NBIT, SPT, ONCE><<<grid, THREADS, smem, st>>>(
      tm, q, N, Q, S, m, m_pad, n_qt, units, out, msb, out_bf16);
  return (int)cudaGetLastError();
}

template <int NBIT>
int dispatch(const int8_t* q, const int8_t* db, long long N, int Q, int S,
             long long m, void* out, void* msb, int out_bf16,
             cudaStream_t st) {
  if (S == NT)
    return launch<NBIT, 1, true>(q, db, N, Q, S, m, out, msb, out_bf16, st);
  if (S % NT == 0)
    return launch<NBIT, 1>(q, db, N, Q, S, m, out, msb, out_bf16, st);
  if (S == NT / 2)
    return launch<NBIT, 2, true>(q, db, N, Q, S, m, out, msb, out_bf16, st);
  return launch<NBIT, 0>(q, db, N, Q, S, m, out, msb, out_bf16, st);
}

}  // namespace

extern "C" {

const char* subblock_mins_error_string(int code) {
  return gemm_sm90::error_string(code);
}

// q: (Q, nbit) int8 +-1; db: N codes of nbit int8 +-1, row-major (plain or
// 128-lane packed); out: (Q, m_pad) mins, m_pad = m rounded up to a
// multiple of 64; msb: (Q, m_pad / 64) superblock mins, or null; both bf16
// when out_bf16 != 0, else f32. nbit is 16, 32, 64 or 128; S is a multiple
// of 8; m * S >= N; N < 2^31; q and db are 16-byte aligned. Returns 0, a
// cudaError_t, or 20000 + the CUresult of a failed tensor-map encode.
int subblock_mins_fwd(const void* q, const void* db, long long N, int Q,
                      int nbit, int S, long long m, int out_bf16, void* out,
                      void* msb, void* stream) {
  const int8_t* qp = static_cast<const int8_t*>(q);
  const int8_t* dp = static_cast<const int8_t*>(db);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Q <= 0 || N <= 0 || N >= (1LL << 31) || S <= 0 || S % 8 || m <= 0 ||
      m * S < N)
    return (int)cudaErrorInvalidValue;
  switch (nbit) {
    case 16: return dispatch<16>(qp, dp, N, Q, S, m, out, msb, out_bf16, st);
    case 32: return dispatch<32>(qp, dp, N, Q, S, m, out, msb, out_bf16, st);
    case 64: return dispatch<64>(qp, dp, N, Q, S, m, out, msb, out_bf16, st);
    case 128: return dispatch<128>(qp, dp, N, Q, S, m, out, msb, out_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
