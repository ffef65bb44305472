// Per-subblock minimum Hamming distance over a bit-plane gallery, for exact
// top-k serving on Hopper (sm_90a), on the int8 tensor cores (wgmma).
//
// Replaces the Pallas kernel `_mins_kernel_bitplane` (via
// `subblock_min_dists_bitplane`) of concepthash_tpu/ops/topk_select.py.
//
// What it computes: the gallery is (G, 128) uint8 bit-planes. Bit j of
// byte bp[g, l] is the sign bit of packed row r = 8g + j at lane l, and code
// c = r * P + p (P = 128 / nbit) holds lanes [p * nbit, (p + 1) * nbit) of
// its packed row. For subblock s (codes [s*S, (s+1)*S), S a multiple of 8P,
// so every byte row lies in one subblock) and query q,
//   mins[q, s] = min over the subblock's codes of popcount(code XOR query)
// which is the TPU kernel's 0.5 * (nbit - max <code, q>) for +-1 codes.
// Packed rows at or past n_rows count as distance nbit + 1, so a subblock
// with no valid row reads nbit + 1.
//
// Output, in the layout the serving path selects from: mins (Q, m_pad),
// m_pad = m rounded up to a multiple of 64, columns m .. m_pad - 1 at
// nbit + 1; and, when asked, the superblock mins (Q, m_pad / 64), the least
// of each run of 64 subblocks. bf16 (exact: every value is an integer
// <= 129) or f32.
//
// Arithmetic, as the TPU kernel's: with b the code's {0, 1} bits and q the
// query's +-1 signs, <2b - 1, q> = 2 <b, q> - sum(q), so
//   popcount(code XOR query) = pos(q) - <b, q>,   pos(q) = #{q > 0},
// and a subblock's min is pos(q) minus the max of <b, q> over its codes,
// exact in int32.
//
// Design: one block of four warpgroups owns one superblock (64 subblocks)
// for a tile of 256 queries, each warpgroup 64 of them, held as int8 A
// fragments in registers for the block's life. It walks the superblock's
// codes a chunk at a time (512 codes, 256 at nbit 128): each thread loads
// 16 bytes of planes and unpacks them into
// {0, 1} int8, (w >> j) & 0x01010101 per 4 lanes and plane j. An unpacked
// packed row of 128 lanes is P consecutive codes of nbit int8, so a chunk is
// a plain K-major (codes x nbit) matrix (nbit 16 rows are 32 wide, the
// queries' upper half zero), stored with the wgmma swizzle of its row width
// (32, 64 or 128 bytes). The products run on wgmma m64n128k32 s8 -> s32,
// queries as A from registers, 128 codes as B from shared memory: each
// warpgroup takes every 128-code tile of the chunk in turn, and takes the
// maxima of a finished product as a tree of three-way integer maxima
// (__vimax3_s32) while other warpgroups' products run. Nothing reads an
// accumulator while its warpgroup has a wgmma in flight: ptxas would
// serialise the wgmmas otherwise. Where S is a multiple of 128
// a tile lies in one subblock and its maxima wait in registers until the
// chunk's products are done; other S fold group by group. The maxima are
// reduced over the quad and kept in a shared (256, 64) table, each cell
// owned by one quad. Chunks are double-buffered: once a chunk's products
// are done, the next chunk (its planes loaded a chunk ahead) is unpacked
// into the other buffer. At the end each warp writes 16 queries' 64 mins as
// contiguous rows of (Q, m_pad) and their minimum into the superblock mins.
// The wgmma, maxima and output helpers are shared with kernels 2 and 3
// (csrc/topk_select.cu) through csrc/mins_sm90.cuh.
//
// Bound on the H100: operations. For Q = 256 queries over N = 10^8 codes of
// 64 bits the 2*Q*N*nbit int8 operations take 1.66 ms at 1,979 TOP/s (800 MB
// of planes: 0.24 ms at 3.35 TB/s). The unpack costs two integer operations
// per 4 code bits, shared by the 256 queries; the maxima one three-way max
// per two products of a query and a code.

#include "mins_sm90.cuh"

namespace {

using namespace mins_sm90;

constexpr int THREADS = 512;      // four warpgroups
constexpr int QT = 256;           // queries per block: one m64 tile each

template <int NBIT>
struct Geom {
  static constexpr int P = 128 / NBIT;              // codes per packed row
  static constexpr int KP = NBIT < 32 ? 32 : NBIT;  // int8 per code row
  static constexpr int KS = KP / 32;                // k32 steps
  static constexpr int CC = KP == 128 ? 256 : 512;  // codes per chunk
  static constexpr int BUF = CC * KP;               // bytes of one chunk
  static constexpr int CG = CC / (8 * P);           // byte rows per chunk
  static constexpr int RAW = (CG * 8 + THREADS - 1) / THREADS;  // uint4/thread
  // shared memory from a 1 KB boundary: two chunks, the mins table, pos(q);
  // and the slack to reach that boundary
  static constexpr int T_OFF = 2 * BUF;
  static constexpr int SMEM = T_OFF + QT * MPITCH * 4 + QT * 4 + 1024;
};

// The byte rows of the chunk at code c0 (a multiple of 8P): RAW 16-byte
// pieces per thread, piece u = byte row u / 8, lanes 16 (u % 8) .. + 15;
// rows at or past G read 0.
template <int NBIT>
__device__ __forceinline__ void load_raw(uint4 (&raw)[Geom<NBIT>::RAW],
                                         const uint8_t* __restrict__ bp,
                                         long long G, long long c0) {
  using Gm = Geom<NBIT>;
  const long long g0 = c0 / (8 * Gm::P);
#pragma unroll
  for (int i = 0; i < Gm::RAW; ++i) {
    const int u = threadIdx.x + i * THREADS;
    raw[i] = make_uint4(0, 0, 0, 0);
    if (u < Gm::CG * 8 && g0 + u / 8 < G)
      raw[i] = __ldg(reinterpret_cast<const uint4*>(
          bp + (size_t)(g0 + u / 8) * 128 + (u % 8) * 16));
  }
}

// Unpack the loaded pieces into {0, 1} int8 code rows of a chunk buffer;
// then make the writes visible to the tensor cores' (async proxy) reads.
template <int NBIT>
__device__ __forceinline__ void unpack(const uint4 (&raw)[Geom<NBIT>::RAW],
                                       unsigned char* buf) {
  using Gm = Geom<NBIT>;
#pragma unroll
  for (int i = 0; i < Gm::RAW; ++i) {
    const int u = threadIdx.x + i * THREADS;
    if (u >= Gm::CG * 8) continue;
    const int l0 = (u % 8) * 16;
    const int p = l0 / NBIT, chunk = (l0 % NBIT) / 16;
    const uint32_t w[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int code = ((u / 8) * 8 + j) * Gm::P + p;
      *reinterpret_cast<uint4*>(buf + swz<Gm::KP>(code, chunk)) =
          make_uint4((w[0] >> j) & 0x01010101u, (w[1] >> j) & 0x01010101u,
                     (w[2] >> j) & 0x01010101u, (w[3] >> j) & 0x01010101u);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// FAST: S is a multiple of the 128-code tile, so a tile lies in one
// subblock; otherwise a tile's maxima are folded group by group.
template <int NBIT, bool FAST, typename T>
__global__ void __launch_bounds__(THREADS, 1)
bitplane_mins_kernel(const int8_t* __restrict__ q,
                     const uint8_t* __restrict__ bp, long long G,
                     long long n_rows, int Q, int S, long long m,
                     long long m_pad, int n_qt, T* __restrict__ out,
                     T* __restrict__ msb) {
  using Gm = Geom<NBIT>;
  constexpr int NTL = Gm::CC / NT;            // tiles per chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_1k(smem_raw);
  unsigned char* bufs = smem;                 // 2 x CC x KP int8 {0, 1}
  int* smins = reinterpret_cast<int*>(smem + Gm::T_OFF);  // QT x MPITCH
  int* pos = smins + QT * MPITCH;             // QT

  // the query tile varies fastest, so the blocks that share a superblock's
  // planes read them from L2
  const long long sbb = blockIdx.x / n_qt;    // superblock
  const int qt0 = (int)(blockIdx.x % n_qt) * QT;
  const int lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128;           // warpgroup: queries 64 wg ..
  const int row0 = wg * 64 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;

  for (int i = threadIdx.x; i < QT * MPITCH; i += THREADS) smins[i] = SENT;
  uint32_t a[Gm::KS][4];
  load_a<NBIT>(a, q, Q, qt0 + row0, lane);
  if (threadIdx.x < QT) {
    // +1 bytes are 0x01, -1 bytes 0xFF: a word holds 4 - popc(w & 0x80808080)
    int n = 0;
    if (qt0 + (int)threadIdx.x < Q) {
      const uint4* qr = reinterpret_cast<const uint4*>(
          q + (size_t)(qt0 + threadIdx.x) * NBIT);
#pragma unroll
      for (int c = 0; c < NBIT / 16; ++c) {
        const uint4 v = qr[c];
        n += 16 - __popc(v.x & 0x80808080u) - __popc(v.y & 0x80808080u) -
             __popc(v.z & 0x80808080u) - __popc(v.w & 0x80808080u);
      }
    }
    pos[threadIdx.x] = n;
  }

  const long long c_begin = sbb * SUB2 * S;
  long long c_end = (sbb + 1) * SUB2 * S;
  if (c_end > m * S) c_end = m * S;
  if (c_end > n_rows * Gm::P) c_end = n_rows * Gm::P;

  uint4 raw[Gm::RAW];
  load_raw<NBIT>(raw, bp, G, c_begin);
  unpack<NBIT>(raw, bufs);
  load_raw<NBIT>(raw, bp, G, c_begin + Gm::CC);
  __syncthreads();

  int acc[64];
  int ci = 0;
  for (long long c0 = c_begin; c0 < c_end; c0 += Gm::CC, ++ci) {
    const uint32_t ba = smem_u32(bufs + (ci % 2) * Gm::BUF);
    const int cs0 = (int)(c0 - c_begin);      // the chunk's first code
    const int nvc = (int)(c_end - c0 < Gm::CC ? c_end - c0 : Gm::CC);
    const int ntiles = (nvc + NT - 1) / NT;
    auto multiply = [&](int (&acc)[64], int nt) {
      const uint64_t db = smem_desc<Gm::KP>(ba + nt * NT * Gm::KP);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < Gm::KS; ++s) wgmma_s8(acc, a[s], db + 2 * s, s);
      wgmma_commit();
    };
    if constexpr (FAST) {
      // a tile lies in one subblock: its maxima wait in registers until the
      // chunk's products are done, then are folded
      int mx[NTL][1][2];
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        if (nt < ntiles) {
          multiply(acc, nt);
          wgmma_wait<0>();
          fence_regs(acc);
          tile_max<1>(acc, nvc - nt * NT, lane, mx[nt]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
        if (nt < ntiles)
          fold(smins, row0, (cs0 + nt * NT) / S, mx[nt][0][0], mx[nt][0][1]);
    } else {
      for (int nt = 0; nt < ntiles; ++nt) {
        multiply(acc, nt);
        wgmma_wait<0>();
        fence_regs(acc);
        tile_fold_any(acc, smins, row0, cs0 + nt * NT, S, nvc - nt * NT,
                      lane);
      }
    }
    // the next chunk, unpacked once this one's products are done, and the
    // planes of the one after it
    unpack<NBIT>(raw, bufs + ((ci + 1) % 2) * Gm::BUF);
    load_raw<NBIT>(raw, bp, G, c0 + 2 * Gm::CC);
    __syncthreads();
  }
  // distance pos(q) - max <b, q>
  write_mins<QT, THREADS / 32, false>(
      smins, [pos](int r, int v) { return pos[r] - v; }, NBIT,
      threadIdx.x / 32, lane, qt0, Q, sbb, m, m_pad, out, msb);
}

template <int NBIT, typename T>
cudaError_t launch(const int8_t* q, const uint8_t* bp, long long G,
                   long long n_rows, int Q, int S, long long m, T* out,
                   T* msb, cudaStream_t st) {
  constexpr int smem = Geom<NBIT>::SMEM;
  auto kernel = S % NT == 0 ? bitplane_mins_kernel<NBIT, true, T>
                            : bitplane_mins_kernel<NBIT, false, T>;
  cudaError_t e = ensure_smem_limit(kernel, smem);
  if (e != cudaSuccess) return e;
  const long long m_pad = (m + SUB2 - 1) / SUB2 * SUB2;
  const int n_qt = (Q + QT - 1) / QT;
  const long long blocks = m_pad / SUB2 * n_qt;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, THREADS, smem, st>>>(q, bp, G, n_rows, Q, S, m,
                                                  m_pad, n_qt, out, msb);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const int8_t* q, const uint8_t* bp, long long G, long long n_rows,
             int Q, int nbit, int S, long long m, T* out, T* msb,
             cudaStream_t st) {
  switch (nbit) {
    case 16: return (int)launch<16, T>(q, bp, G, n_rows, Q, S, m, out, msb, st);
    case 32: return (int)launch<32, T>(q, bp, G, n_rows, Q, S, m, out, msb, st);
    case 64: return (int)launch<64, T>(q, bp, G, n_rows, Q, S, m, out, msb, st);
    case 128: return (int)launch<128, T>(q, bp, G, n_rows, Q, S, m, out, msb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* bitplane_mins_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: (Q, nbit) int8 +-1; bp: (G, 128) uint8 bit-planes; the first n_rows
// (<= 8G) packed rows are valid. out: (Q, m_pad) mins, m_pad = m rounded up
// to a multiple of 64; msb: (Q, m_pad / 64) superblock mins, or null; both
// bf16 when out_bf16 != 0, else f32. nbit is 16, 32, 64 or 128; S is a
// multiple of 8 * (128 / nbit); m * S covers the stored codes; q and bp are
// 16-byte aligned. Returns a cudaError_t.
int bitplane_mins_fwd(const void* q, const void* bp, long long G,
                      long long n_rows, int Q, int nbit, int S, long long m,
                      int out_bf16, void* out, void* msb, void* stream) {
  const int8_t* qp = static_cast<const int8_t*>(q);
  const uint8_t* bpp = static_cast<const uint8_t*>(bp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nbit <= 0 || 128 % nbit || S <= 0 || S % (8 * (128 / nbit)) || Q <= 0 ||
      m <= 0 || n_rows < 0 || n_rows > 8 * G ||
      m * S < 8 * G * (128 / nbit))
    return (int)cudaErrorInvalidValue;
  if (out_bf16)
    return dispatch<__nv_bfloat16>(qp, bpp, G, n_rows, Q, nbit, S, m,
                                   static_cast<__nv_bfloat16*>(out),
                                   static_cast<__nv_bfloat16*>(msb), st);
  return dispatch<float>(qp, bpp, G, n_rows, Q, nbit, S, m,
                         static_cast<float*>(out), static_cast<float*>(msb),
                         st);
}

}  // extern "C"
