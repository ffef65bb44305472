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
//
// Bound on the H100: operations. For Q = 256 queries over N = 10^8 codes of
// 64 bits the 2*Q*N*nbit int8 operations take 1.66 ms at 1,979 TOP/s (800 MB
// of planes: 0.24 ms at 3.35 TB/s). The unpack costs two integer operations
// per 4 code bits, shared by the 256 queries; the maxima one three-way max
// per two products of a query and a code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;      // four warpgroups
constexpr int QT = 256;           // queries per block: one m64 tile each
constexpr int NT = 128;           // codes per wgmma tile
constexpr int SUB2 = 64;          // subblocks per block (a superblock)
constexpr int MPITCH = SUB2 + 1;  // row pitch of the shared mins table
constexpr int SENT = -(1 << 20);  // "no valid code" in that table

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row, 16-byte column chunk) in a K-major tile of KP-byte
// rows under the wgmma swizzle of that width (32, 64 or 128 bytes): the
// chunk index XOR bits 7.. of the offset. Tiles start on 1024 bytes.
template <int KP>
__device__ __forceinline__ int swz(int row, int chunk) {
  const int off = row * KP + chunk * 16;
  return off ^ (((off >> 7) & (KP / 16 - 1)) << 4);
}

// Shared-memory matrix descriptor of such a tile: 8-row groups 8 * KP bytes
// apart (SBO), swizzle mode 1 / 2 / 3 for 128 / 64 / 32 bytes. A k32 step
// inside a row adds 32 bytes (2 in 16-byte units) to the address.
template <int KP>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t mode = KP == 128 ? 1 : KP == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * KP) >> 4) << 32) | (mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator accesses across a wgmma fence
// or wait.
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= a (64 x 32, registers: warp w of the warpgroup holds rows 16w ..,
// as mma.sync m16n8k32's A) * b (128 codes x 32, K-major, shared memory),
// s8 in, s32 accumulate; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

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

__device__ __forceinline__ void put(float* p, int v) { *p = (float)v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, int v) {
  *p = __float2bfloat16((float)v);
}

// Fold the maxima m0, m1 of a thread's two query rows (row, row + 8) over
// subblock sb into the table: reduced over the quad, then kept by its first
// lane. Each (row, subblock) cell has one owner quad, so no atomics.
__device__ __forceinline__ void fold(int* smins, int row, int sb, int m0,
                                     int m1, int lane) {
  m0 = max(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = max(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = max(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = max(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  if (lane % 4 == 0) {
    int* c0 = smins + row * MPITCH + sb;
    int* c1 = smins + (row + 8) * MPITCH + sb;
    *c0 = max(*c0, m0);
    *c1 = max(*c1, m1);
  }
}

// The least of 32 values as a tree of three-way maxima (depth 4, so the
// steps overlap instead of waiting on one running maximum).
__device__ __forceinline__ int max32(const int (&x)[32]) {
  int a[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    a[k] = __vimax3_s32(x[4 * k], x[4 * k + 1], max(x[4 * k + 2], x[4 * k + 3]));
  return __vimax3_s32(__vimax3_s32(a[0], a[1], a[2]),
                      __vimax3_s32(a[3], a[4], a[5]), max(a[6], a[7]));
}

// The maxima over the codes of one 64 x 128 accumulator of a thread's two
// query rows: reg 4j + 2h + e is row + 8h, code 8j + 2(lane % 4) + e of the
// tile; codes at or past `valid` are skipped.
__device__ __forceinline__ void tile_max(const int (&d)[64], int valid,
                                        int lane, int& m0, int& m1) {
  int x0[32], x1[32];
  if (valid >= NT) {
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      x0[2 * j] = d[4 * j];
      x0[2 * j + 1] = d[4 * j + 1];
      x1[2 * j] = d[4 * j + 2];
      x1[2 * j + 1] = d[4 * j + 3];
    }
  } else {
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      x0[2 * j] = c < valid ? d[4 * j] : SENT;
      x0[2 * j + 1] = c + 1 < valid ? d[4 * j + 1] : SENT;
      x1[2 * j] = c < valid ? d[4 * j + 2] : SENT;
      x1[2 * j + 1] = c + 1 < valid ? d[4 * j + 3] : SENT;
    }
  }
  m0 = max32(x0);
  m1 = max32(x1);
}

// The same for a subblock S that is not a multiple of the tile: the tile's
// 8-code groups are folded subblock by subblock (cs: the tile's first code,
// counted from the block's first; 8 divides S).
__device__ __forceinline__ void tile_fold_any(const int (&d)[64], int* smins,
                                              int row, int cs, int S,
                                              int valid, int lane) {
  int sb = cs / S;
  int left = (S - cs % S) / 8;   // 8-code groups left in sb
  int m0 = SENT, m1 = SENT;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    if (left == 0) {
      fold(smins, row, sb, m0, m1, lane);
      ++sb;
      left = S / 8;
      m0 = m1 = SENT;
    }
    --left;
    const int c = 8 * j + 2 * (lane % 4);
    m0 = __vimax3_s32(m0, c < valid ? d[4 * j] : SENT,
                      c + 1 < valid ? d[4 * j + 1] : SENT);
    m1 = __vimax3_s32(m1, c < valid ? d[4 * j + 2] : SENT,
                      c + 1 < valid ? d[4 * j + 3] : SENT);
  }
  fold(smins, row, sb, m0, m1, lane);
}

// The block's 64 subblocks for its queries: distance pos(q) - max <b, q>,
// nbit + 1 where no valid code was seen or past m; one warp per query row,
// two subblocks per lane, then the row's minimum.
template <typename T>
__device__ __forceinline__ void write_mins(const int* smins, const int* pos,
                                           int nbit, int qt0, int Q,
                                           long long sbb, long long m,
                                           long long m_pad, T* out, T* msb) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < QT && qt0 + r < Q; r += THREADS / 32) {
    const size_t q = (size_t)(qt0 + r);
    int best = nbit + 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + 32 * h;
      const long long sb = sbb * SUB2 + i;
      const int v = smins[r * MPITCH + i];
      const int d = (sb < m && v > SENT) ? pos[r] - v : nbit + 1;
      best = min(best, d);
      put(out + q * m_pad + sb, d);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      best = min(best, __shfl_xor_sync(0xffffffffu, best, o));
    if (msb && lane == 0) put(msb + q * (m_pad / SUB2) + sbb, best);
  }
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
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
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
  // A fragments of the warp's 16 queries, k32 step s: a0 row lane/4, a1
  // row +8, bytes 4 (lane % 4) ..; a2, a3 the same 16 bytes further
  uint32_t a[Gm::KS][4];
#pragma unroll
  for (int s = 0; s < Gm::KS; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = qt0 + row0 + (e & 1) * 8;
      const int k = s * 32 + (e >> 1) * 16 + (lane % 4) * 4;
      a[s][e] = (r < Q && k < NBIT) ? *reinterpret_cast<const uint32_t*>(
                                          q + (size_t)r * NBIT + k)
                                    : 0u;
    }
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
      int mx[NTL][2];
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        if (nt < ntiles) {
          multiply(acc, nt);
          wgmma_wait<0>();
          fence_regs(acc);
          tile_max(acc, nvc - nt * NT, lane, mx[nt][0], mx[nt][1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
        if (nt < ntiles)
          fold(smins, row0, (cs0 + nt * NT) / S, mx[nt][0], mx[nt][1], lane);
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
  write_mins<T>(smins, pos, NBIT, qt0, Q, sbb, m, m_pad, out, msb);
}

template <int NBIT, typename T>
cudaError_t launch(const int8_t* q, const uint8_t* bp, long long G,
                   long long n_rows, int Q, int S, long long m, T* out,
                   T* msb, cudaStream_t st) {
  constexpr int smem = Geom<NBIT>::SMEM;
  auto kernel = S % NT == 0 ? bitplane_mins_kernel<NBIT, true, T>
                            : bitplane_mins_kernel<NBIT, false, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
