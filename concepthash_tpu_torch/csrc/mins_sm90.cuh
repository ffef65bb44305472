// What the two subblock-min kernels of exact top-k serving share, for
// sm_90a: csrc/topk_select.cu (kernels 2 and 3, over the int8 +-1 gallery)
// and csrc/bitplane_mins.cu (kernel 4, over bit-planes unpacked in shared
// memory). Both multiply queries held as int8 A fragments in registers by
// 128-code tiles of a K-major int8 code matrix in shared memory on
// wgmma m64n128k32 s8 -> s32, take each query's maximum over each
// subblock's codes as a tree of three-way integer maxima, keep those maxima
// in a shared (queries x 64 subblocks) table, and write them as the serving
// layout: (Q, m_pad) mins, m_pad a multiple of a superblock's 64
// subblocks, and (Q, m_pad / 64) superblock mins.
//
// The accumulator layout of m64n128 (per thread: rows row and row + 8 of
// the warp's 16, codes 8j + 2 (lane % 4) + e of the tile, in register
// 4j + 2h + e for row + 8h) fixes which codes a thread sees: every group of
// 8 consecutive codes is spread over one quad. So a subblock S that is a
// multiple of 8 is a whole number of groups, and a quad reduction finishes
// each maximum.
//
// Two ptxas rules shape the callers: no thread-divergent branch while a
// wgmma is in flight (C7518, which serialises every wgmma), and no read of
// an accumulator while its warpgroup has a product in flight (C7514). So a
// caller issues a tile's products, waits for them, and only then takes the
// maxima; the overlap comes from other warpgroups.

#pragma once

#include "gemm_sm90.cuh"

namespace mins_sm90 {

using gemm_sm90::smem_u32;
using gemm_sm90::wgmma_commit;
using gemm_sm90::wgmma_fence;
using gemm_sm90::wgmma_wait;

constexpr int NT = 128;            // codes per wgmma tile (n128)
constexpr int SUB2 = 64;           // subblocks per superblock
constexpr int MPITCH = SUB2 + 1;   // row pitch of the shared maxima table
constexpr int SENT = -32768;       // "no valid code": below every
                                   // similarity, and fits in 16 bits

// The dynamic shared memory from its first 1 KB boundary (the swizzle
// atoms' alignment), found from the shared-window offset so that the
// compiler keeps the pointer in the shared space (shared loads and stores,
// not generic ones); callers reserve 1 KB of slack.
__device__ __forceinline__ unsigned char* smem_1k(unsigned char* smem_raw) {
  const uint32_t off = smem_u32(smem_raw);
  return smem_raw + ((1024 - (off & 1023)) & 1023);
}

// Byte offset of (row, 16-byte column chunk) in a K-major tile of KP-byte
// rows under the wgmma swizzle of that width (32, 64 or 128 bytes), which
// is also TMA's: the chunk index XOR bits 7.. of the offset. Tiles start on
// 1024 bytes.
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

// A fragments of a warp's 16 queries (r0: the thread's first query row, as
// row lane / 4 of the warp), k32 step s: a0 row r0, a1 row r0 + 8, bytes
// 4 (lane % 4) ..; a2, a3 the same 16 bytes further. Rows at or past Q and
// bytes at or past nbit are 0 (nbit 16 fills only the lower k16).
template <int NBIT, int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4],
                                       const int8_t* __restrict__ q, int Q,
                                       int r0, int lane) {
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (e & 1) * 8;
      const int k = s * 32 + (e >> 1) * 16 + (lane % 4) * 4;
      a[s][e] = (r < Q && k < NBIT) ? *reinterpret_cast<const uint32_t*>(
                                          q + (size_t)r * NBIT + k)
                                    : 0u;
    }
}

__device__ __forceinline__ void put(float* p, int v) { *p = (float)v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, int v) {
  *p = __float2bfloat16((float)v);
}

// Fold the maxima m0, m1 of a thread's two query rows (row, row + 8) over
// subblock sb into the table: reduced over the quad as the two 16-bit
// halves of one word (similarities and SENT fit in 16 bits). Each (row,
// subblock) cell has one owner quad, whose four lanes store the same value:
// no atomics, and no branch, so it may run while a wgmma is in flight.
// ONCE: this is the cell's only fold in the table's superblock (the subblock
// lies in one tile), so the cell is written without being read.
template <bool ONCE = false>
__device__ __forceinline__ void fold(int* smins, int row, int sb, int m0,
                                     int m1) {
  unsigned w = (unsigned)(m0 & 0xFFFF) | ((unsigned)m1 << 16);
  w = __vmaxs2(w, __shfl_xor_sync(0xffffffffu, w, 1));
  w = __vmaxs2(w, __shfl_xor_sync(0xffffffffu, w, 2));
  const int r0 = (int)(short)(w & 0xFFFF), r1 = (int)w >> 16;
  int* c0 = smins + row * MPITCH + sb;
  int* c1 = smins + (row + 8) * MPITCH + sb;
  *c0 = ONCE ? r0 : max(*c0, r0);
  *c1 = ONCE ? r1 : max(*c1, r1);
}

// The greatest of N (16 or 32) values as a tree of three-way maxima (depth
// 3-4, so the steps overlap instead of waiting on one running maximum).
template <int N>
__device__ __forceinline__ int max_tree(const int (&x)[N]) {
  static_assert(N == 16 || N == 32, "max_tree takes 16 or 32 values");
  int a[N / 4];
#pragma unroll
  for (int k = 0; k < N / 4; ++k)
    a[k] = __vimax3_s32(x[4 * k], x[4 * k + 1], max(x[4 * k + 2], x[4 * k + 3]));
  if constexpr (N == 32)
    return __vimax3_s32(__vimax3_s32(a[0], a[1], a[2]),
                        __vimax3_s32(a[3], a[4], a[5]), max(a[6], a[7]));
  else
    return __vimax3_s32(a[0], a[1], max(a[2], a[3]));
}

// The maxima over one 64 x 128 accumulator of a thread's two query rows,
// the tile cut into SPT equal parts (1: the tile lies in one subblock; 2:
// S = 64, two subblocks per tile): mx[p][h] is row + 8h's maximum over codes
// [p * NT / SPT, (p + 1) * NT / SPT) of the tile. Codes at or past `valid`
// are skipped; only a tile that ends the codes has valid < NT. MASK false:
// every code is valid, with no branch (for use while a wgmma is in flight).
template <int SPT, bool MASK = true>
__device__ __forceinline__ void tile_max(const int (&d)[64], int valid,
                                         int lane, int (&mx)[SPT][2]) {
  constexpr int J = NT / 8 / SPT;     // 8-code groups per part
#pragma unroll
  for (int p = 0; p < SPT; ++p) {
    int x0[2 * J], x1[2 * J];
    if (!MASK || valid >= NT) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int jj = p * J + j;
        x0[2 * j] = d[4 * jj];
        x0[2 * j + 1] = d[4 * jj + 1];
        x1[2 * j] = d[4 * jj + 2];
        x1[2 * j + 1] = d[4 * jj + 3];
      }
    } else {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int jj = p * J + j;
        const int c = 8 * jj + 2 * (lane % 4);
        x0[2 * j] = c < valid ? d[4 * jj] : SENT;
        x0[2 * j + 1] = c + 1 < valid ? d[4 * jj + 1] : SENT;
        x1[2 * j] = c < valid ? d[4 * jj + 2] : SENT;
        x1[2 * j + 1] = c + 1 < valid ? d[4 * jj + 3] : SENT;
      }
    }
    mx[p][0] = max_tree(x0);
    mx[p][1] = max_tree(x1);
  }
}

// The same for any S that is a multiple of 8: the tile's 8-code groups are
// folded into the table subblock by subblock (cs: the tile's first code,
// counted from the superblock's first).
__device__ __forceinline__ void tile_fold_any(const int (&d)[64], int* smins,
                                              int row, int cs, int S,
                                              int valid, int lane) {
  int sb = cs / S;
  int left = (S - cs % S) / 8;   // 8-code groups left in sb
  int m0 = SENT, m1 = SENT;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    if (left == 0) {
      fold(smins, row, sb, m0, m1);
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
  fold(smins, row, sb, m0, m1);
}

__device__ __forceinline__ void put2(float* p, int a, int b) {
  *reinterpret_cast<float2*>(p) = make_float2((float)a, (float)b);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, int a, int b) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __floats2bfloat162_rn((float)a, (float)b);
}

// Write superblock sbb's 64 subblocks for the QT queries from qt0: the
// distance dist(r, v) of table row r's maximum v, nbit + 1 where no valid
// code was seen or past m; one warp (of WARPS) per query row, a pair of
// subblocks per lane, stored together; then, when msb is not null, the
// row's minimum into the superblock mins. With RESET every table cell, of
// every row, is set back to SENT as it is read, ready for the caller's next
// superblock.
template <int QT, int WARPS, bool RESET, typename T, typename Dist>
__device__ __forceinline__ void write_mins(int* smins, const Dist& dist,
                                           int nbit, int warp, int lane,
                                           int qt0, int Q, long long sbb,
                                           long long m, long long m_pad,
                                           T* out, T* msb) {
  const int rows = RESET ? QT : min(QT, Q - qt0);
  const int i = 2 * lane;
  const long long sb = sbb * SUB2 + i;
#pragma unroll 4
  for (int r = warp; r < rows; r += WARPS) {
    const bool live = qt0 + r < Q;
    const size_t q = (size_t)(qt0 + r);
    int* cell = smins + r * MPITCH + i;
    const int v0 = cell[0], v1 = cell[1];
    if (RESET) cell[0] = cell[1] = SENT;
    const int d0 = (sb < m && v0 > SENT) ? dist(r, v0) : nbit + 1;
    const int d1 = (sb + 1 < m && v1 > SENT) ? dist(r, v1) : nbit + 1;
    if (live) put2(out + q * m_pad + sb, d0, d1);
    if (msb) {
      int best = min(d0, d1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        best = min(best, __shfl_xor_sync(0xffffffffu, best, o));
      if (live && lane == 0) put(msb + q * (m_pad / SUB2) + sbb, best);
    }
  }
}

}  // namespace mins_sm90
