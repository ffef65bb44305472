// The Hopper GEMM core of the port's encoder-layer and LayerNorm -> matmul
// kernels (csrc/fused_layer.cu, csrc/fused_ln.cu), for sm_90a.
//
//   C[m, n] = sum_k A[m, k] * W[n, k],   then a fused epilogue
//
// A: (M, K) bf16 row-major, W: (N, K) bf16 row-major (torch Linear layout):
// both operands are K-major, the plain "TN" case of wgmma, no transpose.
// Any M and N; K % 8 == 0 (TMA's 16-byte row-stride rule).
//
// Design:
// - Loads: TMA (cp.async.bulk.tensor.2d) brings BM x 64 A tiles and BN x 64
//   W tiles (64 bf16 = 128 bytes of K, the 128-byte swizzle) into a ring of
//   3-4 stages in shared memory (as many as fit). Each stage has a full and
//   an empty mbarrier. TMA zero-fills the ragged M, N and K edges, so the
//   tiles need no masks and the products of the padding are zero. A wait on
//   an mbarrier that outlasts about 10 s traps, so a fault in the protocol
//   fails the launch instead of hanging the card.
// - Warps: 384 threads. Warpgroup 2 is the producer: its first thread keeps
//   the ring's loads in flight, and the warpgroup turns its registers down
//   to 40 with setmaxnreg. Warpgroups 0 and 1 are consumers and take 232
//   registers each (the kernel compiles to 168 a thread at 384 threads, so
//   the 128 x 128 freed by the producer are exactly the 2 x 128 x 64 the
//   consumers ask for).
// - Ping-pong: consumer warpgroup w takes its block's tiles w, w + 2, ...
//   whole, BM x BN as BM / 64 m64 halves (BM * BN / 128 f32 accumulators a
//   thread), so one warpgroup's epilogue overlaps the other's products.
//   The mainloops take turns (two "turn" mbarriers), which keeps every wait
//   on a stage barrier within one phase of it.
// - Products: wgmma.mma_async m64nBNk16 bf16 -> f32 from shared-memory
//   descriptors. One wgmma group stays in flight while the next stage's is
//   issued; a stage is released when the group that read it has retired.
// - Persistent blocks: one block per SM (grid = min(tiles, SMs)) walks the
//   tiles in steps of the grid; the producer loads ahead across tiles.
// - Tiles: plain products take 128 x 128, or 128 x 64 where that fills the
//   SMs' waves better (N = 384 at M = 13,824: 324 tiles of 128 leave 82% of
//   the last wave busy, 648 tiles of 64 fill it); products with the
//   LayerNorm prologue take 64 x 256 (below). The host picks per product.
// - LayerNorm prologue (optional, LnPrologue): A is the raw x; a row-statistics
//   pass has already written each row's (mu, rstd) once. The consumer that
//   owns a tile normalises each landed x stage in place in the swizzled
//   shared tile, bf16(((x - mu) * rstd) * g + b) in f32, then a proxy fence
//   and a warpgroup barrier, and feeds wgmma from shared memory; stage s + 1
//   is normalised while stage s's products run. In place rather than as
//   register A fragments: with A in registers the fragments of a stage must
//   stay untouched until its wgmma group retires, which forced a full wait
//   after every stage; in place keeps one group in flight, like the plain
//   path. Every column tile normalises its A stages again, so the prologue
//   takes 64 x 256 tiles: half the normalising per product of 128 x 128.
//   The normalised tensor never reaches device memory.
// - Epilogue, through a shared staging tile so that every global access of
//   a warp is one contiguous run: bias -> activation -> scale -> add_f32 ->
//   bf16 resid -> f32 or bf16 store, masking the ragged M and N edges (see
//   epilogue_tile for why its code is kept small).
// - Tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
//   reached through cudaGetDriverEntryPoint, so nothing links -lcuda) and
//   passed as __grid_constant__ parameters. A failed encode returns
//   TMAP_ERROR_BASE + its CUresult, which error_string() names.
// Bias, add_f32, resid and the outputs are 16-byte aligned.
//
// Bound on the H100: operations for every product of the encoder layer
// (989 TFLOP/s bf16 dense). What keeps this core below it: the epilogue of
// the last tile of a block and the turn hand-over, the f32 traffic of the
// epilogues that read and write the layer's f32 stream (K = 384 and 768 leave
// them little mainloop to hide behind), and in the LayerNorm prologue the
// normalisation of every A stage once per column tile (N / BN times).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace gemm_sm90 {

typedef __nv_bfloat16 bf16;

constexpr int BK = 64;            // bf16 of K per stage: one 128-byte swizzle row
constexpr int THREADS = 384;
constexpr int TMAP_ERROR_BASE = 20000;

enum Act { ACT_NONE = 0, ACT_QUICK_GELU = 1, ACT_GELU = 2 };

// quick_gelu takes the fast exp and divide (relative error about 1e-6,
// far below the bf16 rounding that follows); GELU keeps CUDA's erff
__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == ACT_QUICK_GELU) return __fdividef(v, 1.0f + __expf(-1.702f * v));
  if (act == ACT_GELU) return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  return v;
}

struct Epilogue {
  const float* bias;     // (N,) or null
  int act;               // Act
  const float* scale;    // (1,) device scalar or null
  const float* add_f32;  // (M, N) f32 added after the scale, or null
  const bf16* resid;     // (M, N) bf16 added last, or null
  float* out_f32;        // exactly one of out_f32 / out_bf16 is set
  bf16* out_bf16;
};

struct LnPrologue {
  const float* stats;    // (M, 2): mu, rstd of each row of A
  const float* g;        // (K,) f32
  const float* b;        // (K,) f32
};

// ---------------------------------------------------------------------------
// PTX wrappers: shared-memory addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Spin until the phase of parity `parity` has completed. A wait that runs
// past about 10 s of clocks traps, so a wrong phase or byte count fails the
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  for (int tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == 0) t0 = clock64();
    else if (clock64() - t0 > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// 2-D tile load: box at (inner coordinate c0, outer coordinate c1).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
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
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO),
// layout type 1 (B128). The tile starts on a 1024-byte boundary; a k16 step
// inside the 64-wide row adds 32 bytes (2 in 16-byte units) to the address.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// m64n64k16, A and W from shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_w, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_w), "r"(scale_d));
}


// m64n128k16, A and W from shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_w, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_w), "r"(scale_d));
}


// m64n256k16, A and W from shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t desc_a, uint64_t desc_w, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_w), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// bias -> activation -> scale of one element: the part of the epilogue that
// needs no other tensor
__device__ __forceinline__ float pointwise(const Epilogue& ep, float v,
                                           float bias) {
  if (ep.bias) v += bias;
  v = apply_act(v, ep.act);
  if (ep.scale) v *= ep.scale[0];
  return v;
}

// The same over one thread's PASSES float4s of the staging tile (stride
// apart), with the activation fixed at compile time, so the loop body holds
// one activation's code only.
template <int PASSES, int ACT>
__device__ __forceinline__ void pointwise_pass(const Epilogue& ep, float* v0,
                                               int stride, float4 b) {
  const float sc = ep.scale ? ep.scale[0] : 1.0f;
  const bool has_b = ep.bias != nullptr, has_s = ep.scale != nullptr;
  auto one = [&](float v, float bb) {
    if (has_b) v += bb;
    v = apply_act(v, ACT);
    return has_s ? v * sc : v;
  };
#pragma unroll 4
  for (int p = 0; p < PASSES; ++p) {
    float4* q = reinterpret_cast<float4*>(v0 + p * stride);
    float4 v = *q;
    v.x = one(v.x, b.x);
    v.y = one(v.y, b.y);
    v.z = one(v.z, b.z);
    v.w = one(v.w, b.w);
    *q = v;
  }
}

// A tile of BM x BN (BM = 64 or 128 rows, as BM / 64 m64 halves) is one
// warpgroup's. The epilogue walks it in 64 x EN blocks through an f32
// staging tile per warpgroup; 8 floats of row padding keep the fragment
// writes free of bank conflicts.
template <int BM, int BN>
__host__ __device__ constexpr int stage_bytes() {
  return (BM + BN) * BK * 2;
}

template <int BN>
__host__ __device__ constexpr int epi_cols() {
  return BN < 128 ? BN : 128;
}

template <int BN>
__host__ __device__ constexpr int epi_pitch() {
  return epi_cols<BN>() + 8;
}

// as many ring stages as fit beside the staging tiles, at most 4
template <int BM, int BN>
__host__ __device__ constexpr int stages() {
  return (4 * stage_bytes<BM, BN>() + 2 * 64 * epi_pitch<BN>() * 4 + 2048 <=
          232448) ? 4 : 3;
}

template <int BM, int BN>
__host__ __device__ constexpr int smem_bytes() {
  // the ring, two staging tiles, its mbarriers, and slack to align the ring
  // to 1 KB
  return stages<BM, BN>() * stage_bytes<BM, BN>() +
         2 * 64 * epi_pitch<BN>() * 4 + (2 * stages<BM, BN>() + 2) * 8 + 1024;
}

// The epilogue of columns [cb EN, cb EN + EN) of one warpgroup's 64 x BN
// accumulator (EN = min(BN, 128)), at rows m0w.., columns n0..:
// the accumulator fragments go to the staging tile, then each thread takes
// four consecutive columns of one row at a time, so every load and store of
// a warp is one contiguous run. Where there is an activation,
// bias -> activation -> scale run first, in place, in a loop unrolled only
// 4 times: fully unrolled, the inlined expf/erff of 64 elements made an
// epilogue of some 100 KB of code whose instruction-cache misses cost more
// than the products. Then (bias,) add_f32 and resid, loaded before anything
// is stored (add_f32 may be the output itself), and the store.
template <int BN>
__device__ __forceinline__ void epilogue_tile(const Epilogue& ep, int M,
                                              int N, int m0w, int n0,
                                              float* tile,
                                              const float (&acc)[BN / 2],
                                              int cb, int t, int bar_id) {
  constexpr int EN = epi_cols<BN>();   // columns of the block, cb-th of BN/EN
  constexpr int P = epi_pitch<BN>();
  constexpr int TPR = EN / 4;          // threads per row
  constexpr int RPP = 128 / TPR;       // rows per pass
  constexpr int PASSES = 64 / RPP;
  const int lane = t % 32;
  const int r_in = (t / 32) * 16 + lane / 4;
  // accumulator fragment: reg 4j + 2h + e is row r_in + 8h, column
  // 8j + 2(lane%4) + e of the 64 x BN accumulator
#pragma unroll
  for (int j = 0; j < EN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    const int r = cb * EN / 2 + 4 * j;
    *reinterpret_cast<float2*>(tile + r_in * P + c) =
        make_float2(acc[r], acc[r + 1]);
    *reinterpret_cast<float2*>(tile + (r_in + 8) * P + c) =
        make_float2(acc[r + 2], acc[r + 3]);
  }
  named_bar_sync(bar_id, 128);
  const int c4 = (t % TPR) * 4;
  const int r0 = t / TPR;
  const int gn = n0 + c4;
  if (N % 4 == 0) {
    // rows start 16-byte aligned: four columns are one vector access
    if (gn < N) {
      const float4 b = ep.bias ? *reinterpret_cast<const float4*>(ep.bias + gn)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      // with no activation, bias and scale join the store loop
      const bool in_place = ep.act != ACT_NONE;
      const float sc = ep.scale ? ep.scale[0] : 1.0f;
      if (ep.act == ACT_QUICK_GELU)
        pointwise_pass<PASSES, ACT_QUICK_GELU>(ep, tile + r0 * P + c4, RPP * P, b);
      else if (ep.act == ACT_GELU)
        pointwise_pass<PASSES, ACT_GELU>(ep, tile + r0 * P + c4, RPP * P, b);
      float4 add[PASSES];
      uint2 res[PASSES];
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        add[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        res[p] = make_uint2(0, 0);
        const int gm = m0w + r0 + p * RPP;
        if (gm < M) {
          const size_t o = (size_t)gm * N + gn;
          if (ep.add_f32) add[p] = *reinterpret_cast<const float4*>(ep.add_f32 + o);
          if (ep.resid) res[p] = *reinterpret_cast<const uint2*>(ep.resid + o);
        }
      }
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const int gm = m0w + r0 + p * RPP;
        if (gm >= M) continue;
        const size_t o = (size_t)gm * N + gn;
        float4 v = *reinterpret_cast<const float4*>(tile + (r0 + p * RPP) * P + c4);
        if (!in_place && ep.bias) {
          v.x += b.x;
          v.y += b.y;
          v.z += b.z;
          v.w += b.w;
        }
        if (!in_place && ep.scale) {
          v.x *= sc;
          v.y *= sc;
          v.z *= sc;
          v.w *= sc;
        }
        if (ep.add_f32) {
          v.x = add[p].x + v.x;
          v.y = add[p].y + v.y;
          v.z = add[p].z + v.z;
          v.w = add[p].w + v.w;
        }
        if (ep.resid) {
          v.x = bf16_lo(res[p].x) + v.x;
          v.y = bf16_hi(res[p].x) + v.y;
          v.z = bf16_lo(res[p].y) + v.z;
          v.w = bf16_hi(res[p].y) + v.w;
        }
        if (ep.out_f32)
          *reinterpret_cast<float4*>(ep.out_f32 + o) = v;
        else
          *reinterpret_cast<uint2*>(ep.out_bf16 + o) =
              make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
      }
    }
  } else {
#pragma unroll 1
    for (int p = 0; p < PASSES; ++p) {
      const int gm = m0w + r0 + p * RPP;
      if (gm >= M) continue;
#pragma unroll 1
      for (int e = 0; e < 4 && gn + e < N; ++e) {
        const size_t o = (size_t)gm * N + gn + e;
        float y = pointwise(ep, tile[(r0 + p * RPP) * P + c4 + e],
                            ep.bias ? ep.bias[gn + e] : 0.0f);
        if (ep.add_f32) y = ep.add_f32[o] + y;
        if (ep.resid) y = __bfloat162float(ep.resid[o]) + y;
        if (ep.out_f32)
          ep.out_f32[o] = y;
        else
          ep.out_bf16[o] = __float2bfloat16(y);
      }
    }
  }
  named_bar_sync(bar_id, 128);         // the tile is free for the next block
}

// LayerNorm prologue. Thread t (< 128) of the warpgroup that owns a tile
// normalises the 16-byte chunks t + 128i (i < BM / 16) of a raw BM-row x
// stage in place: row t/8 + 16i, physical chunk t % 8, which holds logical
// chunk (t % 8) ^ (row % 8) of the 128-byte swizzle; row % 8 is (t/8) % 8 for
// every i, so all its chunks sit at the same k, and one thread needs the 8
// gamma and beta values at that k per stage, loaded a stage ahead.
struct LnChunk {
  float4 g0, g1, b0, b1;
};

__device__ __forceinline__ LnChunk ln_chunk(const LnPrologue& ln, int k0,
                                            int K, int t) {
  const int k = k0 + 8 * ((t % 8) ^ ((t / 8) % 8));
  LnChunk c;
  c.g0 = c.g1 = c.b0 = c.b1 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (k < K) {                         // K % 8 == 0: the chunk is all in or out
    c.g0 = *reinterpret_cast<const float4*>(ln.g + k);
    c.g1 = *reinterpret_cast<const float4*>(ln.g + k + 4);
    c.b0 = *reinterpret_cast<const float4*>(ln.b + k);
    c.b1 = *reinterpret_cast<const float4*>(ln.b + k + 4);
  }
  return c;
}

template <int R>
__device__ __forceinline__ void normalise_stage(uint8_t* a_tile,
                                                const LnChunk& c,
                                                const float (&mu)[R],
                                                const float (&rs)[R], int t) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    uint4* p = reinterpret_cast<uint4*>(a_tile + (t / 8 + 16 * i) * 128 +
                                        (t % 8) * 16);
    const uint4 raw = *p;
    const float m = mu[i], s = rs[i];
    uint4 out;
    out.x = pack_bf16(((bf16_lo(raw.x) - m) * s) * c.g0.x + c.b0.x,
                      ((bf16_hi(raw.x) - m) * s) * c.g0.y + c.b0.y);
    out.y = pack_bf16(((bf16_lo(raw.y) - m) * s) * c.g0.z + c.b0.z,
                      ((bf16_hi(raw.y) - m) * s) * c.g0.w + c.b0.w);
    out.z = pack_bf16(((bf16_lo(raw.z) - m) * s) * c.g1.x + c.b1.x,
                      ((bf16_hi(raw.z) - m) * s) * c.g1.y + c.b1.y);
    out.w = pack_bf16(((bf16_lo(raw.w) - m) * s) * c.g1.z + c.b1.z,
                      ((bf16_hi(raw.w) - m) * s) * c.g1.w + c.b1.w);
    *p = out;
  }
}

template <int BM, int BN, bool LN>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tmA,
            const __grid_constant__ CUtensorMap tmW, int M, int N, int K,
            Epilogue ep, LnPrologue ln) {
  constexpr int STAGES = stages<BM, BN>();
  constexpr int HALVES = BM / 64;
  constexpr int EN = epi_cols<BN>();
  constexpr int A_BYTES = BM * BK * 2;
  constexpr int STAGE = stage_bytes<BM, BN>();
  constexpr int EPI = 64 * epi_pitch<BN>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  float* staging = reinterpret_cast<float*>(ring + STAGES * STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * EPI);
  uint64_t* empty = full + STAGES;
  uint64_t* turn = empty + STAGES;     // [2]: warpgroup w's mainloop is done

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * n_tiles;
  const int k_steps = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);     // released by the warpgroup that read it
    }
    mbar_init(&turn[0], 1);
    mbar_init(&turn[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * BM;
        const int n0 = (tile % n_tiles) * BN;
        for (int ks = 0; ks < k_steps; ++ks, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], STAGE);
          uint8_t* dst = ring + s * STAGE;
          tma_load(dst, &tmA, ks * BK, m0, &full[s]);
          tma_load(dst + A_BYTES, &tmW, ks * BK, n0, &full[s]);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    // Ping-pong: warpgroup w takes the block's tiles w, w + 2, ... whole
    // (BM / 64 m64 halves), so one warpgroup's epilogue runs while the other's
    // products do. Tile i of the block reads ring stages j = i * k_steps +
    // ks in the producer's order. The mainloops take turns: tile i's starts
    // once tile i - 1's has issued its last products (turn barriers), so no
    // warpgroup waits on a stage barrier more than one phase ahead of it,
    // where a parity wait could not tell the phases apart.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
    float acc[HALVES][BN / 2];
    for (int i = wg; i < mine; i += 2) {
      const int tile = blockIdx.x + i * gridDim.x;
      const int m0 = (tile / n_tiles) * BM;
      const int n0 = (tile % n_tiles) * BN;
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) acc[h][e] = 0.0f;
      float mu[BM / 16] = {}, rs[BM / 16] = {};
      if constexpr (LN) {
#pragma unroll
        for (int r = 0; r < BM / 16; ++r) {
          const int gm = m0 + t / 8 + 16 * r;
          if (gm < M) {
            mu[r] = ln.stats[2 * (size_t)gm];
            rs[r] = ln.stats[2 * (size_t)gm + 1];
          }
        }
      }
      // LN: wait for stage j and normalise its BM rows in place; stage
      // j + 1 is prepared while j's products run
      auto prepare = [&](int j, const LnChunk& c) {
        const int s = j % STAGES;
        mbar_wait(&full[s], (j / STAGES) & 1);
        normalise_stage(ring + s * STAGE, c, mu, rs, t);
        // the generic-proxy writes before the async proxy's wgmma reads
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_bar_sync(1 + wg, 128);
      };
      if (i > 0) mbar_wait(&turn[1 - wg], ((i - 1) / 2) & 1);
      const int j0 = i * k_steps;
      if constexpr (LN) prepare(j0, ln_chunk(ln, 0, K, t));
      int held = -1;   // stage read by the wgmma group still in flight
      for (int ks = 0; ks < k_steps; ++ks) {
        const int j = j0 + ks;
        const int s = j % STAGES;
        if constexpr (!LN) mbar_wait(&full[s], (j / STAGES) & 1);
        LnChunk next;
        if constexpr (LN) next = ln_chunk(ln, (ks + 1) * BK, K, t);
        const uint32_t a_tile = smem_u32(ring + s * STAGE);
        const uint64_t dw = smem_desc(smem_u32(ring + s * STAGE + A_BYTES));
#pragma unroll
        for (int h = 0; h < HALVES; ++h) fence_regs(acc[h]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < HALVES; ++h)
            wgmma_ss(acc[h], smem_desc(a_tile + h * 64 * 128) + 2 * kk,
                     dw + 2 * kk, 1);
        wgmma_commit();
        wgmma_wait<1>();
        if (held >= 0 && t == 0) mbar_arrive(&empty[held]);
        held = s;
        if constexpr (LN)
          if (ks + 1 < k_steps) prepare(j + 1, next);
      }
      if (t == 0) mbar_arrive(&turn[wg]);
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < HALVES; ++h) fence_regs(acc[h]);
      if (held >= 0 && t == 0) mbar_arrive(&empty[held]);
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
#pragma unroll
        for (int cb = 0; cb < BN / EN; ++cb)
          epilogue_tile<BN>(ep, M, N, m0 + 64 * h, n0 + EN * cb,
                            staging + wg * EPI, acc[h], cb, t, 1 + wg);
    }
  }
}

// One warp per row: (mu, rstd) of row `row` of x (M, D) bf16, in f32; the
// variance is the two-pass mean of (x - mu)^2. D % 8 == 0.
constexpr int STATS_THREADS = 256;

__global__ void __launch_bounds__(STATS_THREADS)
row_stats_kernel(const bf16* __restrict__ x, int M, int D, float eps,
                 float* __restrict__ stats) {
  const int row = blockIdx.x * (STATS_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const uint4* r = reinterpret_cast<const uint4*>(x + (size_t)row * D);
  const int n8 = D / 8;
  float s = 0.0f;
  for (int c = lane; c < n8; c += 32) {
    const uint4 v = r[c];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) s += bf16_lo(w[e]) + bf16_hi(w[e]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mu = s / D;
  float q = 0.0f;
  for (int c = lane; c < n8; c += 32) {
    const uint4 v = r[c];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d0 = bf16_lo(w[e]) - mu;
      const float d1 = bf16_hi(w[e]) - mu;
      q += d0 * d0 + d1 * d1;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
  if (lane == 0) {
    stats[2 * (size_t)row] = mu;
    stats[2 * (size_t)row + 1] = rsqrtf(q / D + eps);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline const char* error_string(int code) {
  if (code >= TMAP_ERROR_BASE)
    return "cuTensorMapEncodeTiled failed or is unavailable (code - 20000 is "
           "its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

inline int encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || !p)
      return TMAP_ERROR_BASE + (int)CUDA_ERROR_NOT_FOUND;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

// Tensor map of a (rows, K) bf16 row-major matrix, box of `box_rows` x BK,
// 128-byte swizzle, zero fill past the edges.
inline int encode_map(CUtensorMap* map, const bf16* base, int K, int rows,
                      int box_rows) {
  EncodeTiled fn;
  if (int e = encode_fn(&fn)) return e;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<bf16*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMAP_ERROR_BASE + (int)r;
}

inline int num_sms(int* n) {
  static int cached = 0;
  if (!cached) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  *n = cached;
  return 0;
}

inline long long tile_count(int M, int N, int bm, int bn) {
  return (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
}

// Plain products: 128 x 64 where its waves of tiles over the SMs cost less
// than 128 x 128's (each tile costing its width), else 128 x 128.
inline int pick_bn(int M, int N, int sms) {
  const long long w128 = (tile_count(M, N, 128, 128) + sms - 1) / sms * 128;
  const long long w64 = (tile_count(M, N, 128, 64) + sms - 1) / sms * 64;
  return w64 < w128 ? 64 : 128;
}

template <int BM, int BN, bool LN>
inline int launch(cudaStream_t st, const bf16* A, const bf16* W, int M, int N,
                  int K, const Epilogue& ep, const LnPrologue& ln, int sms) {
  CUtensorMap ta, tw;
  if (int e = encode_map(&ta, A, K, M, BM)) return e;
  if (int e = encode_map(&tw, W, K, N, BN)) return e;
  const int smem = smem_bytes<BM, BN>();
  cudaError_t e = ensure_smem_limit(gemm_kernel<BM, BN, LN>, smem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = tile_count(M, N, BM, BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  gemm_kernel<BM, BN, LN><<<grid, THREADS, smem, st>>>(ta, tw, M, N, K, ep,
                                                       ln);
  return (int)cudaGetLastError();
}

// C = A W^T through the epilogue; with `ln` set, A is normalised row by row
// on its way into the products (ln->stats from row_stats). Returns 0, a
// cudaError_t, or TMAP_ERROR_BASE + a CUresult.
inline int gemm(cudaStream_t st, const bf16* A, const bf16* W, int M, int N,
                int K, const Epilogue& ep, const LnPrologue* ln = nullptr) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 8) return (int)cudaErrorInvalidValue;
  int sms;
  if (int e = num_sms(&sms)) return e;
  // the LayerNorm prologue normalises each A stage once per column tile: a
  // 64 x 256 tile does that half as often per product as a 128 x 128 one
  if (ln) return launch<64, 256, true>(st, A, W, M, N, K, ep, *ln, sms);
  const LnPrologue none{nullptr, nullptr, nullptr};
  return pick_bn(M, N, sms) == 64
             ? launch<128, 64, false>(st, A, W, M, N, K, ep, none, sms)
             : launch<128, 128, false>(st, A, W, M, N, K, ep, none, sms);
}

inline int row_stats(cudaStream_t st, const bf16* x, int M, int D, float eps,
                     float* stats) {
  if (M <= 0) return 0;
  const int rows_per_block = STATS_THREADS / 32;
  row_stats_kernel<<<(M + rows_per_block - 1) / rows_per_block,
                     STATS_THREADS, 0, st>>>(x, M, D, eps, stats);
  return (int)cudaGetLastError();
}

}  // namespace gemm_sm90
