// The TMA + mbarrier + wgmma ring of the port's Hopper matmuls
// (sm_90a), shared by zero_stall_sm90.cu (bf16: C = A @ B, and the
// grouped C_g = A_g @ B_g of the MoE expert banks) and quantized_sm90.cu
// (int8 codes, an exact int32 accumulator and the dequantising
// epilogue).  Written once here and templated on the element type:
// the ring, its barriers, the tensor maps, the persistent tile walk,
// the wgmma inner products, the epilogues and the split-k reduction.
//
// Schedule (the paper's revolving buffer on Hopper).  A `slots`-stage
// ring of (weight tile, activation tile) pairs lives in dynamic shared
// memory.  One producer thread (warp 4) fills stage s with TMA
// (cp.async.bulk.tensor, 128-byte swizzle) and arms its full mbarrier
// with the stage's byte count; the consumer warpgroup (warps 0-3) waits
// on the full barrier of the oldest stage, runs its wgmmas, waits for
// them and arrives on the stage's empty barrier, which the producer
// waits on before refilling the stage.  So while the consumer works on
// one stage the producer keeps up to slots - 1 others in flight; with
// slots = 1 the refill waits for the release, and copy -> compute ->
// copy serialise, as in the Pallas kernels' `slots == 1` branch.
//
// Tile walk.  A block walks output tiles blockIdx.x, blockIdx.x +
// gridDim.x, ... of a (group, row tile, column tile) space, g outermost
// (the Pallas grouped kernel's step index t over (g, i, j, k), k
// fastest).  The ring runs on across tiles and groups: its clock is the
// block's stage count `it` over all its tiles, not a tile's k index, so
// the producer fetches tile t + 1's first stages while the consumers
// finish tile t's k loop and store its outputs, and the ring never
// drains between tiles.  A plain product (G = 1) launches one block per
// tile (and split), so its walk is one tile; the grouped product
// launches about one block per SM (persistent).  grid_order picks the
// rasterisation of a group's tiles ("ijk": consecutive tiles share a row
// panel of A, "jik" a column panel of the weight).
//
// Swap AB.  At decode M is a few rows, far below wgmma's 64-row M side,
// so the kernel computes C^T = B^T A^T: the weight's N side fills the
// 64-row side (bn / 64 wgmmas a k step, bn in {64, 128}) and the M rows
// are the instruction's N side, NI in {8, 16, 32, 64, 128}.  So a block
// owns NI x bn outputs, a stage holds bk of k, and no tensor-core work is
// spent on padded rows at M = 4.  wgmma reads both operands from shared
// memory: the weight tile is the A operand, K-major for an (N, K) weight
// and MN-major (transposed) for a (K, N) one; the activation tile is the
// K-major B operand.  int8 wgmma (m64nNk32.s32.s8.s8) takes K-major
// operands only, which the port's int8 weights are (QTensor stores its
// codes as (N, K) rows).
//
// TMA.  Every operand is a rank-3 map over (groups, rows, columns), so a
// box at a ragged edge zero-fills inside its own group and never reads
// the next expert's rows.  Boxes are 128 bytes wide along the contiguous
// dimension (64 bf16 or 128 int8 elements) and land 1024-byte aligned in
// the 128-byte swizzle that the wgmma descriptors name; a wgmma k step is
// 32 bytes (k16 in bf16, k32 in int8), which advances 32 bytes inside the
// swizzle atom of a K-major tile or 16 rows of an MN-major one.  int8
// maps are UINT8 maps (there is no signed one; bytes are bytes).
// Out-of-range rows and columns of a box are zero-filled, so ragged M, N
// and K edges add exact zeros and the epilogue masks the stores.
//
// Split-k.  When the output tiles are fewer than the SMs, the wrapper
// splits the k stages into `splits` ranges of steps_per_split whole
// stages (blockIdx.y): each block writes its partial tile (fp32, or
// int32 for int8) to a workspace of splits x M x N, and splitk_reduce
// adds the splits in index order and only then runs the epilogue, so the
// result is the same bits on every call (no atomics); int32 addition is
// exact, so an int8 product is bit-equal to the unsplit one.
//
// Epilogue: fp32 accumulators are cast to the output type once.  int8
// products compute (float(acc) * a_scale[row]) * b_scale[col] in fp32,
// rounding after each multiply (__fmul_rn), then cast once: the order of
// the plain version, so the two agree bit for bit.  Under swap AB the
// fragment holds C^T: a_scale follows the activation rows (wgmma's N
// index), b_scale the weight rows (wgmma's M index).
//
// Every launch allocates nothing and runs on the caller's stream; each C
// entry point returns cudaGetLastError() or the error of a refused launch
// or tensor-map encoding.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Internal linkage, as in zero_stall_ring.cuh: each loaded library keeps
// its own template instances and their shared-memory records.
namespace {

constexpr int kMaxSmem = 232448;       // 227 KB: the most one block may use
constexpr int kConsumers = 128;        // one warpgroup runs the wgmmas
constexpr int kThreads = kConsumers + 32;  // and one warp issues the TMA

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ------------------------------------------------------------------
// The box at (c0 inner, c1 rows, c2 group) of the rank-3 `map` into
// shared memory at dst, completing its bytes on the mbarrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------
// Shared-memory matrix descriptor of a 128-byte-swizzled tile at byte
// address `addr` (1024-byte-aligned atoms): lbo / sbo in bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the accumulators in place across the asynchronous wgmmas.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x N, N / 2 registers a thread) += A (64 x 32 bytes of k) B (32
// bytes of k x N), both operands in shared memory: bf16 k16 into fp32
// (TRANS_A = 1 reads A MN-major), int8 k32 into exact int32.
template <typename T, int N>
struct Wgmma;

template <>
struct Wgmma<__nv_bfloat16, 8> {
  template <int TRANS_A>
  __device__ static __forceinline__ void mma(float (&d)[4], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, %7, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(1), "n"(TRANS_A));
  }
};

template <>
struct Wgmma<__nv_bfloat16, 16> {
  template <int TRANS_A>
  __device__ static __forceinline__ void mma(float (&d)[8], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1), "n"(TRANS_A));
  }
};

template <>
struct Wgmma<__nv_bfloat16, 32> {
  template <int TRANS_A>
  __device__ static __forceinline__ void mma(float (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1), "n"(TRANS_A));
  }
};

template <>
struct Wgmma<__nv_bfloat16, 64> {
  template <int TRANS_A>
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1), "n"(TRANS_A));
  }
};

template <>
struct Wgmma<__nv_bfloat16, 128> {
  template <int TRANS_A>
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1), "n"(TRANS_A));
  }
};

template <>
struct Wgmma<int8_t, 8> {
  template <int TRANS_A>
  __device__ static __forceinline__ void mma(int (&d)[4], uint64_t da,
                                             uint64_t db) {
    static_assert(TRANS_A == 0, "int8 wgmma reads K-major operands only");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<int8_t, 16> {
  template <int TRANS_A>
  __device__ static __forceinline__ void mma(int (&d)[8], uint64_t da,
                                             uint64_t db) {
    static_assert(TRANS_A == 0, "int8 wgmma reads K-major operands only");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<int8_t, 32> {
  template <int TRANS_A>
  __device__ static __forceinline__ void mma(int (&d)[16], uint64_t da,
                                             uint64_t db) {
    static_assert(TRANS_A == 0, "int8 wgmma reads K-major operands only");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<int8_t, 64> {
  template <int TRANS_A>
  __device__ static __forceinline__ void mma(int (&d)[32], uint64_t da,
                                             uint64_t db) {
    static_assert(TRANS_A == 0, "int8 wgmma reads K-major operands only");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<int8_t, 128> {
  template <int TRANS_A>
  __device__ static __forceinline__ void mma(int (&d)[64], uint64_t da,
                                             uint64_t db) {
    static_assert(TRANS_A == 0, "int8 wgmma reads K-major operands only");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

// The accumulator type of an element type: fp32 for bf16, int32 for int8.
template <typename T>
using Acc = std::conditional_t<std::is_same_v<T, int8_t>, int, float>;

// ---- the kernel -----------------------------------------------------------
struct Params {
  void* C;               // (G, M, N), bf16 or fp32 (out_f32)
  void* ws;              // (splits, M, N) partials when splits > 1: Acc<T>
  const float* a_scale;  // int8: (G, M) activation-row scales
  const float* b_scale;  // int8: (G, N) weight-column scales
  int M, N, bk, slots, jik, out_f32, steps, steps_per_split, splits, gm, gn,
      tiles;
};

// The output tile `tile` of the walk: group g, first activation row m0,
// first weight row n0.
template <int NI, int BN>
__device__ __forceinline__ void locate(const Params& p, int tile, int& g,
                                       int& m0, int& n0) {
  const int per_group = p.gm * p.gn;
  g = tile / per_group;
  const int lin = tile - g * per_group;
  m0 = (p.jik ? lin % p.gm : lin / p.gn) * NI;
  n0 = (p.jik ? lin / p.gm : lin % p.gn) * BN;
}

// One finished output (accumulator v at row m, column n of group g):
// the int8 epilogue's scales in the plain version's order, then one cast.
template <typename T>
__device__ __forceinline__ void store(const Params& p, size_t idx, int g,
                                      int m, int n, Acc<T> v) {
  float f;
  if constexpr (std::is_same_v<T, int8_t>)
    f = __fmul_rn(__fmul_rn(__int2float_rn(v), p.a_scale[(size_t)g * p.M + m]),
                  p.b_scale[(size_t)g * p.N + n]);
  else
    f = v;
  if (p.out_f32)
    static_cast<float*>(p.C)[idx] = f;
  else
    static_cast<__nv_bfloat16*>(p.C)[idx] = __float2bfloat16(f);
}

// J = bn / 64 weight row chunks, NI activation rows a block; TRANS_B: the
// weight is (N, K) rows (K-major), else (K, N) rows (MN-major, bf16 only).
template <typename T, int J, int NI, bool TRANS_B>
__global__ void __launch_bounds__(kThreads, 1)
    sm90_kernel(const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap ta, const Params p) {
  static_assert(TRANS_B || sizeof(T) == 2,
                "int8 wgmma reads K-major operands only");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int BN = 64 * J;
  constexpr int kBox = 128 / sizeof(T);  // elements of a 128-byte box row
  const int bk = p.bk, slots = p.slots;
  // 1024-byte aligned stages: the swizzle atom of the descriptors
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t w_bytes = BN * bk * sizeof(T);
  const uint32_t stage = w_bytes + NI * bk * sizeof(T);
  const uint32_t bars = base + slots * stage;  // full[slots], empty[slots]
  const int s0 = blockIdx.y * p.steps_per_split;
  const int nsteps = min(p.steps, s0 + p.steps_per_split) - s0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(bars + 8 * s, 1);                     // the producer's arm
      mbar_init(bars + 8 * (slots + s), kConsumers / 32);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer: one thread keeps the ring full across the walk ----
    if (lane == 0) {
      int it = 0;  // the ring's clock: stages this block has issued
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        int g, m0, n0;
        locate<NI, BN>(p, tile, g, m0, n0);
        for (int k = 0; k < nsteps; ++k, ++it) {
          const int s = it % slots;
          // refill only after the consumer released the stage's last use
          if (it >= slots)
            mbar_wait(bars + 8 * (slots + s), ((it / slots) & 1) ^ 1);
          const uint32_t full = bars + 8 * s;
          mbar_expect_tx(full, stage);
          const int k0 = (s0 + k) * bk;
          const uint32_t sw = base + s * stage, sa = sw + w_bytes;
          if (TRANS_B) {  // (N, K): boxes of kBox k x BN rows
            for (int c = 0; c < bk / kBox; ++c)
              tma_load(sw + c * BN * 128, &tw, k0 + kBox * c, n0, g, full);
          } else {        // (K, N): boxes of 64 n x bk rows
#pragma unroll
            for (int j = 0; j < J; ++j)
              tma_load(sw + j * bk * 128, &tw, n0 + 64 * j, k0, g, full);
          }
          for (int c = 0; c < bk / kBox; ++c)
            tma_load(sa + c * NI * 128, &ta, k0 + kBox * c, m0, g, full);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: C^T tiles (BN x NI) in registers ----
  const int M = p.M, N = p.N;
  const int ksteps = bk * (int)sizeof(T) / 32;  // 32-byte wgmma k steps
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    int g, m0, n0;
    locate<NI, BN>(p, tile, g, m0, n0);
    Acc<T> acc[J][NI / 2];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int i = 0; i < NI / 2; ++i) acc[j][i] = 0;

    for (int k = 0; k < nsteps; ++k, ++it) {
      const int s = it % slots;
      mbar_wait(bars + 8 * s, (it / slots) & 1);
      const uint32_t sw = base + s * stage, sa = sw + w_bytes;
#pragma unroll
      for (int j = 0; j < J; ++j) fence_regs(acc[j]);
      wgmma_fence();
      for (int kk = 0; kk < ksteps; ++kk) {
        // k step kk: 32-byte column (kk % 4) of the 128-byte K-major box
        // kk / 4, or rows 16 kk .. 16 kk + 15 of an MN-major box
        const uint64_t db =
            desc(sa + (kk / 4) * NI * 128 + (kk % 4) * 32, 16, 1024);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const uint64_t da =
              TRANS_B
                  ? desc(sw + (kk / 4) * BN * 128 + j * 8192 + (kk % 4) * 32,
                         16, 1024)
                  : desc(sw + j * bk * 128 + kk * 2048, bk * 128, 1024);
          Wgmma<T, NI>::template mma<TRANS_B ? 0 : 1>(acc[j], da, db);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < J; ++j) fence_regs(acc[j]);
      if (lane == 0) mbar_arrive(bars + 8 * (slots + s));
    }

    // accumulator i of chunk j: weight row n0 + 64 j + 16 warp + lane / 4
    // + 8 ((i / 2) % 2), activation row m0 + 8 (i / 4) + 2 (lane % 4) +
    // i % 2.  The producer is already filling the next tile's stages.
    const size_t group = (size_t)g * M * N;
    const size_t part = (size_t)blockIdx.y * M * N;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int i = 0; i < NI / 2; ++i) {
        const int n = n0 + 64 * j + 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
        const int m = m0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        if (m >= M || n >= N) continue;
        const size_t idx = (size_t)m * N + n;
        if (p.splits > 1)
          static_cast<Acc<T>*>(p.ws)[part + idx] = acc[j][i];
        else
          store<T>(p, group + idx, g, m, n, acc[j][i]);
      }
  }
}

// C = the epilogue of the sum of the splits' partials, added in index
// order (G = 1).
template <typename T>
__global__ void splitk_reduce(const Params p, long long mn) {
  const Acc<T>* ws = static_cast<const Acc<T>*>(p.ws);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    Acc<T> v = ws[i];
    for (int z = 1; z < p.splits; ++z) v += ws[z * mn + i];
    store<T>(p, i, 0, (int)(i / p.N), (int)(i % p.N), v);
  }
}

// ---- host -----------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (nothing
// is linked against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// A rank-3 map of `groups` x `outer` rows of `inner` elements of T, rows
// `row_bytes` apart and groups outer * row_bytes apart, read in boxes of
// box_inner (128 bytes) x box_outer x 1 in the 128-byte swizzle.
template <typename T>
int make_map(CUtensorMap* map, const void* ptr, uint64_t inner,
             uint64_t outer, uint64_t groups, uint64_t row_bytes,
             uint32_t box_inner, uint32_t box_outer) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {inner, outer, groups};
  const cuuint64_t strides[2] = {row_bytes, row_bytes * outer};
  const cuuint32_t box[3] = {box_inner, box_outer, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  CUresult r = enc(map,
                   sizeof(T) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   3, const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Shared memory of one block: `slots` stages of a bn x bk weight tile and
// an ni x bk activation tile of `elem`-byte elements, 16 bytes of
// mbarriers a stage, and 1024 bytes to align the stages to the swizzle
// atom (the formula of kernels/zero_stall_matmul.py::sm90_smem_bytes).
int smem_bytes(int elem, int ni, int bn, int bk, int slots) {
  return 1024 + slots * ((bn + ni) * bk * elem + 16);
}

template <typename T, int J, int NI, bool TRANS_B>
int launch(const void* a, const void* b, const Params& p, int K, int G,
           int blocks, cudaStream_t stream) {
  constexpr int BN = 64 * J;
  constexpr int kBox = 128 / sizeof(T);
  CUtensorMap tw, ta;
  int e = TRANS_B
              ? make_map<T>(&tw, b, K, p.N, G, (uint64_t)K * sizeof(T), kBox,
                            BN)
              : make_map<T>(&tw, b, p.N, K, G, (uint64_t)p.N * sizeof(T), 64,
                            p.bk);
  if (e == 0)
    e = make_map<T>(&ta, a, K, p.M, G, (uint64_t)K * sizeof(T), kBox, NI);
  if (e != 0) return e;
  auto kern = sm90_kernel<T, J, NI, TRANS_B>;
  const int smem = smem_bytes(sizeof(T), NI, BN, p.bk, p.slots);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static int configured = 48 * 1024;
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  kern<<<dim3(blocks, p.splits), kThreads, smem, stream>>>(tw, ta, p);
  return (int)cudaGetLastError();
}

template <typename T, int J, int NI>
int dispatch_trans(const void* a, const void* b, const Params& p, int K,
                   int G, int blocks, int trans_b, cudaStream_t s) {
  if constexpr (sizeof(T) == 1) {  // int8: K-major weights only
    if (!trans_b) return (int)cudaErrorInvalidValue;
    return launch<T, J, NI, true>(a, b, p, K, G, blocks, s);
  } else {
    return trans_b ? launch<T, J, NI, true>(a, b, p, K, G, blocks, s)
                   : launch<T, J, NI, false>(a, b, p, K, G, blocks, s);
  }
}

template <typename T, int J>
int dispatch_ni(const void* a, const void* b, const Params& p, int K, int G,
                int blocks, int ni, int trans_b, cudaStream_t s) {
  switch (ni) {
    case 8: return dispatch_trans<T, J, 8>(a, b, p, K, G, blocks, trans_b, s);
    case 16: return dispatch_trans<T, J, 16>(a, b, p, K, G, blocks, trans_b, s);
    case 32: return dispatch_trans<T, J, 32>(a, b, p, K, G, blocks, trans_b, s);
    case 64: return dispatch_trans<T, J, 64>(a, b, p, K, G, blocks, trans_b, s);
    case 128:
      return dispatch_trans<T, J, 128>(a, b, p, K, G, blocks, trans_b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Run C (G, M, N) = A (G, M, K) @ B of T elements: B (G, K, N) rows or,
// with trans_b, (G, N, K) rows; ni activation rows and bn in {64, 128}
// weight rows a tile, bk a stage (a multiple of 128 bytes, at most 512),
// `slots` stages.  The k stages split into `splits` ranges of
// steps_per_split (G = 1 only; then ws holds splits * M * N partials;
// one split takes every stage).
// blocks <= 0 launches one block per tile; else `blocks` persistent
// blocks walk the G * ceil(M / ni) * ceil(N / bn) tiles.
template <typename T>
int run(const void* a, const void* b, Params p, int G, int K, int ni, int bn,
        int trans_b, int blocks, cudaStream_t s) {
  const int bytes = p.bk * (int)sizeof(T);
  if (bytes % 128 || bytes < 128 || bytes > 512 || p.slots < 1 ||
      p.splits < 1 || p.splits > 65535 || (p.splits > 1 && (p.ws == nullptr ||
                                                          G != 1)) ||
      G < 1 || ni < 1 || (bn != 64 && bn != 128))
    return (int)cudaErrorInvalidValue;
  p.steps = (K + p.bk - 1) / p.bk;
  if (p.splits == 1) p.steps_per_split = p.steps;
  p.gm = (p.M + ni - 1) / ni;
  p.gn = (p.N + bn - 1) / bn;
  const long long tiles = (long long)G * p.gm * p.gn;
  if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  if (blocks <= 0 || blocks > p.tiles) blocks = p.tiles;
  const int e = bn == 64 ? dispatch_ni<T, 1>(a, b, p, K, G, blocks, ni,
                                             trans_b, s)
                         : dispatch_ni<T, 2>(a, b, p, K, G, blocks, ni,
                                             trans_b, s);
  if (e != 0 || p.splits == 1) return e;
  const long long mn = (long long)p.M * p.N;
  const int rb = (int)((mn + 255) / 256 < 1056 ? (mn + 255) / 256 : 1056);
  splitk_reduce<T><<<rb, 256, 0, s>>>(p, mn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
