// Zero-stall matmul for Hopper (sm_90a), bf16, one product (G = 1):
// C = A @ B through a TMA-filled shared-memory ring consumed by wgmma.
//
// Replaces: src/repro/kernels/zero_stall_matmul.py::zero_stall_matmul
// (Pallas TPU kernel, body `_kernel` at line 71, `pl.pallas_call` at line
// 200) for bf16 operands whose rows TMA can address (K % 8 == 0, N % 8
// == 0 for a row-major B, 16-byte aligned bases).  fp32, ragged bf16 and
// the grouped launch keep the cp.async ring of zero_stall_ring.cuh.
//
// What it computes: C (M, N) = A (M, K) @ B with B given as (K, N)
// row-major or, with TRANS_B, as (N, K) row-major (the tied LM head
// reads the embedding table in place); an fp32 accumulator cast once to
// bf16 or fp32.
//
// Schedule (the paper's revolving buffer on Hopper).  A `slots`-stage
// ring of (B tile, A tile) pairs lives in dynamic shared memory.  One
// producer thread (warp 4) fills stage s with TMA (cp.async.bulk.tensor,
// 128-byte swizzle) and arms its full mbarrier with the stage's byte
// count; the consumer warpgroup (warps 0-3) waits on the full barrier of
// the oldest stage, runs its wgmmas, waits for them and arrives on the
// stage's empty barrier, which the producer waits on before refilling
// the stage.  So while the consumer works on one stage the producer
// keeps up to slots - 1 others in flight; with slots = 1 the refill
// waits for the release, and copy -> compute -> copy serialise, as in
// the Pallas kernel's `slots == 1` branch.  grid_order picks the
// rasterisation of output tiles over blockIdx.x ("ijk": consecutive
// blocks share a row panel of A, "jik" a column panel of B).
//
// Swap AB.  At decode M is a few rows, far below wgmma's 64-row M side,
// so the kernel computes C^T = B^T A^T: the weight's N side fills the
// 64-row side (bn / 64 wgmmas a k16 step, bn in {64, 128}) and the M
// rows are the instruction's N side, NI = min(bm, next power of two of
// max(M, 8)) in {8, 16, 32, 64, 128}.  So a block owns NI x bn outputs
// (at most bm x bn), a stage holds bk (a multiple of 64) of k, and no
// tensor-core work is spent on 124 padded rows at M = 4.  wgmma reads
// both operands from shared memory: the weight tile is the A operand,
// K-major for (N, K) B and MN-major (transposed) for (K, N) B; the
// activation tile is the K-major B operand.  TMA boxes are 64 elements
// (128 bytes) wide along the contiguous dimension and land 1024-byte
// aligned in the 128-byte swizzle that the wgmma descriptors name;
// out-of-range rows and columns of a box are zero-filled by TMA, so
// ragged M, N and K edges add nothing and the epilogue masks the stores.
//
// Split-k.  When the output tiles are fewer than the SMs, the wrapper
// splits the k stages into `splits` ranges of steps_per_split whole
// stages (blockIdx.y): each block writes its fp32 partial tile to a
// workspace of splits x M x N, and splitk_reduce adds the splits in
// index order and casts once, so the result is the same bits on every
// call (no atomics).
//
// Bound on the H100: at decode (M = 4) and at a 128-token prefill the
// product does at most 2 * M FLOP per weight element read, below the
// ~295 FLOP/byte ridge: it is bound by the bytes of B at 3.35 TB/s.  The
// design keeps TMA tiles of 16-32 KB in flight on about every SM
// (split-k at decode, where N / bn tiles alone would leave most SMs
// idle) and spends no registers or instructions on the copies.
//
// Every launch allocates nothing and runs on the caller's stream; the C
// entry point returns cudaGetLastError() or the error of a refused
// launch or tensor-map encoding.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// The box at (c0 inner, c1 outer) of `map` into shared memory at dst,
// completing `bytes` on the mbarrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
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

// D (64 x N, fp32, N / 2 registers a thread) += A (64 x 16) B (16 x N),
// bf16 operands in shared memory; TRANS_A = 1 reads A MN-major.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
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
struct Wgmma<16> {
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
struct Wgmma<32> {
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
struct Wgmma<64> {
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
struct Wgmma<128> {
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

// ---- the kernel -----------------------------------------------------------
struct Params {
  void* C;        // (M, N), bf16 or fp32 (out_f32)
  float* ws;      // (splits, M, N) fp32 partials when splits > 1
  int M, N, bk, slots, jik, out_f32, steps, steps_per_split, splits, gm, gn;
};

// J = bn / 64 weight row chunks, NI activation rows a block.
template <int J, int NI, bool TRANS_B>
__global__ void __launch_bounds__(kThreads, 1)
    sm90_kernel(const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap ta, const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int BN = 64 * J;
  const int bk = p.bk, slots = p.slots;
  // 1024-byte aligned stages: the swizzle atom of the descriptors
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t w_bytes = BN * bk * 2, stage = w_bytes + NI * bk * 2;
  const uint32_t bars = base + slots * stage;  // full[slots], empty[slots]

  const int lin = blockIdx.x;
  const int ti = p.jik ? lin % p.gm : lin / p.gn;
  const int tj = p.jik ? lin / p.gm : lin % p.gn;
  const int m0 = ti * NI, n0 = tj * BN;
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
    // ---- producer: one thread keeps the ring full ----
    if (lane == 0) {
      for (int it = 0; it < nsteps; ++it) {
        const int s = it % slots;
        // refill only after the consumer released the stage's last use
        if (it >= slots)
          mbar_wait(bars + 8 * (slots + s), ((it / slots) & 1) ^ 1);
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, stage);
        const int k0 = (s0 + it) * bk;
        const uint32_t sw = base + s * stage, sa = sw + w_bytes;
        if (TRANS_B) {  // (N, K): boxes of 64 k x BN rows
          for (int c = 0; c < bk / 64; ++c)
            tma_load(sw + c * BN * 128, &tw, k0 + 64 * c, n0, full);
        } else {        // (K, N): boxes of 64 n x bk rows
#pragma unroll
          for (int j = 0; j < J; ++j)
            tma_load(sw + j * bk * 128, &tw, n0 + 64 * j, k0, full);
        }
        for (int c = 0; c < bk / 64; ++c)
          tma_load(sa + c * NI * 128, &ta, k0 + 64 * c, m0, full);
      }
    }
    return;
  }

  // ---- consumer warpgroup: C^T tile (BN x NI) in registers ----
  float acc[J][NI / 2];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < NI / 2; ++i) acc[j][i] = 0.f;

  for (int it = 0; it < nsteps; ++it) {
    const int s = it % slots;
    mbar_wait(bars + 8 * s, (it / slots) & 1);
    const uint32_t sw = base + s * stage, sa = sw + w_bytes;
#pragma unroll
    for (int j = 0; j < J; ++j) fence_regs(acc[j]);
    wgmma_fence();
    for (int kk = 0; kk < bk / 16; ++kk) {
      // k16 step kk: 32-byte column (kk % 4) of the 128-byte K-major box
      // kk / 4, or rows 16 kk .. 16 kk + 15 of an MN-major box
      const uint64_t db =
          desc(sa + (kk / 4) * NI * 128 + (kk % 4) * 32, 16, 1024);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const uint64_t da =
            TRANS_B ? desc(sw + (kk / 4) * BN * 128 + j * 8192 + (kk % 4) * 32,
                           16, 1024)
                    : desc(sw + j * bk * 128 + kk * 2048, bk * 128, 1024);
        Wgmma<NI>::template mma<TRANS_B ? 0 : 1>(acc[j], da, db);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < J; ++j) fence_regs(acc[j]);
    if (lane == 0) mbar_arrive(bars + 8 * (slots + s));
  }

  // accumulator i of chunk j: weight row n0 + 64 j + 16 warp + lane / 4 +
  // 8 ((i / 2) % 2), activation row m0 + 8 (i / 4) + 2 (lane % 4) + i % 2
  const int M = p.M, N = p.N;
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
        p.ws[part + idx] = acc[j][i];
      else if (p.out_f32)
        static_cast<float*>(p.C)[idx] = acc[j][i];
      else
        static_cast<__nv_bfloat16*>(p.C)[idx] = __float2bfloat16(acc[j][i]);
    }
}

// C = sum of the splits' partials in index order, cast once.
__global__ void splitk_reduce(const float* __restrict__ ws, void* C,
                              long long mn, int splits, int out_f32) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float v = ws[i];
    for (int z = 1; z < splits; ++z) v += ws[z * mn + i];
    if (out_f32)
      static_cast<float*>(C)[i] = v;
    else
      static_cast<__nv_bfloat16*>(C)[i] = __float2bfloat16(v);
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

// A 2-D bf16 map of `outer` rows of `inner` elements, `row_bytes` apart,
// read in boxes of box_inner (64: 128 bytes) x box_outer, 128-byte swizzle.
int make_map(CUtensorMap* map, const void* ptr, uint64_t inner,
             uint64_t outer, uint64_t row_bytes, uint32_t box_inner,
             uint32_t box_outer) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                   const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int smem_bytes(int ni, int bn, int bk, int slots) {
  return 1024 + slots * ((bn + ni) * bk * 2 + 16);
}

template <int J, int NI, bool TRANS_B>
int launch(const void* a, const void* b, Params p, int K,
           cudaStream_t stream) {
  constexpr int BN = 64 * J;
  CUtensorMap tw, ta;
  int e = TRANS_B ? make_map(&tw, b, K, p.N, (uint64_t)K * 2, 64, BN)
                  : make_map(&tw, b, p.N, K, (uint64_t)p.N * 2, 64, p.bk);
  if (e == 0) e = make_map(&ta, a, K, p.M, (uint64_t)K * 2, 64, NI);
  if (e != 0) return e;
  auto kern = sm90_kernel<J, NI, TRANS_B>;
  const int smem = smem_bytes(NI, BN, p.bk, p.slots);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static int configured = 48 * 1024;
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  kern<<<dim3(p.gm * p.gn, p.splits), kThreads, smem, stream>>>(tw, ta, p);
  return (int)cudaGetLastError();
}

template <int J, int NI>
int dispatch_trans(const void* a, const void* b, const Params& p, int K,
                   int trans_b, cudaStream_t s) {
  return trans_b ? launch<J, NI, true>(a, b, p, K, s)
                 : launch<J, NI, false>(a, b, p, K, s);
}

template <int J>
int dispatch_ni(const void* a, const void* b, const Params& p, int K, int ni,
                int trans_b, cudaStream_t s) {
  switch (ni) {
    case 8: return dispatch_trans<J, 8>(a, b, p, K, trans_b, s);
    case 16: return dispatch_trans<J, 16>(a, b, p, K, trans_b, s);
    case 32: return dispatch_trans<J, 32>(a, b, p, K, trans_b, s);
    case 64: return dispatch_trans<J, 64>(a, b, p, K, trans_b, s);
    case 128: return dispatch_trans<J, 128>(a, b, p, K, trans_b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// C (M, N) = A (M, K) @ B, all bf16 except C (fp32 when out_f32), B as
// (K, N) row-major or, with trans_b, (N, K) row-major; contiguous, 16-byte
// aligned, K % 8 == 0 and (trans_b or N % 8 == 0).  ni in {8, ..., 128}
// activation rows and bn in {64, 128} weight columns a block, bk a
// multiple of 64 (<= 256) a stage, `slots` stages.  The k stages split
// into `splits` ranges of steps_per_split; with splits > 1, ws holds
// splits * M * N floats.
int zero_stall_matmul_sm90(const void* a, const void* b, void* c, void* ws,
                           int M, int N, int K, int ni, int bn, int bk,
                           int slots, int jik, int out_f32, int trans_b,
                           int splits, int steps_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bk % 64 || bk < 64 || bk > 256 || slots < 1 || splits < 1 ||
      (splits > 1 && ws == nullptr) || splits > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{c, static_cast<float*>(ws), M, N, bk, slots, jik, out_f32,
           (K + bk - 1) / bk, steps_per_split, splits,
           (M + ni - 1) / ni, (N + bn - 1) / bn};
  int e;
  if (bn == 64)
    e = dispatch_ni<1>(a, b, p, K, ni, trans_b, s);
  else if (bn == 128)
    e = dispatch_ni<2>(a, b, p, K, ni, trans_b, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != 0 || splits == 1) return e;
  const long long mn = (long long)M * N;
  const int blocks = (int)((mn + 255) / 256 < 1056 ? (mn + 255) / 256 : 1056);
  splitk_reduce<<<blocks, 256, 0, s>>>(static_cast<const float*>(ws), c, mn,
                                       splits, out_f32);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
