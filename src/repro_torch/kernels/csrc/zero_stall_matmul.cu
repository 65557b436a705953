// Zero-stall matmul for Hopper (sm_90a): C = A @ B with an N-slot
// shared-memory revolving buffer.
//
// Replaces: src/repro/kernels/zero_stall_matmul.py::zero_stall_matmul
// (Pallas TPU kernel, body `_kernel`, `pl.pallas_call` at line 200).
//
// Schedule (the paper's mechanism in CUDA terms).  One thread block owns
// one (bm x bn) output tile and walks k inside the block; that loop takes
// the place of the TPU's sequential grid.  A `slots`-deep ring of
// (A, B) tile pairs lives in dynamic shared memory and is filled with
// cp.async.  The prologue issues steps 0 .. slots-2; step t first issues
// the copy for step t+slots-1 into slot (t+slots-1) % slots ==
// (t-1) % slots, which step t-1 drained (the barrier that ends step t-1
// makes that safe), then waits until step t's copy group has landed and
// consumes slot t % slots.  With slots=1 the copy is issued only after
// the previous compute, so copy -> wait -> compute serialise, as in the
// Pallas kernel's `slots == 1` branch.  `grid_order` picks the
// rasterisation of output tiles over the 1-D grid ("ijk": consecutive
// blocks share an A row panel, "jik": they share a B column panel).
//
// Inner product: bf16 inputs use mma.sync m16n8k16 (bf16 x bf16 -> fp32),
// one 32 x 32 warp tile per warp, fragments loaded with ldmatrix (.trans
// for a row-major B).  fp32 inputs use plain fp32 FMA (never TF32), an
// 8 x 8 register tile per thread.  The fp32 accumulator is cast to the
// output dtype (bf16 or fp32) in the epilogue.  TRANS_B reads B given as
// (N, K) row-major: the tied LM head multiplies by the embedding table
// without a transposed copy.
//
// Ragged M, N and K are masked in the kernel: out-of-range elements of a
// tile are zero-filled (cp.async with src-size 0), so they add nothing to
// the sum and the caller pads nothing.  The 16-byte cp.async path needs
// K and N (or K for TRANS_B) to be multiples of 16 bytes and 16-byte
// aligned bases; other shapes take a synchronous element-wise loader that
// fills the same ring.
//
// Bound on the H100: at decode (M = a few slots) the kernel reads every
// weight once and does 2*M FLOP per weight element, far below the 295
// FLOP/byte ridge: it is bound by bytes (3.35 TB/s).  At a prefill bucket
// of M = 128 it is still below the ridge; only large M is bound by the
// 989 TFLOP/s of the tensor cores.  What the design does about it: the
// ring keeps slots-1 tile copies in flight per block while the tensor
// cores work on the oldest slot.  It does not yet use TMA, wgmma, split-k
// or persistent blocks, so a small-M product over few output tiles
// leaves SMs idle (see PERF.md for the measured times).
//
// Every launch allocates nothing and runs on the caller's stream; each C
// entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;  // 227 KB: the most one block may use

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` committed groups are still in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    case 7: asm volatile("cp.async.wait_group 7;\n" ::); break;
    default: asm volatile("cp.async.wait_group 0;\n" ::); break;
  }
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// dst[r * ld_dst + c] = src[(r0 + r) * ld_src + c0 + c] for r < rows,
// c < cols; zero where r0 + r >= R or c0 + c >= C.
template <typename T, bool VEC>
__device__ __forceinline__ void load_tile(T* dst, int ld_dst, const T* src,
                                          int ld_src, int rows, int cols,
                                          int r0, int c0, int R, int C,
                                          int tid, int nthreads) {
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    const int cpr = cols / V;
    const int n = rows * cpr;
    for (int i = tid; i < n; i += nthreads) {
      const int r = i / cpr, c = (i - r * cpr) * V;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < R && gc < C;  // C % V == 0: all of a chunk or none
      const T* g = ok ? src + (size_t)gr * ld_src + gc : src;
      cp_async16(dst + r * ld_dst + c, g, ok ? 16 : 0);
    }
  } else {
    const int n = rows * cols;
    for (int i = tid; i < n; i += nthreads) {
      const int r = i / cols, c = i - r * cols;
      const int gr = r0 + r, gc = c0 + c;
      dst[r * ld_dst + c] =
          (gr < R && gc < C) ? src[(size_t)gr * ld_src + gc] : zero_of<T>();
    }
  }
}

__device__ __forceinline__ void store_out(void* C, bool out_f32, size_t idx,
                                          float v) {
  if (out_f32)
    static_cast<float*>(C)[idx] = v;
  else
    static_cast<__nv_bfloat16*>(C)[idx] = __float2bfloat16(v);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T, bool TRANS_B>
struct Geometry {
  static constexpr int PAD = 16 / sizeof(T);  // keeps rows 16-byte aligned
  int lda, ldb, a_elems, slot_elems;
  __host__ __device__ Geometry(int bm, int bn, int bk) {
    lda = bk + PAD;
    ldb = TRANS_B ? bk + PAD : bn + PAD;
    a_elems = bm * lda;
    slot_elems = a_elems + (TRANS_B ? bn : bk) * ldb;
  }
};

template <typename T>
__host__ __device__ int threads_for(int bm, int bn) {
  if constexpr (std::is_same<T, float>::value) return (bm / 8) * (bn / 8);
  return (bm / 32) * (bn / 32) * 32;
}

template <typename T, bool TRANS_B, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
    zero_stall_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                             void* __restrict__ C, int M, int N, int K, int bm,
                             int bn, int bk, int slots, int jik, int out_f32) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const Geometry<T, TRANS_B> g(bm, bn, bk);

  const int gm = (M + bm - 1) / bm, gn = (N + bn - 1) / bn;
  const int lin = blockIdx.x;
  const int ti = jik ? lin % gm : lin / gn;
  const int tj = jik ? lin / gm : lin % gn;
  const int i0 = ti * bm, j0 = tj * bn;
  const int steps = (K + bk - 1) / bk;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  // copy group for k step t into slot t % slots (an empty group past the
  // end keeps the group count uniform for cp_async_wait)
  auto issue = [&](int t) {
    if (t < steps) {
      T* sa = smem + (t % slots) * g.slot_elems;
      T* sb = sa + g.a_elems;
      const int k0 = t * bk;
      load_tile<T, VEC>(sa, g.lda, A, K, bm, bk, i0, k0, M, K, tid, nthreads);
      if constexpr (TRANS_B)
        load_tile<T, VEC>(sb, g.ldb, B, K, bn, bk, j0, k0, N, K, tid,
                          nthreads);
      else
        load_tile<T, VEC>(sb, g.ldb, B, N, bk, bn, k0, j0, K, N, tid,
                          nthreads);
    }
    cp_async_commit();
  };

  if constexpr (std::is_same<T, float>::value) {
    // ---- fp32: 8 x 8 outputs per thread, strided over the tile ----------
    const int cstep = bn / 8, rstep = bm / 8;
    const int tx = tid % cstep, ty = tid / cstep;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int s = 0; s < slots - 1; ++s) issue(s);
    for (int t = 0; t < steps; ++t) {
      issue(t + slots - 1);
      cp_async_wait(slots - 1);
      __syncthreads();
      const float* sa = smem + (t % slots) * g.slot_elems;
      const float* sb = sa + g.a_elems;
      for (int kk = 0; kk < bk; ++kk) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = sa[(ty + i * rstep) * g.lda + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          b[j] = TRANS_B ? sb[(tx + j * cstep) * g.ldb + kk]
                         : sb[kk * g.ldb + tx + j * cstep];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = i0 + ty + i * rstep;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j0 + tx + j * cstep;
        if (col < N) store_out(C, out_f32, (size_t)row * N + col, acc[i][j]);
      }
    }
  } else {
    // ---- bf16: one 32 x 32 warp tile of m16n8k16 tensor-core products ---
    const int warp = tid / 32, lane = tid % 32;
    const int wn_count = bn / 32;
    const int wm = warp / wn_count, wn = warp % wn_count;
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    for (int s = 0; s < slots - 1; ++s) issue(s);
    for (int t = 0; t < steps; ++t) {
      issue(t + slots - 1);
      cp_async_wait(slots - 1);
      __syncthreads();
      const T* sa = smem + (t % slots) * g.slot_elems;
      const T* sb = sa + g.a_elems;
      for (int kk = 0; kk < bk; kk += 16) {
        uint32_t af[2][4], bfr[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int row = wm * 32 + mi * 16 + (lane % 16);
          ldmatrix_x4(af[mi], sa + row * g.lda + kk + (lane / 16) * 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if constexpr (TRANS_B) {
            const int nrow = wn * 32 + ni * 8 + (lane % 8);
            ldmatrix_x2(bfr[ni], sb + nrow * g.ldb + kk + ((lane / 8) % 2) * 8);
          } else {
            const int krow = kk + (lane % 16);
            ldmatrix_x2_trans(bfr[ni], sb + krow * g.ldb + wn * 32 + ni * 8);
          }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int row = i0 + wm * 32 + mi * 16 + lane / 4;
        const int col = j0 + wn * 32 + ni * 8 + (lane % 4) * 2;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row + (e / 2) * 8, c = col + (e % 2);
          if (r < M && c < N)
            store_out(C, out_f32, (size_t)r * N + c, acc[mi][ni][e]);
        }
      }
    }
  }
}

template <typename T, bool TRANS_B>
int smem_bytes(int bm, int bn, int bk, int slots) {
  const Geometry<T, TRANS_B> g(bm, bn, bk);
  return slots * g.slot_elems * (int)sizeof(T);
}

template <typename T, bool TRANS_B, bool VEC>
int launch(const void* a, const void* b, void* c, int M, int N, int K, int bm,
           int bn, int bk, int slots, int jik, int out_f32,
           cudaStream_t stream) {
  auto kern = zero_stall_matmul_kernel<T, TRANS_B, VEC>;
  const int smem = smem_bytes<T, TRANS_B>(bm, bn, bk, slots);
  const int threads = threads_for<T>(bm, bn);
  if (smem > kMaxSmem || threads > kMaxThreads || threads < 1)
    return (int)cudaErrorInvalidValue;
  static int configured = 48 * 1024;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  const int gm = (M + bm - 1) / bm, gn = (N + bn - 1) / bn;
  kern<<<gm * gn, threads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), c, M, N, K, bm, bn,
      bk, slots, jik, out_f32);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* a, const void* b, void* c, int M, int N, int K,
             int bm, int bn, int bk, int slots, int jik, int out_f32,
             int trans_b, int vec, cudaStream_t s) {
  if (trans_b) {
    return vec ? launch<T, true, true>(a, b, c, M, N, K, bm, bn, bk, slots,
                                       jik, out_f32, s)
               : launch<T, true, false>(a, b, c, M, N, K, bm, bn, bk, slots,
                                        jik, out_f32, s);
  }
  return vec ? launch<T, false, true>(a, b, c, M, N, K, bm, bn, bk, slots, jik,
                                      out_f32, s)
             : launch<T, false, false>(a, b, c, M, N, K, bm, bn, bk, slots,
                                       jik, out_f32, s);
}

}  // namespace

extern "C" {

// C (M, N) = A (M, K) @ B, B given as (K, N) row-major or, with trans_b,
// as (N, K) row-major.  dtype_bf16 selects bf16 inputs (else fp32);
// out_f32 selects an fp32 output (else bf16).  vec selects the 16-byte
// cp.async loader (the caller checks that shapes and pointers allow it).
int zero_stall_matmul(const void* a, const void* b, void* c, int M, int N,
                      int K, int bm, int bn, int bk, int slots, int jik,
                      int dtype_bf16, int out_f32, int trans_b, int vec,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_bf16)
    return dispatch<__nv_bfloat16>(a, b, c, M, N, K, bm, bn, bk, slots, jik,
                                   out_f32, trans_b, vec, s);
  return dispatch<float>(a, b, c, M, N, K, bm, bn, bk, slots, jik, out_f32,
                         trans_b, vec, s);
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
