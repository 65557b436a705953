// The zero-stall ring shared by the four matmul kernels of the port:
// zero_stall_matmul.cu (C = A @ B and its grouped form C_g = A_g @ B_g)
// and quantized_matmul.cu (the same two with int8 codes, an exact int32
// accumulator and a dequantising epilogue).  Written once here: the
// N-slot revolving buffer, the masked tile loaders, the tensor-core inner
// products and the epilogue.
//
// Schedule (the paper's mechanism in CUDA terms).  One thread block owns
// one (bm x bn) output tile of one group and walks k inside the block;
// that loop takes the place of the TPU's sequential grid.  A `slots`-deep
// ring of (A, B) tile pairs lives in dynamic shared memory and is filled
// with cp.async.  The prologue issues steps 0 .. slots-2; step t first
// issues the copy for step t+slots-1 into slot (t+slots-1) % slots ==
// (t-1) % slots, which step t-1 drained (the barrier that ends step t-1
// makes that safe), then waits until step t's copy group has landed and
// consumes slot t % slots.  With slots=1 the copy is issued only after
// the previous compute, so copy -> wait -> compute serialise, as in the
// Pallas kernels' `slots == 1` branch.  `grid_order` picks the
// rasterisation of output tiles over blockIdx.x ("ijk": consecutive
// blocks share an A row panel, "jik": they share a B column panel);
// blockIdx.y is the group (expert) index.  The Pallas grouped kernels
// stream their ring across group boundaries because the TPU grid runs in
// order; Hopper runs blocks in parallel, so here each block runs its own
// ring over its k steps and groups are independent blocks.
//
// Inner products: fp32 inputs use plain fp32 FMA (never TF32), an 8 x 8
// register tile per thread.  bf16 inputs use mma.sync m16n8k16 (bf16 x
// bf16 -> fp32), int8 inputs mma.sync m16n8k32 (s8 x s8 -> s32, exact),
// one 32 x 32 warp tile per warp with fragments loaded by ldmatrix.  Both
// tensor-core types read 32 bytes of k per mma and their fragments have
// the same byte layout, so one code path serves both: A rows and (N, K)
// B rows are loaded with ldmatrix as 16-bit pairs.  A row-major (K, N) B
// is loaded with ldmatrix .trans, which exists for 16-bit elements only;
// int8 B must therefore be K-major (TRANS_B), the layout the port's
// QTensor stores.
//
// Epilogue: fp32 and bf16 products cast their fp32 accumulator to the
// output type.  int8 products compute (float(acc) * a_scale[row]) *
// b_scale[col] in fp32, rounding after each multiply (__fmul_rn, never
// contracted), then cast once: the order of the plain version, so the
// two agree bit for bit.
//
// Ragged M, N and K are masked in the kernel: out-of-range elements of a
// tile are zero-filled (cp.async with src-size 0), so they add nothing to
// the sum and the caller pads nothing.  The 16-byte cp.async path needs
// the contiguous extents (K, and N for a row-major B) to be multiples of
// 16 bytes and 16-byte aligned bases; other shapes take a synchronous
// element-wise loader that fills the same ring.
//
// Every launch allocates nothing and runs on the caller's stream; each C
// entry point returns cudaGetLastError().

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Internal linkage: every library that includes this header keeps its own
// copies.  Shared template instances would otherwise be unified across
// the loaded libraries (a function-local static of a template is a
// process-wide unique symbol), and one library's record of the shared
// memory it configured for its kernel would stand in for another's.
namespace zs {
namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;  // 227 KB: the most one block may use

// One launch: G independent (M, K) @ (K, N) products laid out at fixed
// element strides; a_scale (G, M) and b_scale (G, N) only for int8.
struct Problem {
  const void* A;
  const void* B;
  void* C;
  const float* a_scale;
  const float* b_scale;
  long long a_group, b_group, c_group;  // elements from one group to the next
  int M, N, K, bm, bn, bk, slots, jik, out_f32;
};

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
__device__ __forceinline__ T zero_of() {
  return T(0);
}
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

// bf16 x bf16 -> fp32, 16 x 8 x 16
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// s8 x s8 -> s32 (exact), 16 x 8 x 32
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
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
__global__ void __launch_bounds__(kMaxThreads) ring_kernel(const Problem p) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  static_assert(!kInt8 || TRANS_B, "int8 B must be K-major (TRANS_B)");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int bm = p.bm, bn = p.bn, bk = p.bk, slots = p.slots;
  const int M = p.M, N = p.N, K = p.K;
  const Geometry<T, TRANS_B> g(bm, bn, bk);

  const int grp = blockIdx.y;
  const T* A = static_cast<const T*>(p.A) + grp * p.a_group;
  const T* B = static_cast<const T*>(p.B) + grp * p.b_group;
  const size_t c0 = (size_t)grp * p.c_group;

  const int gm = (M + bm - 1) / bm, gn = (N + bn - 1) / bn;
  const int lin = blockIdx.x;
  const int ti = p.jik ? lin % gm : lin / gn;
  const int tj = p.jik ? lin / gm : lin % gn;
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
        if (col < N)
          store_out(p.C, p.out_f32, c0 + (size_t)row * N + col, acc[i][j]);
      }
    }
  } else {
    // ---- bf16 / int8: one 32 x 32 warp tile of tensor-core products -----
    using Acc = typename std::conditional<kInt8, int, float>::type;
    constexpr int HALF = 16 / sizeof(T);  // elements in 16 bytes
    constexpr int KSTEP = 2 * HALF;       // k depth of one mma: 32 bytes
    const int warp = tid / 32, lane = tid % 32;
    const int wn_count = bn / 32;
    const int wm = warp / wn_count, wn = warp % wn_count;
    Acc acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = Acc(0);

    for (int s = 0; s < slots - 1; ++s) issue(s);
    for (int t = 0; t < steps; ++t) {
      issue(t + slots - 1);
      cp_async_wait(slots - 1);
      __syncthreads();
      const T* sa = smem + (t % slots) * g.slot_elems;
      const T* sb = sa + g.a_elems;
      for (int kk = 0; kk < bk; kk += KSTEP) {
        uint32_t af[2][4], bfr[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int row = wm * 32 + mi * 16 + (lane % 16);
          ldmatrix_x4(af[mi], sa + row * g.lda + kk + (lane / 16) * HALF);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if constexpr (TRANS_B) {
            const int nrow = wn * 32 + ni * 8 + (lane % 8);
            ldmatrix_x2(bfr[ni],
                        sb + nrow * g.ldb + kk + ((lane / 8) % 2) * HALF);
          } else {
            const int krow = kk + (lane % 16);
            ldmatrix_x2_trans(bfr[ni], sb + krow * g.ldb + wn * 32 + ni * 8);
          }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], af[mi], bfr[ni]);
      }
      __syncthreads();
    }
    const float* a_scale = kInt8 ? p.a_scale + (size_t)grp * M : nullptr;
    const float* b_scale = kInt8 ? p.b_scale + (size_t)grp * N : nullptr;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int row = i0 + wm * 32 + mi * 16 + lane / 4;
        const int col = j0 + wn * 32 + ni * 8 + (lane % 4) * 2;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row + (e / 2) * 8, c = col + (e % 2);
          if (r < M && c < N) {
            float v;
            if constexpr (kInt8)
              v = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][e]),
                                      a_scale[r]),
                            b_scale[c]);
            else
              v = acc[mi][ni][e];
            store_out(p.C, p.out_f32, c0 + (size_t)r * N + c, v);
          }
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

// Launch ring_kernel<T, TRANS_B, VEC> over `groups` groups of p.
template <typename T, bool TRANS_B, bool VEC>
int launch(const Problem& p, int groups, cudaStream_t stream) {
  auto kern = ring_kernel<T, TRANS_B, VEC>;
  const int smem = smem_bytes<T, TRANS_B>(p.bm, p.bn, p.bk, p.slots);
  const int threads = threads_for<T>(p.bm, p.bn);
  if (smem > kMaxSmem || threads > kMaxThreads || threads < 1 ||
      groups < 1 || groups > 65535)
    return (int)cudaErrorInvalidValue;
  static int configured = 48 * 1024;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  const int gm = (p.M + p.bm - 1) / p.bm, gn = (p.N + p.bn - 1) / p.bn;
  kern<<<dim3(gm * gn, groups), threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The TRANS_B x VEC instantiations of one element type.
template <typename T>
int dispatch(const Problem& p, int groups, int trans_b, int vec,
             cudaStream_t s) {
  if (trans_b)
    return vec ? launch<T, true, true>(p, groups, s)
               : launch<T, true, false>(p, groups, s);
  return vec ? launch<T, false, true>(p, groups, s)
             : launch<T, false, false>(p, groups, s);
}

}  // namespace
}  // namespace zs

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
