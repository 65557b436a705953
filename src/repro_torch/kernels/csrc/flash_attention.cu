// Masked flash attention for Hopper (sm_90a), forward only.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (Pallas TPU kernel, body `_kernel`, `pl.pallas_call` at line 164).
//
// What it computes: q, k, v of shape (B, H, S, D), contiguous, bf16 or
// fp32; per-sequence int32 q_lens, kv_lens and q_offsets, indexed by
// b // H.  Query row i sits at absolute position q_offsets[b] + i.  A
// score is valid when row < q_len, col < kv_len and, when causal,
// row >= col; masked scores are -1e30.  Online softmax over kv tiles:
// while a row's running max is still -1e30 its p is forced to 0, and a
// row whose denominator stays 0 is written as exact zeros.  P is rounded
// to the input dtype before P.V, as the reference does.  The output
// takes q's dtype.
//
// Two designs, chosen by dtype.  Both run one thread block per (b*h, q
// tile of bq rows) with the kv loop inside the block, in place of the
// TPU's sequential kv grid axis, and skip kv tiles that lie wholly past
// kv_len or past the causal frontier of the tile's last row: they would
// add exactly nothing (p = 0, a rescale of 1), so the result is
// unchanged.
//
// bf16: tensor cores, FlashAttention-2 style (flash_tc_kernel).  One
// warp owns 16 query rows (bq = 16 * warps, bq in {16, 32, 64}); the
// block shares a two-stage cp.async ring of (bkv x D) K and V tiles, so
// tile t+1 is in flight while tile t is computed.  Q.K^T and P.V are
// mma.sync m16n8k16 (bf16 x bf16 -> fp32) with operands loaded by
// ldmatrix (V with .trans).  The score and output accumulators live in
// registers: the fp32 score fragment of a warp is rounded to bf16 and
// reused in place as the A operand of P.V, and row max and row sum are
// reduced with quad shuffles.  Q stays in shared memory and its
// fragments are reloaded every k step, which keeps a D = 256 warp at
// 128 accumulator registers a thread (16 x 256 fp32 over 32 lanes) plus
// the score tile.  Head dims 16, 32, 64, 80, 128 and 256 are instantiated
// with kv tiles of 16, 32 and 64 keys (bkv * D <= 8192: the register
// budget).  Nothing assumes a power-of-two D: it is D / 16 k steps of
// Q.K^T and D / 8 output n-tiles (taken in pairs, so D / 16 whole), one
// ldmatrix.x4 a pair; zamba2-2.7b's D = 80 (2560 / 32 heads) is five k
// steps and ten n-tiles, a 160-byte row padded to 176 bytes (44 words:
// the eight rows an ldmatrix reads start on distinct 16-byte bank
// groups).  Shared memory is 2 * (D + 8) * (bq + 4 * bkv) bytes: Q and
// two stages of K and V, rows padded by 16 bytes so that ldmatrix reads
// without bank conflicts.  A warp whose 16 rows all lie before a kv
// tile (causal) skips its products for that tile, exactly as above.
//
// fp32: CUDA cores (flash_attention_kernel), kept from the first port:
// tensor cores would mean TF32, and the fp32 checks hold 2e-5.  q, the
// current k and v tiles, the score tile and the (bq x D) fp32 output
// accumulator all live in shared memory; rows of q and k are padded by
// one float against bank conflicts; scores and P.V are fp32 FMA.
//
// Bound on the H100: for the serving prefill (one sequence of a few
// hundred tokens at most, D = 256, or D = 80 for zamba2) the work is at most 4 * Sq * Skv * D
// FLOP per head, a few hundred MFLOP per layer, and the bytes (q, k, v,
// o once each) are a few MB: both bounds are a few microseconds, so the
// kernel is bound by its own latency, the serial chain of kv tiles of
// the last q tile (see PERF.md for the measured time).
//
// Every launch allocates nothing and runs on the caller's stream; each C
// entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ inline int smem_floats(int D, int bq, int bkv) {
  const int ldd = D + 1;
  return bq * ldd + bkv * ldd + bkv * D + bq * D + bq * bkv + 3 * bq;
}

__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           const int* __restrict__ q_lens,
                           const int* __restrict__ kv_lens,
                           const int* __restrict__ q_offsets, int H, int Sq,
                           int Skv, int D, int bq, int bkv, float scale,
                           int causal) {
  extern __shared__ float sm[];
  const int ldd = D + 1;
  float* sq = sm;                   // (bq, D+1)
  float* sk = sq + bq * ldd;        // (bkv, D+1)
  float* sv = sk + bkv * ldd;       // (bkv, D)
  float* sacc = sv + bkv * D;       // (bq, D) fp32 output accumulator
  float* sp = sacc + bq * D;        // (bq, bkv) scores, then p
  float* smax = sp + bq * bkv;      // (bq,) running max
  float* sden = smax + bq;          // (bq,) running denominator
  float* salpha = sden + bq;        // (bq,) this tile's rescale

  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * bq;
  const int q_len = q_lens[b], kv_len = kv_lens[b], q_off = q_offsets[b];
  const size_t base_q = (size_t)bh * Sq * D;
  const size_t base_kv = (size_t)bh * Skv * D;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nt / 32;

  for (int idx = tid; idx < bq * D; idx += nt) {
    const int i = idx / D, d = idx - i * D;
    sq[i * ldd + d] = (q0 + i < Sq) ? q[base_q + (size_t)(q0 + i) * D + d]
                                    : 0.f;
    sacc[idx] = 0.f;
  }
  for (int i = tid; i < bq; i += nt) {
    smax[i] = kNegInf;
    sden[i] = 0.f;
  }

  // the kv extent this tile's valid rows can see; tiles past it would
  // contribute exactly zero
  int kv_end = min(Skv, kv_len);
  if (causal) kv_end = min(kv_end, q_off + q0 + bq);
  if (q_off + q0 >= q_len) kv_end = 0;
  __syncthreads();

  for (int kv0 = 0; kv0 < kv_end; kv0 += bkv) {
    for (int idx = tid; idx < bkv * D; idx += nt) {
      const int j = idx / D, d = idx - j * D;
      const bool in = kv0 + j < Skv;
      const size_t g = base_kv + (size_t)(kv0 + j) * D + d;
      sk[j * ldd + d] = in ? k[g] : 0.f;
      sv[idx] = in ? v[g] : 0.f;
    }
    __syncthreads();

    for (int idx = tid; idx < bq * bkv; idx += nt) {
      const int i = idx / bkv, j = idx - i * bkv;
      const float* qr = sq + i * ldd;
      const float* kr = sk + j * ldd;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      const int row = q_off + q0 + i, col = kv0 + j;
      const bool ok =
          row < q_len && col < kv_len && (!causal || row >= col);
      sp[idx] = ok ? s * scale : kNegInf;
    }
    __syncthreads();

    for (int i = warp; i < bq; i += nwarps) {
      float* pr = sp + i * bkv;
      float mx = kNegInf;
      for (int j = lane; j < bkv; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_prev = smax[i];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int j = lane; j < bkv; j += 32) {
        // while the row has seen no valid column, m_new == -1e30 and
        // exp(s - m_new) would be 1 for masked entries: force p to 0
        const float p = m_new > 0.5f * kNegInf ? expf(pr[j] - m_new) : 0.f;
        sum += p;
        pr[j] = p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        smax[i] = m_new;
        sden[i] = alpha * sden[i] + sum;
        salpha[i] = alpha;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < bq * D; idx += nt) {
      const int i = idx / D, d = idx - i * D;
      const float* pr = sp + i * bkv;
      float a = sacc[idx] * salpha[i];
      for (int j = 0; j < bkv; ++j) a = fmaf(pr[j], sv[j * D + d], a);
      sacc[idx] = a;
    }
    __syncthreads();
  }

  const int rows = min(bq, Sq - q0);
  for (int idx = tid; idx < rows * D; idx += nt) {
    const int i = idx / D;
    const float den = sden[i];
    o[base_q + (size_t)q0 * D + idx] =
        sacc[idx] / (den == 0.f ? 1.f : den);
  }
}

// ---- bf16 on the tensor cores ----------------------------------------
constexpr int kPad = 8;  // bf16 elements of row padding: 16 bytes

__host__ __device__ inline int tc_smem_bytes(int D, int bq, int bkv) {
  return 2 * (D + kPad) * (bq + 4 * bkv);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when src_bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// bf16 x bf16 -> fp32, 16 x 8 x 16; b0, b1 the two B registers
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One block of bq / 16 warps per (b*h, q tile of bq = blockDim.x / 2
// rows); scale_log2 = scale * log2(e): scores are kept in the base-2
// domain, so p = exp2(s - m) is the reference's exp(s*scale - m').
template <int D, int BKV>
__global__ void __launch_bounds__(128, 1)
    flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o,
                    const int* __restrict__ q_lens,
                    const int* __restrict__ kv_lens,
                    const int* __restrict__ q_offsets, int H, int Sq,
                    int Skv, float scale_log2, int causal) {
  constexpr int LD = D + kPad;  // smem row stride (elements)
  constexpr int NT = BKV / 8;   // score n-tiles of a warp
  constexpr int DT = D / 8;     // output n-tiles of a warp
  constexpr int CPR = D / 8;    // 16-byte chunks of one row
  static_assert(D % 16 == 0 && BKV % 16 == 0, "whole mma k steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bq = blockDim.x / 2;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + bq * LD;       // 2 stages of (BKV, LD)
  __nv_bfloat16* sv = sk + 2 * BKV * LD;  // 2 stages of (BKV, LD)

  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * bq;
  const int q_len = q_lens[b], q_off = q_offsets[b];
  const int kv_lim = min(Skv, kv_lens[b]);  // columns past it are masked
  const size_t base_q = (size_t)bh * Sq * D;
  const size_t base_kv = (size_t)bh * Skv * D;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;

  // the kv extent this tile's valid rows can see
  int kv_end = kv_lim;
  if (causal) kv_end = min(kv_end, q_off + q0 + min(bq, Sq - q0));
  if (q_off + q0 >= q_len) kv_end = 0;
  const int ntiles = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;

  // rows r0 .. r0 + rows - 1 of src (R rows of D) into dst, zero past R
  auto load_rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* src,
                       int rows, int r0, int R) {
    for (int i = tid; i < rows * CPR; i += nt) {
      const int r = i / CPR, c = (i - r * CPR) * 8;
      const bool ok = r0 + r < R;
      cp_async16(dst + r * LD + c, ok ? src + (size_t)(r0 + r) * D + c : src,
                 ok ? 16 : 0);
    }
  };

  float oacc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[d][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // this thread's two rows (absolute positions) and its warp's last row
  const int row0 = q_off + q0 + warp * 16 + lane / 4;
  const int warp_last = q_off + q0 + warp * 16 + 15;

  if (ntiles > 0) {
    load_rows(sq, q + base_q, bq, q0, Sq);
    load_rows(sk, k + base_kv, BKV, 0, Skv);
    load_rows(sv, v + base_kv, BKV, 0, Skv);
  }
  cp_async_commit();

  for (int t = 0; t < ntiles; ++t) {
    const int kv0 = t * BKV;
    if (t + 1 < ntiles) {
      const int s = (t + 1) & 1;
      load_rows(sk + s * BKV * LD, k + base_kv, BKV, kv0 + BKV, Skv);
      load_rows(sv + s * BKV * LD, v + base_kv, BKV, kv0 + BKV, Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* ck = sk + (t & 1) * BKV * LD;
    const __nv_bfloat16* cv = sv + (t & 1) * BKV * LD;

    if (!causal || kv0 <= warp_last) {  // warp-uniform
      // S = Q K^T for this warp's 16 rows and the tile's BKV columns
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t af[4];
        ldmatrix_x4(af, sq + (warp * 16 + lane % 16) * LD + kk +
                            (lane / 16) * 8);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, ck + (n * 8 + (lane / 16) * 8 + lane % 8) * LD +
                              kk + ((lane / 8) % 2) * 8);
          mma(s[n], af, bk[0], bk[1]);
          mma(s[n + 1], af, bk[2], bk[3]);
        }
      }
      // scale and mask; element e of n-tile n is row row0 + (e/2)*8,
      // column kv0 + n*8 + (lane%4)*2 + e%2
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e / 2) * 8;
          const int col = kv0 + n * 8 + (lane % 4) * 2 + (e % 2);
          const bool ok =
              row < q_len && col < kv_lim && (!causal || row >= col);
          s[n][e] = ok ? s[n][e] * scale_log2 : kNegInf;
        }
      // online softmax, one row pair per thread, reduced over the quad
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx));
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
      // p (rounded to bf16 in place as P.V's A fragments); the row sum
      // takes the unrounded p, as the reference does
      uint32_t pf[NT][2];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // while the row has seen no valid column, m == -1e30 and
          // exp2(s - m) would be 1 for masked entries: force p to 0
          const bool live = m[r] > 0.5f * kNegInf;
          const float p0 = live ? exp2f(s[n][2 * r] - m[r]) : 0.f;
          const float p1 = live ? exp2f(s[n][2 * r + 1] - m[r]) : 0.f;
          rs[r] += p0 + p1;
          pf[n][r] = pack_bf16(p0, p1);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        oacc[d][0] *= alpha[0];
        oacc[d][1] *= alpha[0];
        oacc[d][2] *= alpha[1];
        oacc[d][3] *= alpha[1];
      }
      // O += P V, 16 keys a k step
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) {
        const uint32_t pa[4] = {pf[2 * j][0], pf[2 * j][1], pf[2 * j + 1][0],
                                pf[2 * j + 1][1]};
#pragma unroll
        for (int d = 0; d < DT; d += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, cv + (j * 16 + lane % 16) * LD + d * 8 +
                                    (lane / 16) * 8);
          mma(oacc[d], pa, bv[0], bv[1]);
          mma(oacc[d + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // a row with l == 0 saw no valid column: its accumulator is 0 and it is
  // written as exact zeros
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = quad_sum(l[r]);
    const float safe = den == 0.f ? 1.f : den;
    const int i = q0 + warp * 16 + lane / 4 + r * 8;
    if (i >= Sq) continue;
    uint32_t* out = reinterpret_cast<uint32_t*>(o + base_q + (size_t)i * D +
                                                (lane % 4) * 2);
#pragma unroll
    for (int d = 0; d < DT; ++d)
      out[d * 4] = pack_bf16(oacc[d][2 * r] / safe, oacc[d][2 * r + 1] / safe);
  }
}

// Launch flash_tc_kernel<D, BKV> with bq / 16 warps.
template <int D, int BKV>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              const void* q_lens, const void* kv_lens, const void* q_offsets,
              int B, int H, int Sq, int Skv, int bq, float scale, int causal,
              cudaStream_t stream) {
  auto kern = flash_tc_kernel<D, BKV>;
  const int smem = tc_smem_bytes(D, bq, BKV);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static int configured = 48 * 1024;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  const float kLog2e = 1.4426950408889634f;
  dim3 grid((Sq + bq - 1) / bq, B * H);
  kern<<<grid, bq * 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<const int*>(q_lens), static_cast<const int*>(kv_lens),
      static_cast<const int*>(q_offsets), H, Sq, Skv, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

// The instantiated (D, bkv) pairs: D in {16, 32, 64, 80, 128, 256}, bkv in
// {16, 32, 64} with bkv * D <= 8192; bq in {16, 32, 64}.
int dispatch_tc(const void* q, const void* k, const void* v, void* o,
                const void* q_lens, const void* kv_lens,
                const void* q_offsets, int B, int H, int Sq, int Skv, int D,
                int bq, int bkv, float scale, int causal,
                cudaStream_t stream) {
  if (bq != 16 && bq != 32 && bq != 64) return (int)cudaErrorInvalidValue;
#define REPRO_FLASH_TC(DD, KV)                                               \
  if (D == DD && bkv == KV)                                                  \
    return launch_tc<DD, KV>(q, k, v, o, q_lens, kv_lens, q_offsets, B, H,  \
                             Sq, Skv, bq, scale, causal, stream);
#define REPRO_FLASH_TC_D(DD) \
  REPRO_FLASH_TC(DD, 16) REPRO_FLASH_TC(DD, 32) REPRO_FLASH_TC(DD, 64)
  REPRO_FLASH_TC_D(16)
  REPRO_FLASH_TC_D(32)
  REPRO_FLASH_TC_D(64)
  REPRO_FLASH_TC_D(80)
  REPRO_FLASH_TC_D(128)
  REPRO_FLASH_TC(256, 16)
  REPRO_FLASH_TC(256, 32)
#undef REPRO_FLASH_TC_D
#undef REPRO_FLASH_TC
  return (int)cudaErrorInvalidValue;
}

// Launch the CUDA-core design (flash_attention_kernel, fp32).
int launch_fp32(const void* q, const void* k, const void* v, void* o,
           const void* q_lens, const void* kv_lens, const void* q_offsets,
           int B, int H, int Sq, int Skv, int D, int bq, int bkv, float scale,
           int causal, cudaStream_t stream) {
  auto kern = flash_attention_kernel;
  const int smem = smem_floats(D, bq, bkv) * (int)sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static int configured = 48 * 1024;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  dim3 grid((Sq + bq - 1) / bq, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<const int*>(q_lens), static_cast<const int*>(kv_lens),
      static_cast<const int*>(q_offsets), H, Sq, Skv, D, bq, bkv, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// o (B, H, Sq, D) = masked softmax(q k^T * scale) v; q_lens, kv_lens and
// q_offsets are int32 (B,) device arrays.  bf16 runs the tensor-core
// design (bq, bkv and D as dispatch_tc lists them), fp32 the CUDA-core
// design (any bq, bkv within shared memory).
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    const void* q_lens, const void* kv_lens,
                    const void* q_offsets, int B, int H, int Sq, int Skv,
                    int D, int bq, int bkv, float scale, int causal,
                    int dtype_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_bf16)
    return dispatch_tc(q, k, v, o, q_lens, kv_lens, q_offsets, B, H, Sq, Skv,
                       D, bq, bkv, scale, causal, s);
  return launch_fp32(q, k, v, o, q_lens, kv_lens, q_offsets, B, H, Sq, Skv, D,
                     bq, bkv, scale, causal, s);
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
