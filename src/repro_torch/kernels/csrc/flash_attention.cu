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
// row whose denominator stays 0 is written as exact zeros.  The output
// takes q's dtype.
//
// Design.  One thread block of 128 threads per (b*h, q tile of bq rows);
// the kv loop runs inside the block and takes the place of the TPU's
// sequential kv grid axis.  q, the current k and v tiles, the score tile
// and the (bq x D) fp32 output accumulator all live in shared memory,
// converted to fp32 on load: at D = 256 a 32-row accumulator is 32 KB,
// which does not fit in registers at 4 warps, so the accumulator sits in
// shared memory (bq = bkv = 32 by default; 136 KB in all at D = 256).
// Rows of q and k are padded by one float so that the score loop reads
// without bank conflicts.  The scores and P.V are fp32 FMA on the CUDA
// cores; P is rounded to the input dtype before P.V, as the reference
// does.  kv tiles that lie wholly past kv_len or past the causal frontier
// of the tile's last row are skipped: they would add exactly nothing, so
// the result is unchanged.
//
// Bound on the H100: for the serving prefill (one sequence of <= a few
// hundred tokens, D = 256) the work is 4 * Sq * Skv * D FLOP per head,
// a few hundred MFLOP per layer; bytes (q, k, v, o once each) and
// operations are both small, so the kernel is bound by its own latency
// and by CUDA-core FMA throughput, not by the card's peaks.  Tensor-core
// (mma.sync / wgmma) products, register accumulators and cp.async
// staging of k/v are later work (see PERF.md for the measured time).
//
// Every launch allocates nothing and runs on the caller's stream; each C
// entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p as the P.V product sees it: rounded to the input dtype
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
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
    sq[i * ldd + d] = (q0 + i < Sq) ? to_f(q[base_q + (size_t)(q0 + i) * D + d])
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
      sk[j * ldd + d] = in ? to_f(k[g]) : 0.f;
      sv[idx] = in ? to_f(v[g]) : 0.f;
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
        pr[j] = round_to<T>(p);
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
        from_f<T>(sacc[idx] / (den == 0.f ? 1.f : den));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const void* q_lens, const void* kv_lens, const void* q_offsets,
           int B, int H, int Sq, int Skv, int D, int bq, int bkv, float scale,
           int causal, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T>;
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
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<const int*>(q_lens), static_cast<const int*>(kv_lens),
      static_cast<const int*>(q_offsets), H, Sq, Skv, D, bq, bkv, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// o (B, H, Sq, D) = masked softmax(q k^T * scale) v; q_lens, kv_lens and
// q_offsets are int32 (B,) device arrays.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    const void* q_lens, const void* kv_lens,
                    const void* q_offsets, int B, int H, int Sq, int Skv,
                    int D, int bq, int bkv, float scale, int causal,
                    int dtype_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_bf16)
    return launch<__nv_bfloat16>(q, k, v, o, q_lens, kv_lens, q_offsets, B, H,
                                 Sq, Skv, D, bq, bkv, scale, causal, s);
  return launch<float>(q, k, v, o, q_lens, kv_lens, q_offsets, B, H, Sq, Skv,
                       D, bq, bkv, scale, causal, s);
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
