// Paged decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention
// (Pallas TPU kernel, body `_kernel` at line 48, `pl.pallas_call` at
// line 141).
//
// What it computes: one decode query per sequence, q (B, H, D), against
// a shared page pool k_pool / v_pool (P, ps, KV, D), all contiguous and
// of one dtype (bf16 or fp32), through an int32 page table (B, T) that
// maps sequence b's logical page j to physical page page_table[b*T + j],
// and int32 kv_lens (B,).  H = KV * rep: the rep query heads that share
// one kv head are the rows of one block, so each gathered page is read
// once per kv head.  Scores are q.k * scale in fp32; column j*ps + c is
// valid when it is < kv_len, otherwise -1e30.  Online softmax over the
// pages: while a row's running max is still -1e30 its p is forced to 0,
// p is rounded to the input dtype before P.V (as the Pallas kernel
// does), and a row whose denominator stays 0 (kv_len <= 0) is written
// as exact zeros.  The output takes q's dtype.
//
// Design.  One block of 128 threads per (b, kv head): grid B*KV.  The
// TPU's sequential page axis of the grid becomes a loop inside the
// block, and scalar prefetch becomes the block reading its own kv_len
// and page ids.  A page's rows for one kv head lie KV*D elements apart
// and each row's D elements are contiguous, so a page is copied with
// 16-byte cp.async loads (D*sizeof(T) must be a multiple of 16) into a
// two-stage shared-memory ring: page j+1 is in flight while page j is
// computed.  Offsets into the pool are 64-bit (pid*ps*KV*D exceeds 2^31
// for a large pool).  Scores: one warp per (row, column) pair, lanes
// split D, a shuffle reduction; P.V: threads over (row, d) with the
// fp32 accumulator in shared memory (rep*D floats).  CUDA-core FMA is
// enough: rep <= 8 is far below the 64 rows a wgmma needs.
//
// Pages past kv_len are skipped, which is exact: a fully masked page
// adds p = 0 with a rescale of 1.  The page count is also clamped to T:
// the engine advances pos for every slot at every step (frozen, retired
// and never-admitted rows too), so kv_len = pos + 1 can exceed T*ps, and
// the loop must not walk past the table row.
//
// Bound on the H100: bytes.  The work is 4*rep*D FLOP per key and kv
// head against 2*D*sizeof(T) bytes of K and V, about rep FLOP per byte,
// far below the ~295 FLOP/byte where the tensor cores become the limit.
// The least time is sum_b min(kv_len_b, T*ps) * KV * D * 2 * sizeof(T)
// bytes over 3.35 TB/s: at the serving shape (4 slots, kv <= 160, 16 kv
// heads of 256, bf16) at most 10.5 MB, about 3.1 us.  With B*KV = 64
// blocks for 132 SMs and one page in flight per block the kernel is
// bound by latency well above that (see PERF.md for the measured time);
// split-KV across blocks is later work.
//
// Every launch allocates nothing and runs on the caller's stream; the C
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two stages of one K page and one V page in the input dtype, then fp32
// q, accumulator, scores, running max, denominator and rescale
inline size_t smem_bytes(int D, int ps, int rep, int elt) {
  return (size_t)4 * ps * D * elt +
         sizeof(float) * ((size_t)2 * rep * D + (size_t)rep * ps + 3 * rep);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q,
                           const T* __restrict__ k_pool,
                           const T* __restrict__ v_pool, T* __restrict__ o,
                           const int* __restrict__ page_table,
                           const int* __restrict__ kv_lens, int KV, int T_len,
                           int ps, int D, int rep, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int page_elems = ps * D;
  T* sbuf = reinterpret_cast<T*>(smem);  // stage s: K at 2*s, V at 2*s+1
  float* sq = reinterpret_cast<float*>(sbuf + 4 * page_elems);  // (rep, D)
  float* sacc = sq + rep * D;      // (rep, D) fp32 output accumulator
  float* sp = sacc + rep * D;      // (rep, ps) scores, then p
  float* smax = sp + rep * ps;     // (rep,) running max
  float* sden = smax + rep;        // (rep,) running denominator
  float* salpha = sden + rep;      // (rep,) this page's rescale

  const int g = blockIdx.x;        // b * KV + kv head
  const int b = g / KV, kvh = g - b * KV;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nt / 32;
  const int kv_len = kv_lens[b];
  // pages that hold a valid column, and never more than the table has
  const int n_pages = kv_len <= 0 ? 0 : min(T_len, (kv_len - 1) / ps + 1);
  const int* pt = page_table + (size_t)b * T_len;

  const size_t q_base = (size_t)g * rep * D;  // q as (B*KV, rep, D)
  for (int idx = tid; idx < rep * D; idx += nt) {
    sq[idx] = to_f(q[q_base + idx]);
    sacc[idx] = 0.f;
  }
  for (int r = tid; r < rep; r += nt) {
    smax[r] = kNegInf;
    sden[r] = 0.f;
  }

  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  const int row_vecs = D / kVec;
  const size_t row_stride = (size_t)KV * D;  // between a page's rows

  auto load_page = [&](int j, int stage) {
    const size_t base =
        (size_t)pt[j] * ps * row_stride + (size_t)kvh * D;
    T* sk = sbuf + (size_t)(2 * stage) * page_elems;
    T* sv = sk + page_elems;
    for (int idx = tid; idx < ps * row_vecs; idx += nt) {
      const int c = idx / row_vecs, w = idx - c * row_vecs;
      const size_t src = base + (size_t)c * row_stride + (size_t)w * kVec;
      cp_async16(sk + (size_t)idx * kVec, k_pool + src);
      cp_async16(sv + (size_t)idx * kVec, v_pool + src);
    }
    cp_async_commit();
  };

  if (n_pages > 0) load_page(0, 0);
  for (int j = 0; j < n_pages; ++j) {
    if (j + 1 < n_pages) {
      load_page(j + 1, (j + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // page j (and, at j = 0, sq and the state) visible
    const T* sk = sbuf + (size_t)(2 * (j & 1)) * page_elems;
    const T* sv = sk + page_elems;

    // scores: one warp per (row, column) pair, lanes split D
    for (int pair = warp; pair < rep * ps; pair += nwarps) {
      const int r = pair / ps, c = pair - r * ps;
      const float* qr = sq + r * D;
      const T* kr = sk + c * D;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s = fmaf(qr[d], to_f(kr[d]), s);
      s = warp_sum(s);
      if (lane == 0) sp[pair] = (j * ps + c < kv_len) ? s * scale : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int r = warp; r < rep; r += nwarps) {
      float* pr = sp + r * ps;
      float mx = kNegInf;
      for (int c = lane; c < ps; c += 32) mx = fmaxf(mx, pr[c]);
      mx = warp_max(mx);
      const float m_prev = smax[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int c = lane; c < ps; c += 32) {
        // while the row has seen no valid column, m_new == -1e30 and
        // exp(s - m_new) would be 1 for masked entries: force p to 0
        const float p = m_new > 0.5f * kNegInf ? expf(pr[c] - m_new) : 0.f;
        sum += p;
        pr[c] = round_to<T>(p);
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        smax[r] = m_new;
        sden[r] = alpha * sden[r] + sum;
        salpha[r] = alpha;
      }
    }
    __syncthreads();

    // P.V into the accumulator: threads over (row, d)
    for (int idx = tid; idx < rep * D; idx += nt) {
      const int r = idx / D, d = idx - r * D;
      const float* pr = sp + r * ps;
      float a = sacc[idx] * salpha[r];
      for (int c = 0; c < ps; ++c) a = fmaf(pr[c], to_f(sv[c * D + d]), a);
      sacc[idx] = a;
    }
    __syncthreads();  // this stage is free for the copy issued next
  }
  __syncthreads();  // with no page at all, the zeroed state is visible

  for (int idx = tid; idx < rep * D; idx += nt) {
    const float den = sden[idx / D];
    o[q_base + idx] = from_f<T>(sacc[idx] / (den == 0.f ? 1.f : den));
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, void* o,
           const void* page_table, const void* kv_lens, int B, int KV,
           int T_len, int ps, int D, int rep, float scale,
           cudaStream_t stream) {
  auto kern = paged_attention_kernel<T>;
  if ((D * (int)sizeof(T)) % 16 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D, ps, rep, (int)sizeof(T));
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static int configured = 48 * 1024;
  if ((int)smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = (int)smem;
  }
  kern<<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<T*>(o),
      static_cast<const int*>(page_table), static_cast<const int*>(kv_lens),
      KV, T_len, ps, D, rep, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// o (B, KV*rep, D) = softmax over the valid columns of q k^T * scale,
// times v, with k and v gathered from the (P, ps, KV, D) pools through
// the int32 (B, T) page table; kv_lens is an int32 (B,) device array.
int paged_attention(const void* q, const void* k_pool, const void* v_pool,
                    void* o, const void* page_table, const void* kv_lens,
                    int B, int KV, int T_len, int ps, int D, int rep,
                    float scale, int dtype_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_bf16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, o, page_table, kv_lens,
                                 B, KV, T_len, ps, D, rep, scale, s);
  return launch<float>(q, k_pool, v_pool, o, page_table, kv_lens, B, KV,
                       T_len, ps, D, rep, scale, s);
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
