// Paged decode attention for Hopper (sm_90a), split over the kv pages.
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
// valid when it is < kv_len.  Online softmax: p is rounded to the input
// dtype before P.V (as the Pallas kernel does), and a row that sees no
// valid column (kv_len <= 0) is written as exact zeros.  The page walk is
// clamped to T: the engine advances pos for every slot at every step, so
// kv_len = pos + 1 can exceed T*ps.  The output takes q's dtype.
//
// Bound on the H100: bytes.  The work is 4*rep*D FLOP per key and kv
// head against 2*D*sizeof(T) bytes of K and V, about rep FLOP per byte,
// far below the ~295 FLOP/byte where the tensor cores become the limit,
// so CUDA-core FMA is enough.  The least time is
// sum_b min(kv_len_b, T*ps) * KV * D * 2 * sizeof(T) bytes over
// 3.35 TB/s: at the paged serving shape (4 slots, 480 keys, 16 kv heads
// of 256, bf16) 7.9 MB, 2.4 us.
//
// Design (split-KV).  The TPU's sequential page axis of the grid is cut
// into `splits` contiguous ranges of `per` logical pages: grid
// (B * KV * row chunks, splits), 128 threads a block, so the B * KV rows
// of a decode batch (64 at the serving shape) fill the 132 SMs about
// two blocks deep.  The wrapper picks splits from B, KV, T and the SM
// count, never from kv_lens, which live on the device: no host sync, and
// the launch can be captured in a CUDA graph.  A split whose range lies
// past its row's kv_len copies nothing and yields m = -1e30, l = 0.
//   - The pages of a split stream through a ring of two windows of W
//     pages (`stages` = 2W, W = 2 unless a split has one page or shared
//     memory runs out): while the block computes one window, the next is
//     in flight.  A page row of one kv head is D contiguous elements,
//     rows KV*D apart, so warp 0 issues one bulk copy (cp.async.bulk, the
//     TMA engine) a K or V row below kv_len, completing on the page's
//     mbarrier.  The first window's page ids are read beside kv_len, the
//     next window's a window ahead.  One block barrier a window frees its
//     slots for the refill.
//   - Each warp takes keys of the window by groups of L lanes (L = the
//     page row's 16-byte vectors rounded up to a power of two, up to
//     32), so a warp holds 32 / L keys at once; where the row is not a
//     power-of-two count of vectors (zamba2's D = 80 in bf16: 10 vectors
//     in a group of 16) the group's last lanes hold no vector, load and
//     store nothing, and add exact zeros to the group's shuffle sums,
//     whose offsets (L/2 .. 1, then L .. 16 across groups) stay inside
//     the power-of-two group; and each group takes KK keys a pass (KK * ROWS = 4 where
//     the rows allow): 4 warps then take a 16-key page a pass, and a
//     pass's dot products, shuffle reductions and exponentials are
//     independent chains.  A lane keeps its slice of q and of the output
//     accumulator for the block's `ROWS` query rows in registers and runs
//     its own online softmax (m, l, acc), one rescale a pass; masked keys
//     are skipped, which is exact (p = 0 with a rescale of 1).  Four
//     warps, not eight: at 128 threads a block three blocks fit an SM at
//     the serving shape (its shared memory), so 320 blocks run in one
//     wave; 256-thread blocks fit two by their registers.
//   - At the end the key groups of a warp merge by shuffles and the
//     warps through shared memory (the ring's space), in a fixed order.
//     With one split the block writes o; otherwise it writes its split's
//     (m, l, acc) in fp32 to a workspace of B * KV * splits * rep * (D + 2)
//     floats, and a second launch, a programmatic dependent of the first
//     (it is launched while the first runs and waits for its results),
//     folds the splits in order: weight exp(m_s - m) for a split with
//     l_s > 0 and 0 for an empty one, one division, exact zeros when every
//     split is empty.  The sums run in a fixed order, so a call gives the
//     same bits every time.
// What bounds it on the card (PERF.md, phase 6 of chip_smoke.py): at the
// serving shape the call is far above its 2.4 us of bytes; the two
// launches, the dependent loads before the first copy (kv_len, page ids)
// and the latency of each page's pass, not the bytes, set its time.
// The split changes where p is rounded (against a key group's running
// max, not the row's), so bf16 agrees with the plain version within its
// tolerance, not bit for bit; fp32 within 2e-5.
//
// Every launch allocates nothing and runs on the caller's stream; the C
// entry point returns cudaGetLastError() or the error of a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSmem = 232448;
constexpr int kMaxLaneFloats = 64;  // q or acc floats a lane may hold
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

// 16 bytes of T from shared memory as floats
__device__ __forceinline__ void load16(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&o)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x, o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and bulk copies (the TMA engine, no tensor map) ----------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive on bar and expect `bytes` more of copies in this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed
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

// `bytes` (a multiple of 16, 16-byte aligned ends) from global src to
// shared dst, completing on the mbarrier bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared memory of one block (the formula of
// kernels/paged_attention.py::smem_bytes): the ring of `stages` K and V
// pages, or, if larger, the warps' fp32 (acc, m, l) of `rows` query rows
// that the merge writes over the ring once every page is consumed; then
// the stages' mbarriers (room for four).
__host__ __device__ inline size_t ring_bytes(int D, int ps, int rows,
                                             int elt, int stages) {
  const size_t ring = (size_t)stages * 2 * ps * D * elt;
  const size_t merge = (size_t)kWarps * rows * (D + 2) * sizeof(float);
  return ring > merge ? ring : merge;
}
inline size_t smem_bytes(int D, int ps, int rows, int elt, int stages) {
  return ring_bytes(D, ps, rows, elt, stages) + 4 * sizeof(uint64_t);
}

// Fold one part (m_p, l_p, acc_p) of a row into the running (m, l, acc):
// both rescaled to the larger max; a part with l_p == 0 (no key) weighs 0.
__device__ __forceinline__ void merge_part(float mp, float lp, float ap,
                                           float& m, float& l, float& acc) {
  if (lp > 0.f) {
    const float mn = fmaxf(m, mp);
    const float wa = expf(m - mn), wp = expf(mp - mn);
    l = fmaf(lp, wp, l * wa);
    acc = fmaf(ap, wp, acc * wa);
    m = mn;
  }
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  void* o;
  const int* page_table;
  const int* kv_lens;
  float* ws_acc;  // (B*KV, splits, rep, D) when splits > 1
  float* ws_ml;   // (B*KV, splits, rep, 2): m, l
  int KV, T_len, ps, D, rep, splits, per, stages, row_chunks;
  float scale;
};

// One block: query rows r0 .. r0 + ROWS - 1 of kv head (b, kvh) over the
// logical pages of split blockIdx.y.  A lane holds NV 16-byte vectors of
// each of the block's q rows and of its accumulator rows.
template <typename T, int ROWS, int NV>
__global__ void __launch_bounds__(kThreads, 1)  // ptxas spills without the 1
    paged_split_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VEC = 16 / sizeof(T);
  // keys a key group takes a pass: independent chains of loads, shuffles
  // and exponentials where the rows alone give too few
  constexpr int KK = ROWS >= 4 ? 1 : 4 / ROWS;
  // the combine launch may start now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ kp = static_cast<const T*>(a.k_pool);
  const T* __restrict__ vp = static_cast<const T*>(a.v_pool);
  const int g = blockIdx.x / a.row_chunks;  // b * KV + kv head
  const int r0 = (blockIdx.x - g * a.row_chunks) * ROWS;
  const int b = g / a.KV, kvh = g - b * a.KV;
  const int split = blockIdx.y;
  const int nrows = min(ROWS, a.rep - r0);
  const int D = a.D, ps = a.ps;
  const int nvec = D / VEC;  // 16-byte vectors of a page row
  int L = 1;                 // lanes a key
  while (L < nvec && L < 32) L <<= 1;
  const int kpw = 32 / L;    // keys a warp holds at once
  const int step = kWarps * kpw;  // keys between a group's keys in a pass
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int li = lane % L;
  const int W = a.stages / 2;  // pages a window; the ring holds two
  const int p0 = split * a.per;
  const int* pt = a.page_table + (size_t)b * a.T_len;

  // the first window's page ids, read beside kv_len (inside the table)
  int pid0[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    pid0[i] = i < W && p0 + i < a.T_len ? pt[p0 + i] : 0;
  const int kv_len = a.kv_lens[b];
  // pages that hold a valid column, never more than the table has
  const int n_pages = kv_len <= 0 ? 0 : min(a.T_len, (kv_len - 1) / ps + 1);
  const int npg = max(0, min(p0 + a.per, n_pages) - p0);

  const size_t qrow0 = (size_t)g * a.rep + r0;  // q as (B*KV*rep, D)
  float qv[ROWS][NV][VEC], acc[ROWS][NV][VEC], m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = li + i * L;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        acc[r][i][e] = 0.f;
        qv[r][i][e] = (r < nrows && v < nvec)
                          ? to_f(q[(qrow0 + r) * D + v * VEC + e])
                          : 0.f;
      }
    }
  }

  const size_t page_elems = (size_t)ps * D;
  T* ring = reinterpret_cast<T*>(smem);  // slot s: K at 2s, V at 2s + 1
  const size_t row_stride = (size_t)a.KV * D;  // between a page's rows
  // the slots' full barriers, after the ring
  const uint32_t bars =
      smem_addr(smem) + (uint32_t)ring_bytes(D, ps, ROWS, sizeof(T), a.stages);
  if (tid == 0) {
    for (int st = 0; st < a.stages; ++st) mbar_init(bars + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp 0 copies the valid rows of the split's page jj (physical page
  // pid) into slot jj % stages, a bulk copy a K or V row, and arms the
  // slot's barrier with their bytes; nothing past the split
  const uint32_t row_bytes = D * sizeof(T);
  auto issue = [&](int jj, int pid) {
    if (jj >= npg || warp != 0) return;
    const int valid = min(ps, kv_len - (p0 + jj) * ps);
    const uint32_t full = bars + 8 * (jj % a.stages);
    if (lane == 0) mbar_expect_tx(full, 2 * valid * row_bytes);
    __syncwarp();
    const size_t base = (size_t)pid * ps * row_stride + (size_t)kvh * D;
    const T* sk = ring + (size_t)(2 * (jj % a.stages)) * page_elems;
    for (int c = lane; c < 2 * valid; c += 32) {
      const bool v = c >= valid;
      const int row = v ? c - valid : c;
      bulk_copy(smem_addr(sk + (v ? page_elems : 0) + (size_t)row * D),
                (v ? vp : kp) + base + (size_t)row * row_stride, row_bytes,
                full);
    }
  };
  // the physical id of the split's page jj, 0 past the split
  auto page_id = [&](int jj) { return jj < npg ? pt[p0 + jj] : 0; };

#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (i < W) issue(i, pid0[i]);
  // the next window's ids are read a window ahead of its copies
  int nxt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) nxt[i] = i < W ? page_id(W + i) : 0;
  for (int w0 = 0; w0 < npg; w0 += W) {  // the window of pages w0 ..
    __syncthreads();  // every warp is done with the previous window
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (i < W) issue(w0 + W + i, nxt[i]);  // into its slots
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (i < W) nxt[i] = page_id(w0 + 2 * W + i);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (i < W && w0 + i < npg)
        mbar_wait(bars + 8 * ((w0 + i) % a.stages),
                  ((w0 + i) / a.stages) & 1);
    // the window's valid keys, page after page: key t is row t % ps of
    // page w0 + t / ps
    const int nk = min(kv_len - (p0 + w0) * ps, min(W, npg - w0) * ps);
    // a pass takes KK keys a key group, KK * step keys a block; its trip
    // count is warp-uniform, so the shuffles see every lane of the warp
    for (int t0 = warp * kpw; t0 < nk; t0 += KK * step) {
      const T* row[KK];
      bool live[KK];
      float sc[KK][ROWS];
#pragma unroll
      for (int k = 0; k < KK; ++k) {
        const int t = t0 + lane / L + k * step;
        live[k] = t < nk;
        const int pg = live[k] ? t / ps : 0;
        row[k] = ring + (size_t)(2 * ((w0 + pg) % a.stages)) * page_elems +
                 (size_t)(t - pg * ps) * D;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) sc[k][r] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < KK; ++k)
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int v = li + i * L;
          if (live[k] && v < nvec) {
            float kf[VEC];
            load16(row[k] + v * VEC, kf);
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                sc[k][r] = fmaf(qv[r][i][e], kf[e], sc[k][r]);
          }
        }
      for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
        for (int k = 0; k < KK; ++k)
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            sc[k][r] += __shfl_xor_sync(kFull, sc[k][r], o);
      float vf[KK][NV][VEC];
#pragma unroll
      for (int k = 0; k < KK; ++k)
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int v = li + i * L;
          if (live[k] && v < nvec) {
            load16(row[k] + page_elems + v * VEC, vf[k][i]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) vf[k][i][e] = 0.f;
          }
        }
      // online softmax over the pass's live keys: one rescale a pass
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float mn = m[r];
#pragma unroll
        for (int k = 0; k < KK; ++k)
          if (live[k]) mn = fmaxf(mn, sc[k][r] * a.scale);
        const float alpha = expf(m[r] - mn);
        float p[KK], sum = 0.f;
#pragma unroll
        for (int k = 0; k < KK; ++k) {
          p[k] = live[k] ? expf(sc[k][r] * a.scale - mn) : 0.f;
          sum += p[k];
          p[k] = round_to<T>(p[k]);
        }
        l[r] = fmaf(l[r], alpha, sum);
        m[r] = mn;
#pragma unroll
        for (int i = 0; i < NV; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            float x = acc[r][i][e] * alpha;
#pragma unroll
            for (int k = 0; k < KK; ++k) x = fmaf(p[k], vf[k][i][e], x);
            acc[r][i][e] = x;
          }
      }
    }
  }

  // merge the key groups of each warp (lanes L, 2L, ... apart); a group
  // that saw no key (l == 0) weighs 0
  for (int o = L; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float mo = __shfl_xor_sync(kFull, m[r], o);
      const float lo = __shfl_xor_sync(kFull, l[r], o);
      const float mn = fmaxf(m[r], mo);
      const float wa = l[r] > 0.f ? expf(m[r] - mn) : 0.f;
      const float wb = lo > 0.f ? expf(mo - mn) : 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float other = __shfl_xor_sync(kFull, acc[r][i][e], o);
          acc[r][i][e] = fmaf(other, wb, acc[r][i][e] * wa);
        }
      l[r] = fmaf(lo, wb, l[r] * wa);
      m[r] = mn;
    }
  }

  // merge the warps through shared memory, over the ring
  __syncthreads();  // every warp is done reading the ring
  float* macc = reinterpret_cast<float*>(smem);  // (kWarps, ROWS, D)
  float* mml = macc + (size_t)kWarps * ROWS * D;  // (kWarps, ROWS, 2)
  if (lane < L) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int v = li + i * L;
        if (v < nvec)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            macc[(size_t)(warp * ROWS + r) * D + v * VEC + e] = acc[r][i][e];
      }
      if (lane == 0) {
        mml[(warp * ROWS + r) * 2] = m[r];
        mml[(warp * ROWS + r) * 2 + 1] = l[r];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nrows * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    float mx = kNegInf, lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      merge_part(mml[(w * ROWS + r) * 2], mml[(w * ROWS + r) * 2 + 1],
                 macc[(size_t)(w * ROWS + r) * D + d], mx, lt, at);
    if (a.splits == 1) {
      static_cast<T*>(a.o)[(qrow0 + r) * D + d] =
          from_f<T>(lt == 0.f ? 0.f : at / lt);
    } else {
      const size_t row = ((size_t)g * a.splits + split) * a.rep + r0 + r;
      a.ws_acc[row * D + d] = at;
      if (d == 0) {
        a.ws_ml[row * 2] = mx;
        a.ws_ml[row * 2 + 1] = lt;
      }
    }
  }
}

// o row (g, r) = sum_s acc_s exp(m_s - m) / sum_s l_s exp(m_s - m) over
// the splits with l_s > 0, folded in split order; exact zeros when none
// has.
// Launched as a programmatic dependent of the split kernel: it may start
// before that grid ends, and waits for its results first.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_combine_kernel(const float* __restrict__ ws_acc,
                         const float* __restrict__ ws_ml, T* __restrict__ o,
                         int splits, int rep, int D) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t g = blockIdx.x;
  for (int idx = threadIdx.x; idx < rep * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    const size_t row0 = g * splits * rep + r;  // split s: row0 + s * rep
    float mx = kNegInf, lt = 0.f, at = 0.f;
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      const size_t row = row0 + (size_t)s * rep;
      merge_part(ws_ml[row * 2], ws_ml[row * 2 + 1], ws_acc[row * D + d], mx,
                 lt, at);
    }
    o[(g * rep + r) * D + d] = from_f<T>(lt == 0.f ? 0.f : at / lt);
  }
}

template <typename T, int ROWS, int NV>
int launch_split(const Args& a, int grid_x, size_t smem, cudaStream_t s) {
  if constexpr (ROWS * NV * (16 / sizeof(T)) > kMaxLaneFloats) {
    return (int)cudaErrorInvalidValue;  // would spill: the wrapper's
                                        // paged_rows never asks for it
  } else {
    auto kern = paged_split_kernel<T, ROWS, NV>;
    static int configured = 48 * 1024;
    if ((int)smem > configured) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      configured = (int)smem;
    }
    kern<<<dim3(grid_x, a.splits), kThreads, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
}

template <typename T, int ROWS>
int dispatch_nv(const Args& a, int nv, int grid_x, size_t smem,
                cudaStream_t s) {
  return nv == 1 ? launch_split<T, ROWS, 1>(a, grid_x, smem, s)
                 : launch_split<T, ROWS, 2>(a, grid_x, smem, s);
}

template <typename T>
int launch(Args a, int B, int rows, cudaStream_t s) {
  const int nvec = a.D * (int)sizeof(T) / 16;
  const int nv = (nvec + 31) / 32;
  if ((a.D * (int)sizeof(T)) % 16 != 0 || nvec < 1 || nv > 2 ||
      a.splits < 1 || a.splits > 65535 || a.per < 1 ||
      (a.stages != 2 && a.stages != 4) ||
      (a.splits > 1 && a.ws_acc == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.D, a.ps, rows, (int)sizeof(T), a.stages);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  a.row_chunks = (a.rep + rows - 1) / rows;
  const long long grid_x = (long long)B * a.KV * a.row_chunks;
  if (grid_x >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  int e;
  switch (rows) {
    case 1: e = dispatch_nv<T, 1>(a, nv, (int)grid_x, smem, s); break;
    case 2: e = dispatch_nv<T, 2>(a, nv, (int)grid_x, smem, s); break;
    case 4: e = dispatch_nv<T, 4>(a, nv, (int)grid_x, smem, s); break;
    case 8: e = dispatch_nv<T, 8>(a, nv, (int)grid_x, smem, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != 0 || a.splits == 1) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.KV);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, paged_combine_kernel<T>, (const float*)a.ws_acc,
      (const float*)a.ws_ml, static_cast<T*>(a.o), a.splits, a.rep, a.D);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// o (B, KV*rep, D) = softmax over the valid columns of q k^T * scale,
// times v, with k and v gathered from the (P, ps, KV, D) pools through
// the int32 (B, T) page table; kv_lens is an int32 (B,) device array.
// `rows` (1, 2, 4 or 8) query rows a block, `splits` ranges of `per`
// pages, a ring of `stages` (2 or 4: two windows of 1 or 2) pages; with
// splits > 1, ws holds B * KV * splits * rep * (D + 2) floats.
int paged_attention(const void* q, const void* k_pool, const void* v_pool,
                    void* o, const void* page_table, const void* kv_lens,
                    void* ws, int B, int KV, int T_len, int ps, int D,
                    int rep, int rows, int splits, int per, int stages,
                    float scale, int dtype_bf16, void* stream) {
  Args a{q, k_pool, v_pool, o, static_cast<const int*>(page_table),
         static_cast<const int*>(kv_lens), static_cast<float*>(ws),
         ws == nullptr ? nullptr
                       : static_cast<float*>(ws) +
                             (size_t)B * KV * splits * rep * D,
         KV, T_len, ps, D, rep, splits, per, stages, 1, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype_bf16 ? launch<__nv_bfloat16>(a, B, rows, s)
                    : launch<float>(a, B, rows, s);
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
