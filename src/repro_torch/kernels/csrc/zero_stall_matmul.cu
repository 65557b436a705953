// Zero-stall matmuls for Hopper (sm_90a), plain and grouped: C = A @ B,
// or C_g = A_g @ B_g for every group g (the MoE expert FFNs), through an
// N-slot shared-memory revolving buffer.
//
// Replaces:
//   src/repro/kernels/zero_stall_matmul.py::zero_stall_matmul
//     (Pallas TPU kernel, body `_kernel`, `pl.pallas_call` at line 200), and
//   src/repro/kernels/grouped_matmul.py::grouped_zero_stall_matmul
//     (Pallas TPU kernel, body `_kernel`, `pl.pallas_call` at line 137).
//
// The ring, the loaders, the masking and the inner products live in
// zero_stall_ring.cuh (shared with the int8 kernels); this file launches
// them over G groups, G = 1 for the plain product.  blockIdx.y runs over
// the groups and blockIdx.x over a group's output tiles.  The Pallas
// grouped kernel streams one ring across expert boundaries because the
// TPU grid runs in order on one core; Hopper runs blocks in parallel on
// 132 SMs, so each block runs its own ring over its k steps and the
// experts are independent blocks.  Ragged M (at decode an expert buffer
// has C = 1 row) is masked in the kernel, so nothing is padded.  TRANS_B
// reads B given as (N, K) row-major: the tied LM head multiplies by the
// embedding table without a transposed copy.
//
// Bound on the H100: at decode (M = a few slots, or C = 1 row an expert)
// the kernel reads every weight once and does 2*M FLOP per weight
// element, far below the 295 FLOP/byte ridge: it is bound by bytes
// (3.35 TB/s).  At a prefill bucket of M = 128 it is still below the
// ridge; only large M is bound by the 989 TFLOP/s of the tensor cores.
// What the design does about it: the ring keeps slots-1 tile copies in
// flight per block while the tensor cores work on the oldest slot, and an
// olmoe expert bank gives G x (N / bn) = 512 blocks to fill the SMs.  It
// does not yet use TMA, wgmma, split-k or persistent blocks, so a small-M
// product over few output tiles leaves SMs idle, and a grouped block reads
// a full bm-row A tile of which one row is real at decode (see PERF.md for
// the measured times).

#include "zero_stall_ring.cuh"

extern "C" {

// C (G, M, N) = A (G, M, K) @ B, B given as (G, K, N) row-major or, with
// trans_b, as (G, N, K) row-major; all three contiguous.  G = 1 is the
// plain product.  jik picks the rasterisation of a group's output tiles;
// dtype_bf16 selects bf16 inputs (else fp32); out_f32 selects an fp32
// output (else bf16).  vec selects the 16-byte cp.async loader (the
// caller checks that shapes and pointers allow it).
int zero_stall_matmul(const void* a, const void* b, void* c, int G, int M,
                      int N, int K, int bm, int bn, int bk, int slots,
                      int jik, int dtype_bf16, int out_f32, int trans_b,
                      int vec, void* stream) {
  const zs::Problem p{a, b, c, nullptr, nullptr,
                      (long long)M * K, (long long)K * N, (long long)M * N,
                      M, N, K, bm, bn, bk, slots, jik, out_f32};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_bf16) return zs::dispatch<__nv_bfloat16>(p, G, trans_b, vec, s);
  return zs::dispatch<float>(p, G, trans_b, vec, s);
}

}  // extern "C"
