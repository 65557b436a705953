// Zero-stall matmuls for Hopper (sm_90a) in bf16 on the TMA + mbarrier +
// wgmma ring of zero_stall_sm90.cuh: one product C = A @ B, and the
// grouped product C_g = A_g @ B_g of the MoE expert banks.
//
// Replaces:
//   src/repro/kernels/zero_stall_matmul.py::zero_stall_matmul
//     (Pallas TPU kernel, body `_kernel` at line 71, `pl.pallas_call` at
//     line 200), and
//   src/repro/kernels/grouped_matmul.py::grouped_zero_stall_matmul
//     (body `_kernel` at line 39, `pl.pallas_call` at line 137),
// for bf16 operands whose rows TMA can address (K % 8 == 0, N % 8 == 0
// for a row-major B, 16-byte aligned bases).  fp32 and ragged bf16 keep
// the cp.async ring of zero_stall_ring.cuh (zero_stall_matmul.cu).
//
// One product: one block per NI x bn output tile, the k stages split over
// blocks when the tiles are fewer than the SMs (split-k, see the header).
// B is (K, N) row-major or, with trans_b, (N, K) row-major (the tied LM
// head reads the embedding table in place).
//
// Grouped: A (G, M, K) and B (G, K, N) row-major, as the MoE layer passes
// them, each a rank-3 tensor map, so a box at a ragged K or N edge
// zero-fills inside its expert.  About one block per SM (the wrapper's
// `blocks`) walks the G x ceil(M / NI) x ceil(N / bn) tiles g-major, and
// one ring runs across each block's tiles and experts: the port's form of
// the Pallas kernel's step index t over (g, i, j, k), which streams its
// ring across group boundaries.  Every expert's bank is read, as the TPU
// kernel reads it, whether or not a token was routed there.
//
// Bound on the H100: at decode (M = 4 slots, or C = 1 row an expert) and
// at a 128-token prefill the product does at most 2 * M FLOP per weight
// element read, below the ~295 FLOP/byte ridge: it is bound by the bytes
// of B at 3.35 TB/s (an olmoe-1b-7b bank, 64 x 2048 x 1024 bf16, is
// 268 MB: 0.080 ms).  What the design does about it: TMA tiles of 32 KB
// (bn 128 x bk 128) in flight on about every SM, in a ring that never
// drains between tiles, and no tensor-core work spent on padded rows
// (swap AB puts the few rows on wgmma's N side of 8).

#include "zero_stall_sm90.cuh"

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
  Params p{c, ws, nullptr, nullptr, M, N, bk, slots, jik, out_f32,
           0, steps_per_split, splits, 0, 0, 0};
  return run<__nv_bfloat16>(a, b, p, 1, K, ni, bn, trans_b, 0,
                            static_cast<cudaStream_t>(stream));
}

// C (G, M, N) = A (G, M, K) @ B (G, K, N) per group, bf16 in, bf16 or
// fp32 (out_f32) out, contiguous, with the alignment of the plain entry;
// `blocks` persistent blocks walk the output tiles.
int grouped_zero_stall_matmul_sm90(const void* a, const void* b, void* c,
                                   int G, int M, int N, int K, int ni,
                                   int bn, int bk, int slots, int out_f32,
                                   int blocks, void* stream) {
  Params p{c, nullptr, nullptr, nullptr, M, N, bk, slots, 0, out_f32,
           0, 0, 1, 0, 0, 0};
  return run<__nv_bfloat16>(a, b, p, G, K, ni, bn, 0, blocks < 1 ? 1 : blocks,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
