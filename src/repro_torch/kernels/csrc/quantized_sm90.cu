// Int8 zero-stall matmuls for Hopper (sm_90a) on the TMA + mbarrier +
// wgmma ring of zero_stall_sm90.cuh: exact int32 products of int8 codes
// with the dequantising epilogue,
//   C = (float(A_q @ B_q) * a_scale[row]) * b_scale[col], cast once,
// for one product and for the grouped product of the W8A8 expert banks.
//
// Replaces, for codes whose rows TMA can address (K % 16 == 0, 16-byte
// aligned bases, B K-major as the port's QTensor stores it):
//   src/repro/kernels/quantized_matmul.py::quantized_zero_stall_matmul
//     (body `_kernel` at line 51, `pl.pallas_call` at line 187), and
//   src/repro/kernels/quantized_matmul.py::quantized_grouped_zero_stall_matmul
//     (body `_grouped_kernel` at line 213, `pl.pallas_call` at line 317).
// Other shapes keep the cp.async ring of quantized_matmul.cu.
//
// The ring, the swap-AB mapping and split-k are those of the bf16
// product in zero_stall_sm90.cu (see the header).  What int8 changes:
// wgmma m64nNk32.s32.s8.s8 with both operands K-major (the weight's
// (N, K) codes are the A operand, the activation codes the B operand),
// UINT8 tensor maps whose 128-byte boxes hold 128 codes of k, a 32-byte k
// step of 32 codes, int32 accumulators and int32 split-k partials that
// the reduction adds exactly before it applies the scales, so every split
// count gives the bits of the plain version.  int8 products are at most
// 127^2, so the int32 sum is exact for K < 133,000 (gemma-7b's largest K
// is 24576).  The grouped product runs the persistent walk of the bf16
// grouped product (about one block per SM over the G x row x column
// tiles, one ring across tiles and experts, rank-3 maps so a box at a
// ragged edge zero-fills inside its expert) with the epilogue's scales
// indexed per group; it takes no split-k.
//
// Bound on the H100: at decode (M = 4, or C = 1 row an expert) every
// weight byte is read once for a few rows, far below the ~591 int8
// operations a byte the tensor cores need: bytes at 3.35 TB/s (one
// gemma-7b W8A8 decode step's 196 projections: 7.8 GB, 2.32 ms; one
// olmoe-1b-7b W8A8 step's 48 expert banks: 6.47 GB, 1.93 ms).  What the
// design does about it: the path's tile (KernelConfig's int8 default: bn
// 128, bk 256 codes) is a 32 KB weight box set and a small activation box
// a stage, the bytes of a stage of the bf16 product.  At decode the
// consumer holds a stage only for a few wgmmas, so at slots = 2 about two
// stages (about 68 KB) are in flight on each busy SM.  Keeping 3.35 TB/s
// busy at about 1 us of latency takes about 25 KB in flight on each of
// 132 SMs; on the card a stage of 128 codes at slots 2 (about two 17 KB
// stages in flight) is measurably slower than 256 codes at slots 2 or 128
// codes at slots 4 (PERF.md, phase 6 of chip_smoke.py), so the estimate
// is a floor.  Split-k brings the plain projections with fewer tiles than
// SMs to 96-128 blocks; the grouped banks have 512-1024 tiles for 132
// blocks.  The activation codes and row scales come from quantize_rows,
// plain PyTorch outside the kernel, as in the JAX package.

#include "zero_stall_sm90.cuh"

extern "C" {

// C (M, N) = dequant(A (M, K) int8 @ B), B given as (N, K) int8 rows;
// a_scale (M,) and b_scale (N,) fp32; contiguous, 16-byte aligned,
// K % 16 == 0.  ni in {8, ..., 128} activation rows and bn in {64, 128}
// weight rows a block, bk a multiple of 128 codes (<= 512) a stage,
// `slots` stages.  The k stages split into `splits` ranges of
// steps_per_split; with splits > 1, ws holds splits * M * N int32.
int quantized_zero_stall_matmul_sm90(const void* a, const void* b,
                                     const void* a_scale, const void* b_scale,
                                     void* c, void* ws, int M, int N, int K,
                                     int ni, int bn, int bk, int slots,
                                     int jik, int out_f32, int splits,
                                     int steps_per_split, void* stream) {
  Params p{c, ws, static_cast<const float*>(a_scale),
           static_cast<const float*>(b_scale), M, N, bk, slots, jik, out_f32,
           0, steps_per_split, splits, 0, 0, 0};
  return run<int8_t>(a, b, p, 1, K, ni, bn, 1, 0,
                     static_cast<cudaStream_t>(stream));
}

// C (G, M, N) = dequant(A (G, M, K) int8 @ B_g) per group, B given as
// (G, N, K) int8 rows; a_scale (G, M) and b_scale (G, N) fp32; with the
// alignment of the plain entry.  `blocks` persistent blocks walk the
// output tiles; one split of every k stage.
int quantized_grouped_zero_stall_matmul_sm90(const void* a, const void* b,
                                             const void* a_scale,
                                             const void* b_scale, void* c,
                                             int G, int M, int N, int K,
                                             int ni, int bn, int bk,
                                             int slots, int out_f32,
                                             int blocks, void* stream) {
  Params p{c, nullptr, static_cast<const float*>(a_scale),
           static_cast<const float*>(b_scale), M, N, bk, slots, 0, out_f32,
           0, 0, 1, 0, 0, 0};
  return run<int8_t>(a, b, p, G, K, ni, bn, 1, blocks < 1 ? 1 : blocks,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
