// Int8 zero-stall matmuls for Hopper (sm_90a), plain and grouped: exact
// int32 products of int8 codes with a fused dequantising epilogue,
//   C = (float(A_q @ B_q) * a_scale[row]) * b_scale[col], cast once.
//
// Replaces:
//   src/repro/kernels/quantized_matmul.py::quantized_zero_stall_matmul
//     (body `_kernel`, `pl.pallas_call` at line 187), and
//   src/repro/kernels/quantized_matmul.py::quantized_grouped_zero_stall_matmul
//     (body `_grouped_kernel`, `pl.pallas_call` at line 317).
//
// Both run the ring of zero_stall_ring.cuh with int8 tiles and
// mma.sync m16n8k32 s8 x s8 -> s32.  B is K-major, (N, K) row-major for
// each group (the port's QTensor stores its codes so), because ldmatrix
// .trans moves 16-bit elements only.  int8 products are at most 127^2,
// so the int32 sum is exact for K < 133,000 (gemma-7b's largest K is
// 24576: |acc| < 4e8).  The epilogue rounds after each fp32 multiply in
// the order of the plain version, so kernel and plain version agree bit
// for bit.
//
// The wrappers send here only what the TMA design of quantized_sm90.cu
// cannot take: K % 16 != 0 or a base that is not 16-byte aligned.
//
// Bound on the H100: at decode every weight byte is read once for a few
// rows, far below the 591 int8 operations a byte the tensor cores need:
// bytes at 3.35 TB/s, half the bytes of bf16.  What the design does about
// it: 1-byte tiles halve the shared memory of a slot (128 x 128 x 128 at
// 2 slots is 74 KB), the ring keeps slots-1 copies in flight per block.
// The activation codes and row scales come from quantize_rows, plain
// PyTorch outside the kernel, as in the JAX package.

#include "zero_stall_ring.cuh"

extern "C" {

// C (M, N) = dequant(A (M, K) int8 @ B), B given as (N, K) int8 row-major;
// a_scale (M,) and b_scale (N,) fp32.  out_f32 selects an fp32 output
// (else bf16); vec the 16-byte cp.async loader.
int quantized_zero_stall_matmul(const void* a, const void* b,
                                const void* a_scale, const void* b_scale,
                                void* c, int M, int N, int K, int bm, int bn,
                                int bk, int slots, int jik, int out_f32,
                                int vec, void* stream) {
  const zs::Problem p{a, b, c, static_cast<const float*>(a_scale),
                      static_cast<const float*>(b_scale), 0, 0, 0,
                      M, N, K, bm, bn, bk, slots, jik, out_f32};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? zs::launch<int8_t, true, true>(p, 1, s)
             : zs::launch<int8_t, true, false>(p, 1, s);
}

// The same over G groups: A (G, M, K), B (G, N, K), a_scale (G, M),
// b_scale (G, N), C (G, M, N), all contiguous.
int quantized_grouped_zero_stall_matmul(const void* a, const void* b,
                                        const void* a_scale,
                                        const void* b_scale, void* c, int G,
                                        int M, int N, int K, int bm, int bn,
                                        int bk, int slots, int out_f32,
                                        int vec, void* stream) {
  const zs::Problem p{a, b, c, static_cast<const float*>(a_scale),
                      static_cast<const float*>(b_scale),
                      (long long)M * K, (long long)N * K, (long long)M * N,
                      M, N, K, bm, bn, bk, slots, 0, out_f32};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? zs::launch<int8_t, true, true>(p, G, s)
             : zs::launch<int8_t, true, false>(p, G, s);
}

}  // extern "C"
