// fp8 (e4m3) quantized matmul for Hopper (sm_90a): y = (qx . qw summed in
// f32) * sx * sw, written as bf16, fp16 or f32.
//
// Replaces: paddle_tpu/ops/quantized_matmul.py:_qmm_composite (its fp8
// branch: one dot_general with f32 accumulation, then (acc * sx) * sw),
// which the JAX package's fp8 compute rides; there is no TPU kernel for
// it.  Contract as quantized_matmul.cu's with e4m3
// codes (torch.float8_e4m3fn): qx [M, K] with one f32 scale per row (sx
// [M, 1]), the weight codes transposed, qw_t [N, K], one f32 scale per
// output column (sw [1, N]).  Every product of two e4m3 values is exact in
// f32; the sums are not, and their order differs from the plain
// version's, so the kernel agrees with it to f32 rounding of the sums,
// not bit for bit.
//
// What bounds it, and the design: the int8 kernel's two regimes
// (quantized_matmul.cuh), which move the same bytes.  Decode (M <= 16) is
// bound by the bytes of the weight codes: every SM streams a share of the
// 64-column x 128-byte units through an 8-deep TMA ring into four
// mma.sync m16n8k32 .f32.e4m3.e4m3 warps.  Prefill (M > 16) is bound by
// the operations, 2 M N K at the e4m3 rate of 1979 TFLOP/s: wgmma
// m64n128k32 .f32.e4m3.e4m3 on a TMA ring.  Two differences from int8:
// - The tensor cores' f32 accumulation of e4m3 products keeps fewer
//   mantissa bits than an f32 register (about 14 on Hopper: the
//   DeepSeek-V3 report, section 3.3.2), so each 128-deep k-tile's products
//   are summed from 0 and the result is added into f32 registers.  That
//   second accumulator takes the registers of a 256-column tile, so the
//   prefill tiles are 128 columns wide (the wrapper plans bn = 128) and
//   each stage is released once its products are read.
// - f32 sums are not associative, so a split sum (split-K, or a decode
//   strip held by several blocks) is added by the last piece to arrive in
//   piece order 0 .. n - 1 from the workspace, its own included: two
//   calls, and a CUDA-graph replay and an eager call, give equal bits.
#include "quantized_matmul.cuh"

// qx [M, K] e4m3, qw_t [N, K] e4m3, sx [M] f32, sw [N] f32, y [M, N]; all
// contiguous and 16-byte aligned.  M >= 1, N and K multiples of 128.
// dtype of y: 0 = bf16, 1 = fp16, 2 = f32.  The plan as for
// quantized_matmul (ops/quantized_matmul.py:_qmm_plan) with bn = 128
// above M = 16.  Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int quantized_matmul_f8(const void* qx, const void* qw_t, const void* sx,
                                   const void* sw, void* y, void* work, void* counters, int M,
                                   int N, int K, int dtype, int blocks, int bn, int splits,
                                   int work_ints, int n_counters, void* stream) {
  return qmm::run<qmm::E4M3>(qx, qw_t, sx, sw, y, work, counters, M, N, K, dtype, blocks, bn,
                             splits, work_ints, n_counters, stream);
}
