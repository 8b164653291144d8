// int8 quantized matmul for Hopper (sm_90a): y = (qx . qw in exact int32)
// * sx * sw, written as bf16, fp16 or f32.
//
// Replaces: paddle_tpu/ops/quantized_matmul.py:_qmm_kernel (launched by
// _qmm_pallas).  Same contract: qx [M, K] int8 activation codes with one
// f32 scale per row (sx [M, 1]), weight codes with one f32 scale per
// output column (sw [1, N]), int32 accumulation (exact), then the f32
// rescale (acc * sx) * sw in that order and one rounding to the output
// type, so the kernel equals the plain version bit for bit.  The weight
// codes come in transposed, qw_t [N, K]: the 8-bit tensor-core products
// (mma.sync and wgmma alike) take both operands K-contiguous, so the
// wrapper writes the codes that way (its quantizer already reduces over K).
// Integer sums are associative, so a sum split over blocks (split-K) and
// added back in any order is still exact.
//
// What bounds it, and the design, in two regimes chosen by M:
//
// Decode (M <= 16): bound by the bytes of the weight codes (K * N bytes,
// 12.6 MB for the gpt3-1.3b qkv product: 3.8 us at 3.35 TB/s).  Every SM
// streams: the product's units (64-column strip x 128-byte k-tile, 8 KB of
// codes) are split into one contiguous run a block, blocks = min(units,
// SMs) (Part below, mirrored by ops/quantized_matmul.py:_Part).  One
// producer warp keeps a ring of kDecStages TMA stages in flight (a 64 x
// 128-byte weight box and the 8 or 16 activation rows of the same k-tile,
// both 128-byte swizzled; rows past M arrive as zeros); four consumer
// warps run mma.sync m16n8k32 with the WEIGHTS as the A operand (16 output
// columns a warp) and the activation rows as B (n = 8, two n-tiles for
// 9-16 rows), so no fragment carries padding rows; the result is y^T,
// written back transposed.  A run is cut at strip edges; a strip held by
// several blocks is summed through the workspace: each piece writes its
// int32 partial in fragment order, a per-strip arrival counter (one
// acquire-release atomic between two block barriers) names the last
// block to finish the strip, which adds the other pieces' partials
// to its registers, runs the rescale and resets the counter to 0.
//
// Prefill and training (M > 16): bound by the operations (2 M N K at the
// int8 rate of 1979 TOPS) once M is in the hundreds.  wgmma
// m64nBNk32.s32.s8.s8 with both operands from shared memory (8-bit
// wgmma takes both K-major: qx and qw_t already are), fed by a TMA ring
// (one 128-byte swizzle line of k a stage, four k32 steps; as many stages
// as fit beside the output staging) that one producer thread keeps full.
// Tiles BM = 64 (M <= 64,
// one consumer warpgroup) or 128 (two, setmaxnreg 40 / 232) x BN = 128 or
// 256 output columns; s32 accumulators in registers (BN / 2 a thread).
// A persistent grid of min(items, SMs) blocks walks the items (output
// tile x k split), m fastest so that the blocks in flight share weight
// strips in L2; the producer loads the next item's stages while the
// consumers run the epilogue.  The epilogue rescales each warpgroup's 64
// rows into its own 32 KB of shared memory (128-byte swizzled boxes) and
// writes them by TMA store, which runs on while the warpgroup starts the
// next item: written straight from the registers, 4 bytes a thread, the
// stores took a third of the time at M = 4096 on an H100.  Where the tiles fill less than half the
// SMs the K loop splits (splits chosen by the wrapper) with the decode
// regime's exact reduction: partials in fragment order, a per-tile
// counter, the last split adds the others and rescales.  Rows past M
// arrive as zeros from TMA's out-of-bounds fill and are not written; so
// do weight rows past N (a BN = 256 tile over N = 384), whose columns
// are not written either.
//
// The counters: the wrapper keeps one zeroed buffer per (device, stream)
// and every launch leaves it zeroed (the last arrival resets its entry),
// so eager calls and CUDA-graph replays start clean without a memset on
// the call path.  A launch CUDA refuses never runs and touches nothing; a
// launch that faults mid-way is a sticky error that ends the CUDA context,
// and the buffer with it.  Two streams never share a buffer, so calls in
// flight on both cannot mix their arrivals.
#include "quantized_matmul.cuh"

// qx [M, K] int8, qw_t [N, K] int8 (the weight codes transposed), sx [M]
// f32, sw [N] f32, y [M, N]; all contiguous and 16-byte aligned.  M >= 1,
// N and K multiples of 128.  dtype of y: 0 = bf16, 1 = fp16, 2 = f32.
// The plan (ops/quantized_matmul.py:_qmm_plan): `blocks` (at most the
// units at M <= 16, the items above), and above M = 16 the tile width bn
// (128 or 256) and the k splits a tile (1 .. K / 128).  work: work_ints
// int32 of partials, counters: n_counters zeroed int32 (left zeroed); each
// must hold what the plan needs (else nothing runs and the call returns
// cudaErrorInvalidValue).  Returns a cudaError_t: 0 when the launch was
// accepted.
extern "C" int quantized_matmul(const void* qx, const void* qw_t, const void* sx, const void* sw,
                                void* y, void* work, void* counters, int M, int N, int K, int dtype,
                                int blocks, int bn, int splits, int work_ints, int n_counters,
                                void* stream) {
  return qmm::run<qmm::S8>(qx, qw_t, sx, sw, y, work, counters, M, N, K, dtype, blocks, bn, splits,
                           work_ints, n_counters, stream);
}
