// One GPT layer's whole decode step in one launch (the decode megakernel)
// over a dense int8 KV cache, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/decode_megakernel.py:_mega_kernel (launched by
// _run_mega from decode_layer_step over a dense int8 cache).  Same contract: LN1, the qkv product, attention
// over int8 codes [B, cap, Hkv, D] with f32 scales [B, cap, Hkv], dequantized in registers,
// plus the new token folded from the qkv product, the out product, bias
// and residual, LN2, up, GELU, down, bias and residual; x_out and the new
// token's raw k/v are written, the cache is only read.
//
// What bounds it: device memory bandwidth: the layer's weights (100.7 MB of
// bf16 at gpt3-1.3b) read once per step for every slot together, plus each
// slot's cached k/v once.  The TPU kernel's sequential grid of (phase,
// slot) steps becomes a persistent cooperative grid of one block per SM
// whose five phases are separated by grid-wide barriers: a producer warp
// keeps a TMA ring of weight tiles and k/v rows full across the barriers
// while eight mma.sync consumer warps work through tiles balanced over
// every SM (decode_megakernel.cuh has the design).
#include "decode_megakernel.cuh"

// ptrs: x, the 12 layer arrays (LAYER_WEIGHTS order), k, v, k_scale,
// v_scale, tables (null when dense), lengths, x_out, k_new, v_new, scratch,
// workspace (zeroed once: a grid-barrier word and strip counters);
// k/v [B, cap, Hkv, D] int8, k_scale/v_scale [B, cap, Hkv] f32.
// dims: B, H, Hkv, D, F, cap, bs, MB, grid (one block per SM), position
// parts of an attention pair, partials a chunk of the qkv, out, up and
// down products, the scratch floats (low 31 bits, the rest), dtype (0 = bf16,
// 1 = fp16); ops/decode_megakernel.py:_launch_args makes them.  Returns a
// cudaError_t: 0 when the launch was accepted.
extern "C" int decode_megakernel_q(const void* const* ptrs, const int* dims, float eps, void* stream) {
  return mega::entry<true, false>(ptrs, dims, eps, stream);
}
