// One GPT layer's whole decode step in one launch (the decode megakernel)
// over a dense full-precision KV cache, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/decode_megakernel.py:_mega_kernel (launched by
// _run_mega from decode_layer_step over a dense cache).  Same contract: LN1, the qkv product, attention
// over the cache [B, cap, Hkv, D] in the weights' type
// plus the new token folded from the qkv product, the out product, bias
// and residual, LN2, up, GELU, down, bias and residual; x_out and the new
// token's raw k/v are written, the cache is only read.
//
// What bounds it: device memory bandwidth: the layer's weights (100.7 MB of
// bf16 at gpt3-1.3b) read once per step for every slot together, plus each
// slot's cached k/v once per query head of its group.  The TPU kernel's
// sequential grid of (phase, slot) steps becomes a persistent cooperative
// grid whose phases are separated by grid-wide barriers, so one launch
// replaces the composed step's launches per layer (decode_megakernel.cuh
// has the design).
#include "decode_megakernel.cuh"

// ptrs: x, the 12 layer arrays (LAYER_WEIGHTS order), k, v, k_scale,
// v_scale, tables (null when dense), lengths, x_out, k_new, v_new, scratch;
// k/v [B, cap, Hkv, D] in x's type; k_scale/v_scale unused (null).
// dims: B, H, Hkv, D, F, cap, bs, MB, ks_qkv, ks_out, ks_up, ks_down, dtype
// (0 = bf16, 1 = fp16).  Returns a cudaError_t: 0 when the launch was
// accepted.
extern "C" int decode_megakernel(const void* const* ptrs, const int* dims, float eps, void* stream) {
  mega::Args a;
  for (int i = 0; i < 23; ++i) a.ptr[i] = ptrs[i];
  a.B = dims[0];
  a.H = dims[1];
  a.Hkv = dims[2];
  a.D = dims[3];
  a.F = dims[4];
  a.cap = dims[5];
  a.bs = dims[6];
  a.MB = dims[7];
  a.ks_qkv = dims[8];
  a.ks_out = dims[9];
  a.ks_up = dims[10];
  a.ks_down = dims[11];
  a.dtype = dims[12];
  a.eps = eps;
  a.stream = stream;
  return mega::run<false, false>(a);
}
