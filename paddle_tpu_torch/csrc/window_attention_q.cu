// Window attention over a dense int8 KV cache (int8 codes, one f32 scale
// per position and kv head) for Hopper (sm_90a); q and o bf16 or fp16.
//
// Replaces: paddle_tpu/ops/decode_attention.py:_window_kernel_q (launched
// by _window_gqa).  Same contract as window_attention.cu, with caches
// [B, S, Hkv, D] of int8 codes and scales [B, S, Hkv] f32.  As the TPU
// kernel does, each K/V tile is dequantized to q's dtype (code x scale in
// f32, rounded) before both products; the decode kernels over int8 caches
// instead apply the scale to the f32 dot product.  The scales are read in
// place (the TPU wrapper transposes them to [B * Hkv, 1, S] first).
//
// What bounds it: as window_attention.cu, on half the K/V bytes plus four
// scale bytes per position and kv head.  The codes are loaded to
// registers, converted and staged in shared memory as 16-bit values, so
// both products still run on the tensor cores (window_attention.cuh).
#include "window_attention.cuh"

// q [B, W, H, D]; k/v [B, S, Hkv, D] int8; k_scale/v_scale [B, S, Hkv]
// f32; lengths [B] int32; all contiguous; o [B, W, H, D].  H % Hkv == 0,
// D in {64, 128}.  dtype (of q and o): 0 = bf16, 1 = fp16.  Returns a
// cudaError_t: 0 when the launch was accepted.
extern "C" int window_attention_q(const void* q, const void* k, const void* v,
                                  const void* k_scale, const void* v_scale,
                                  const void* lengths, void* o, int B, int W,
                                  int S, int H, int Hkv, int D, int dtype,
                                  void* stream) {
  window_attn::Args a{q, k, v, k_scale, v_scale, nullptr, lengths, o,
                      B, W, S, H, Hkv, D, 0, 0, dtype, stream};
  return window_attn::run<true, false>(a);
}
