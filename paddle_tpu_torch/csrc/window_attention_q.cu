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
// What bounds it: a verify window (W * G <= 16 rows a kv head) reads D
// code bytes and 4 scale bytes per position, K and V, for about 4 * W * G
// * D FLOPs: device memory bandwidth, as the int8 decode kernel.  The
// design against it (window_attention.cuh, vq::verify_q_kernel): the
// codes move by TMA, and their scales by cp.async, into a three-deep ring
// of 128-key tiles that one producer warp keeps full, so up to 99 KB a
// block are in flight and nothing passes through the producer's
// registers; eight consumer
// warps per block dequantize out of shared memory straight into their
// tensor-core fragments (a byte permute and two f32 operations a value,
// not the quarter-rate I2F), and the key tiles of a (slot, kv head)
// split over a cluster of CTAs when B * Hkv would leave SMs idle.  A
// prefill chunk (W * G > 16) runs the shared wgmma mainloop with a
// dequantizing producer warpgroup.
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
  return window_attn::run<int8_t, false>(a);
}
