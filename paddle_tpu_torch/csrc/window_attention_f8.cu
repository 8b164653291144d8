// Window attention over a dense fp8 (e4m3) KV cache (e4m3 codes, one f32
// scale per position and kv head) for Hopper (sm_90a); q and o bf16 or
// fp16.
//
// Replaces: paddle_tpu/ops/decode_attention.py:_window_composite, the
// composite the JAX package's fp8 caches ride (behind the int8 gate of
// decode_attention_window); there is no TPU kernel for them.
// Same contract as window_attention_q.cu, with caches [B, S, Hkv, D] of
// e4m3 codes and scales [B, S, Hkv] f32.  Each K/V tile is dequantized to
// q's dtype (code x scale in f32, rounded) before both products, as the
// composite does.
//
// What bounds it: as the int8 window kernel, the code and scale bytes for
// a verify window (W * G <= 16 rows a kv head), the operations for a
// prefill chunk.  Its design (window_attention.cuh): the verify ring of
// TMA code tiles and cp.async scales with eight mma.sync consumer warps,
// and the chunk regime's dequantizing producer warpgroup before the
// shared wgmma mainloop.  The int8 byte-permute conversion has no e4m3
// counterpart: codes widen by cvt.rn.f16x2.e4m3x2, two a instruction
// (kv_codes.cuh).
#include "window_attention.cuh"

// q [B, W, H, D]; k/v [B, S, Hkv, D] e4m3; k_scale/v_scale [B, S, Hkv]
// f32; lengths [B] int32; all contiguous; o [B, W, H, D].  H % Hkv == 0,
// D in {64, 128}.  dtype (of q and o): 0 = bf16, 1 = fp16.  Returns a
// cudaError_t: 0 when the launch was accepted.
extern "C" int window_attention_f8(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* lengths, void* o, int B, int W,
                                   int S, int H, int Hkv, int D, int dtype,
                                   void* stream) {
  window_attn::Args a{q, k, v, k_scale, v_scale, nullptr, lengths, o,
                      B, W, S, H, Hkv, D, 0, 0, dtype, stream};
  return window_attn::run<__nv_fp8_e4m3, false>(a);
}
