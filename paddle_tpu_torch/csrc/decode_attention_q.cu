// Single-token decode attention over a dense int8 KV cache with one f32
// scale per (position, kv head), for Hopper (sm_90a); q and o bf16 or
// fp16, f32 online softmax.
//
// Replaces: paddle_tpu/ops/decode_attention.py:_decode_kernel_q
// (launched by _decode_gqa_q).  Same contract as the dense kernel, with
// caches [B, S, Hkv, D] of int8 codes and scales [B, S, Hkv] f32: value
// = code * scale (ops/quantized_matmul.quantize_kv).  The TPU kernel
// rounds the dequantized K/V to q's dtype before its dots; this one keeps
// them in f32 (applying each scale once to the dot product and to p).
//
// What bounds it: device memory bandwidth, as the dense kernel, on half
// the bytes: D int8 codes plus one f32 scale per position and kv head
// for each of K and V.  Each lane loads 16 codes in one 16-byte vector
// and converts them in registers; the scale is one broadcast load per
// position (decode_attention.cuh).
#include "decode_attention.cuh"

// q [B, H, D]; k/v [B, S, Hkv, D] int8; k_scale/v_scale [B, S, Hkv] f32;
// lengths [B] int32; all contiguous; o [B, H, D].  H % Hkv == 0, D in
// {64, 128}.  dtype (of q and o): 0 = bf16, 1 = fp16.  Returns a
// cudaError_t: 0 when the launch was accepted.
extern "C" int decode_attention_q(const void* q, const void* k, const void* v,
                                  const void* k_scale, const void* v_scale,
                                  const void* lengths, void* o, int B, int S,
                                  int H, int Hkv, int D, int dtype, void* stream) {
  decode_attn::Args a{q, k, v, k_scale, v_scale, nullptr, lengths, o,
                      B, S, H, Hkv, D, 0, 0, dtype, stream};
  return decode_attn::run<int8_t, false>(a);
}
