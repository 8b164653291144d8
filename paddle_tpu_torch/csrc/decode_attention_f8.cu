// Single-token decode attention over a dense fp8 (e4m3) KV cache with one
// f32 scale per (position, kv head), for Hopper (sm_90a); q and o bf16 or
// fp16, f32 online softmax.
//
// Replaces: paddle_tpu/ops/decode_attention.py:_decode_composite, the
// composite the JAX package's fp8 caches ride (behind the int8 gate of
// decode_attention); there is no TPU kernel for them.  Same contract
// as decode_attention_q.cu, with caches [B, S, Hkv, D] of e4m3 codes
// (torch.float8_e4m3fn) and scales [B, S, Hkv] f32: value = code * scale
// (ops/quantized_matmul.quantize_kv(..., 'fp8')).  The composite rounds
// the dequantized K/V to q's dtype before its dots; this kernel keeps
// them in f32 (each scale applied once to the dot product and to p), as
// the int8 kernel does.
//
// What bounds it: device memory bandwidth, on the same bytes as the int8
// kernel: D codes plus one f32 scale per position and kv head for each
// of K and V.  The int8 kernel's design (decode_attention.cuh); each lane
// widens its 16 codes with eight cvt.rn.f16x2.e4m3x2 (kv_codes.cuh).
#include "decode_attention.cuh"

// q [B, H, D]; k/v [B, S, Hkv, D] e4m3; k_scale/v_scale [B, S, Hkv] f32;
// lengths [B] int32; all contiguous; o [B, H, D].  H % Hkv == 0, D in
// {64, 128}.  dtype (of q and o): 0 = bf16, 1 = fp16.  Returns a
// cudaError_t: 0 when the launch was accepted.
extern "C" int decode_attention_f8(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* lengths, void* o, int B, int S,
                                   int H, int Hkv, int D, int dtype, void* stream) {
  decode_attn::Args a{q, k, v, k_scale, v_scale, nullptr, lengths, o,
                      B, S, H, Hkv, D, 0, 0, dtype, stream};
  return decode_attn::run<__nv_fp8_e4m3, false>(a);
}
